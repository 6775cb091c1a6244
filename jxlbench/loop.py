"""The traffic generator: one window of calls into the cell's entry, driven
by the traffic file's parameters alone.

- `per_call`: streams a call, the seed's distinct streams in turn;
- `clients` (default 1): callers. Without a rate each is a closed loop:
  its next call starts when its last one ends, until the window closes;
- `rate_per_s` (optional): an open loop. Requests arrive at this mean
  rate until the window closes, and the `clients` callers serve them in
  arrival order. Every seed gets the same exponential gaps, in an order
  drawn from the seed, so the same number of requests. A request's latency
  counts from its arrival; one that no caller has begun `grace_s` (60 s)
  after the close is never served and counts as failed.

Each call is recorded as {"arrival", "start", "end", "streams", "path",
"failed", "raised"}, host perf_counter seconds. The window runs from its
first call's start to the end of its last call.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

GRACE_S = 60.0


def call_streams(traffic: dict, n_streams: int, i: int) -> list:
    """The stream indices of call i: the distinct streams in turn."""
    per = int(traffic["per_call"])
    return [(i * per + j) % n_streams for j in range(per)]


def arrivals(traffic: dict, seed: int, seconds: float) -> list:
    """The open loop's arrival offsets in seconds, within the window."""
    rate = float(traffic["rate_per_s"])
    gaps = np.random.default_rng(11).exponential(
        1.0 / rate, int(rate * seconds * 2) + 16)
    gaps = gaps[np.cumsum(gaps) < seconds]
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 11])
    return [float(x) for x in np.cumsum(rng.permutation(gaps))]


def drive(traffic: dict, one, n_streams: int, first: int, seconds: float,
          seed: int) -> tuple[float, float, list]:
    """Run the window. one(i, idx) makes call i on stream indices idx and
    returns its record's other fields. Returns (t0, t1, calls)."""
    clients = int(traffic.get("clients", 1))
    calls, lock = [], threading.Lock()
    counter = iter(range(first, first + 10 ** 12))

    def serve(arrival):
        with lock:
            i = next(counter)
        idx = call_streams(traffic, n_streams, i)
        ts = time.perf_counter()
        rec = one(i - first, idx)
        rec.update(arrival=ts if arrival is None else arrival, start=ts,
                   end=time.perf_counter(), streams=idx)
        with lock:
            calls.append(rec)
        return rec["end"]

    t0 = time.perf_counter()
    deadline = t0 + seconds
    if "rate_per_s" not in traffic:
        def closed():
            while serve(None) < deadline:
                pass

        if clients == 1:
            closed()
        else:
            run_threads(clients, closed)
    else:
        queue = collections.deque(t0 + a for a in
                                  arrivals(traffic, seed, seconds))
        late = []

        def open_loop():
            while True:
                with lock:
                    if not queue:
                        return
                    arrival = queue.popleft()
                now = time.perf_counter()
                if arrival > now:
                    time.sleep(arrival - now)
                elif now > deadline + GRACE_S:
                    with lock:
                        late.append(arrival)
                    continue
                serve(arrival)

        run_threads(clients, open_loop)
        calls.extend({"arrival": a, "start": None, "end": None,
                      "streams": [], "path": None, "failed": True,
                      "raised": False, "why": "never served"}
                     for a in late)
    ends = [c["end"] for c in calls if c["end"] is not None]
    return t0, max(ends, default=t0), calls


def run_threads(n: int, target) -> None:
    threads = [threading.Thread(target=target, name=f"client{k}")
               for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
