"""One run of one cell: the general runner of every configuration, traffic
mix and per-layer metric that BENCHMARK.json names.

Each is found by its name and adds no code here:

- a configuration is jxlbench/configs/<name>.json (the file the manifest
  gives): its input maker (jxlbench/makers/<maker>.py), image size,
  encoder settings, distinct streams a seed, the comparison's limits;
- a traffic mix is jxlbench/traffic/<name>.json: the port's entry
  (jxlbench/entries/<entry>.py), the loop's parameters (loop.py: streams
  a call, callers, an open loop's rate), the warm-up calls, the entry's
  arguments, what a call must show to count as served, and which outputs
  the comparison keeps;
- a metric, end-to-end or per-layer, is jxlbench/metrics/<name>.py,
  whose read(ctx) returns its number, or None where the run gave it
  nothing to read.

A run: check the cards; make or load the seed's inputs (inputs.py);
set-up, timed as setup_s (import the port, open the entry, warm the
traffic's own calls); the window of calls for `seconds` (loop.py; with
--trace 1 under torch.profiler, with host spans around the port's
layers); then the comparison of the kept outputs with the reference and
the result line.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import pathlib
import sys
import threading
import time
import types

import numpy as np

from . import compare
from .inputs import load_or_make
from .loop import call_streams, drive

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "libjxl_tpu")
WINDOW = "jxlbench.window"


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_manifest(root: pathlib.Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, name: str):
    """The Python file `path` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of the manifest with its configuration, traffic mix,
    entry and end-to-end and per-layer metrics."""

    def __init__(self, root: pathlib.Path, manifest: dict, name: str,
                 bench_dir: pathlib.Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.bench_dir = bench_dir
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        entry = configs[self.workload["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        self.config["name"] = entry["name"]
        self.traffic = json.loads(
            (bench_dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = int(self.workload["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]

    def entry(self):
        e = self.traffic["entry"]
        return load_module(self.bench_dir / "entries" / f"{e}.py",
                           f"jxlbench_entry_{e}")

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"jxlbench_metric_{metric}").read


class Keeper:
    """The outputs that the comparison reads: those of `sampled` calls
    drawn from the seed over the whole window (a reservoir sample) and of
    the `last` calls."""

    def __init__(self, seed: int, sampled: int, last: int):
        self.rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
        self.sampled, self.pool = sampled, []
        self.tail = collections.deque(maxlen=last)
        self.seen = 0

    def offer(self, n: int, idx: list, images) -> None:
        item = (n, idx, images)
        if len(self.pool) < self.sampled:
            self.pool.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.sampled:
                self.pool[j] = item
        self.seen += 1
        if self.tail.maxlen:
            self.tail.append(item)

    def kept(self) -> list:
        out = {n: (idx, images) for n, idx, images in
               [*self.pool, *self.tail]}
        return [out[n] for n in sorted(out)]


def failure(traffic: dict, path, launched: dict) -> str | None:
    """Why a call that returned does not count as served, or None."""
    need = traffic.get("require", {})
    prefix = need.get("path_prefix")
    if prefix is not None and not str(path).startswith(prefix):
        return f"path {path!r}, not {prefix}*"
    for k in need.get("launches", ()):
        if not launched.get(k):
            return f"no {k} launch"
    return None


def devices_of(chips: int, kind: str):
    import torch

    if kind == "cpu":
        return [torch.device("cpu")] * chips
    return [torch.device("cuda", i) for i in range(chips)]


def launch_counts() -> dict:
    from libjxl_tpu_torch.base.device import launch_counts as counts

    return counts()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: pathlib.Path, workload: str, seed: int, seconds: float,
        trace: bool, *, device_kind: str = "cuda", log=print,
        bench_dir: pathlib.Path = HERE) -> dict:
    """One run of `workload`; returns the result line's object. log gets
    the progress lines (standard error). device_kind "cpu" skips the look
    for cards and runs the port on the CPU (the tests' route)."""
    import torch

    cell = Cell(root, load_manifest(root), workload, bench_dir)
    if device_kind == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} cards, the cell "
                          f"asks for {cell.chips}")
    if importlib.util.find_spec("libjxl_tpu_torch") is None:
        raise Refused("the port libjxl_tpu_torch is not in this checkout")
    traffic, config = cell.traffic, cell.config

    t = time.perf_counter()
    inputs, how = load_or_make(root, config, seed, bench_dir=bench_dir)
    log(f"inputs: {len(inputs.streams)} streams of {config['name']} at "
        f"seed {seed} {how} in {time.perf_counter() - t:.3f} s (not set-up)")

    devices = devices_of(cell.chips, device_kind)
    cuda = device_kind == "cuda"
    t_setup = time.perf_counter()
    entry = cell.entry()
    handle = entry.start(devices, traffic)
    call = entry.call
    streams = inputs.streams
    n_streams = len(streams)
    laps = [time.perf_counter() - t_setup]
    for i in range(int(traffic["warmup_calls"])):
        call(handle, [streams[j] for j in call_streams(traffic, n_streams,
                                                       i)])
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)
        laps.append(time.perf_counter() - t_setup)
    setup_s = time.perf_counter() - t_setup
    log(f"setup_s {setup_s:.4f}: entry opened in {laps[0]:.4f} s, then "
        f"{len(laps) - 1} warm-up calls of "
        + " ".join(f"{b - a:.4f}" for a, b in zip(laps, laps[1:])) + " s")

    spans = None
    if trace:
        from .trace import Spans

        spans = Spans()
        spans.install(bench_dir / "spans.json")
    peak_setup = 0
    if cuda:
        for d in devices:
            peak_setup = max(peak_setup, torch.cuda.max_memory_allocated(d))
            torch.cuda.reset_peak_memory_stats(d)
    keep = traffic.get("keep", {})
    keeper = Keeper(seed, int(keep.get("sampled", 2)),
                    int(keep.get("last", 2)))
    reasons, lock = collections.Counter(), threading.Lock()
    n0 = int(traffic["warmup_calls"])

    def one(n, idx):
        before = launch_counts()
        try:
            images, path = call(handle, [streams[j] for j in idx])
            err = None
        except Exception as e:  # a failed call is counted, not fatal
            images, path, err = None, None, f"{type(e).__name__}: {e}"
        after = launch_counts()
        launched = {k: after[k] - before.get(k, 0) for k in after}
        why = err or failure(traffic, path, launched)
        with lock:
            if why:
                reasons[why] += 1
            keeper.offer(n, idx, images)
        return {"path": path, "failed": why is not None,
                "raised": err is not None}

    def window():
        return drive(traffic, one, n_streams, n0, seconds, seed)

    if trace:
        from .trace import profiled

        with profiled() as got:
            with torch.profiler.record_function(WINDOW):
                t0, t1, calls = window()
        spans.uninstall()
    else:
        t0, t1, calls = window()
    window_s = t1 - t0
    peak_window = max((torch.cuda.max_memory_allocated(d) for d in devices),
                      default=0) if cuda else 0
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded in this process: {found}")

    never = sum(c.get("why") == "never served" for c in calls)
    if never:
        reasons["never served"] += never
    for why, k in reasons.items():
        log(f"failed: {k} call(s): {why}")
    n_failed = sum(c["failed"] for c in calls)

    # the window's peak is the run's; the set-up's eager warm-up calls
    # allocate what the window's replays never hold, so it stands apart
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if cuda
              else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(peak_window),
              "memory_peak_setup_bytes": int(peak_setup)}
    result = {"attempted": len(calls), "failed": n_failed}
    ctx = types.SimpleNamespace(
        calls=calls, window_s=window_s, setup_s=setup_s,
        facts=inputs.facts, peak_window_bytes=peak_window, chips=cell.chips,
        batch=int(traffic.get("batch", traffic["per_call"])))
    if trace:
        from .trace import DeviceTrace

        dt = DeviceTrace(got["events"], WINDOW)
        ctx.spans, ctx.modes, ctx.trace = spans.spans, dict(spans.modes), dt
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        device["busy_s"] = dt.busy_s(cell.chips)
        device["window_s"] = dt.window_s
        result["breakdown"] = {"device_ops": dt.top_ops(),
                               "idle_gaps": dt.idle_gaps()}
        del got

    # the comparison, once the window has closed and the peak is read
    tally = compare.Tally()
    for idx, images in keeper.kept():
        for k, j in enumerate(idx):
            got_img = images[k] if images is not None \
                and k < len(images) else None
            tally.add(got_img, inputs.reference(j))
    correct, numbers = tally.verdict(config["limits"])
    correct = correct and not never \
        and not any(c["raised"] for c in calls)
    log(f"compared {tally.images} images of {len(keeper.kept())} calls")
    out = {"correct": bool(correct), **result, "metrics": metrics,
           "device": device}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"{k} {v} limit {lim}")
    return out
