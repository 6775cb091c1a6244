"""The traffic generator (jxlbench/loop.py) with a stand-in for the
entry: closed loops of one or more callers, and the open loop."""

import time

import pytest

from jxlbench import loop


def sleeper(seconds):
    def one(n, idx):
        time.sleep(seconds)
        return {"path": "x", "failed": False, "raised": False}
    return one


def test_call_streams_cycle():
    tr = {"per_call": 3}
    assert loop.call_streams(tr, 4, 0) == [0, 1, 2]
    assert loop.call_streams(tr, 4, 1) == [3, 0, 1]


def test_one_closed_caller_runs_back_to_back():
    t0, t1, calls = loop.drive({"per_call": 1}, sleeper(0.01), 4, 2, 0.1, 1)
    assert t1 >= t0 + 0.1 and len(calls) >= 5
    assert [c["streams"] for c in calls[:3]] == [[2], [3], [0]]
    for a, b in zip(calls, calls[1:]):
        assert b["start"] >= a["end"] and a["arrival"] == a["start"]


def test_closed_callers_overlap_and_share_the_streams():
    t0, t1, calls = loop.drive({"per_call": 1, "clients": 3},
                               sleeper(0.02), 1000, 0, 0.1, 1)
    firsts = sorted(c["streams"][0] for c in calls)
    assert firsts == list(range(len(calls)))
    assert len(calls) >= 3 * 4
    assert calls[1]["start"] < calls[0]["end"]


def test_open_loop_arrivals_are_the_same_work_for_every_seed():
    tr = {"per_call": 1, "rate_per_s": 200}
    a, b = loop.arrivals(tr, 1, 1.0), loop.arrivals(tr, 2 ** 40 + 3, 1.0)
    assert len(a) == len(b) and 150 <= len(a) <= 250
    assert a != b and a[-1] == pytest.approx(b[-1])
    assert a == loop.arrivals(tr, 1, 1.0)


def test_open_loop_latency_counts_from_arrival():
    tr = {"per_call": 1, "rate_per_s": 100, "clients": 1}
    t0, t1, calls = loop.drive(tr, sleeper(0.02), 4, 0, 0.2, 5)
    assert len(calls) == len(loop.arrivals(tr, 5, 0.2))
    assert all(not c["failed"] for c in calls)
    # one caller at 50 a second under 100 a second: a queue builds
    waits = [c["start"] - c["arrival"] for c in calls]
    assert waits[-1] > waits[0] and min(waits) >= -1e-3


def test_open_loop_counts_the_never_served(monkeypatch):
    monkeypatch.setattr(loop, "GRACE_S", 0.0)
    tr = {"per_call": 1, "rate_per_s": 200, "clients": 1}
    t0, t1, calls = loop.drive(tr, sleeper(0.05), 4, 0, 0.2, 5)
    never = [c for c in calls if c.get("why") == "never served"]
    assert never and all(c["failed"] and c["end"] is None for c in never)
    assert len(calls) == len(loop.arrivals(tr, 5, 0.2))
