"""What the traced run reads: host-clock spans the harness records around
calls into the port's layers (spans.json names them), the modes of the
port's program calls, and the device's activity from torch.profiler's
trace.

Nothing here is installed in a run with --trace 0.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 64


class Spans:
    """Host-clock spans (name, start, end), perf_counter seconds, and each
    one as a torch.profiler range of the same name."""

    def __init__(self):
        self.spans = []
        self.modes = collections.Counter()
        self._undo = []

    def wrap(self, module, attr: str, name: str) -> None:
        import torch

        inner = getattr(module, attr)
        spans = self.spans

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            with torch.profiler.record_function(name):
                t = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    spans.append((name, t, time.perf_counter()))

        setattr(module, attr, timed)
        self._undo.append((module, attr, inner))

    def install(self, spec_path) -> None:
        """Wrap each function that spec_path (a JSON list of {"module",
        "attr", "span"}) names, and count the port's program calls by what
        each does (eager, capture, replay)."""
        for s in json.loads(open(spec_path).read()):
            self.wrap(importlib.import_module(s["module"]), s["attr"],
                      s["span"])
        from libjxl_tpu_torch.ops import programs

        call = programs.Program.__call__
        modes = self.modes

        def counted(prog, *args, **kwargs):
            modes[prog.mode] += 1
            return call(prog, *args, **kwargs)

        programs.Program.__call__ = counted
        self._undo.append((programs.Program, "__call__", call))

    def uninstall(self) -> None:
        for obj, attr, inner in reversed(self._undo):
            setattr(obj, attr, inner)
        self._undo.clear()


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block (host and CUDA activity); yields a
    dict that holds, after the block, the trace's events as a list."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    got = {}
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] * cuda)
    with profile(activities=activities) as prof:
        yield got
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            got["events"] = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """The device's activity inside the traced window: `ops` as (name,
    category, start s, duration s, device), clipped to the window."""

    def __init__(self, events: list, window_name: str):
        win = [e for e in events if e.get("name") == window_name
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace has no window range")
        w = win[0]
        self.start = w["ts"] * 1e-6
        self.end = (w["ts"] + w["dur"]) * 1e-6
        self.ops = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = e["ts"] * 1e-6
            b = a + e["dur"] * 1e-6
            if b <= self.start or a >= self.end:
                continue
            a, b = max(a, self.start), min(b, self.end)
            if e.get("cat") in DEVICE_CATS:
                dev = int(e.get("args", {}).get("device", 0))
                self.ops.append((e["name"], e["cat"], a, b - a, dev))
            elif e.get("cat") == "user_annotation" \
                    and e["name"] != window_name:
                self.host.append((e["name"], a, b))

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self, devices: int) -> float:
        """Seconds in which an operation ran, averaged over `devices`."""
        by_dev = collections.defaultdict(list)
        for _, _, a, d, dev in self.ops:
            by_dev[dev].append((a, a + d))
        total = sum(b - a for iv in by_dev.values() for a, b in _merge(iv))
        return total / max(1, devices)

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name match(name) holds."""
        return sum(d for name, _, _, d, _ in self.ops if match(name))

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, _, _, d, _ in self.ops:
            by[name[:NAME_CHARS]] += d
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest stretches in which no device was busy, each named
        by the innermost host span around its middle."""
        busy = _merge([(a, a + d) for _, _, a, d, _ in self.ops])
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [(e - s, name) for name, s, e in self.host
                      if s <= mid <= e]
            out.append([min(inside)[1] if inside else "outside spans",
                        b - a])
        return out
