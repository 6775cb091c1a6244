"""What the metric readers (jxlbench/metrics/*.py) share.

A reader gets `ctx`, the run's record: ctx.calls (each call's host-clock
arrival, start and end, its stream indices, path, and whether it failed
or raised), ctx.window_s, ctx.setup_s, ctx.facts (each stream's facts
from the configuration's maker: size, bytes, filters, AC symbols),
ctx.batch (images a batch), ctx.chips and ctx.peak_window_bytes; in the
traced run also ctx.spans (host spans: name, start, end), ctx.modes (the
port's program calls in the window by what each did) and ctx.trace
(trace.DeviceTrace).
"""

from __future__ import annotations

import numpy as np

from . import work

K3_KERNELS = ("ans_decode_kernel",)
RENDER_KERNELS = ("dequant_idct8_kernel", "render_tail_kernel")
COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def named(prefixes, anywhere=False):
    if anywhere:
        return lambda name: any(p in name for p in prefixes)
    return lambda name: name.startswith(prefixes)


def served(ctx, failed_too=False) -> list:
    """The stream indices of the window's calls that returned (and, unless
    failed_too, counted as served), one entry a decoded image."""
    return [j for c in ctx.calls if not c["raised"]
            and (failed_too or not c["failed"]) for j in c["streams"]]


def images(ctx) -> int:
    return len(served(ctx, failed_too=True))


def pixels(ctx) -> int:
    """Pixels of the images of the window's served calls."""
    return sum(ctx.facts[j]["height"] * ctx.facts[j]["width"]
               for j in served(ctx))


def p95_ms(ctx):
    """The 95th percentile of the served calls' latency, from arrival (a
    closed loop's arrival is its start) to end."""
    ms = [1e3 * (c["end"] - c["arrival"]) for c in ctx.calls
          if not c["failed"]]
    return float(np.percentile(ms, 95)) if ms else None


def span_mean_ms(ctx, names):
    ms = [1e3 * (b - a) for n, a, b in ctx.spans if n in names]
    return float(np.mean(ms)) if ms else None


def host_until_ms(ctx, name):
    """Mean host ms from a call's start to the first `name` span in it."""
    starts = sorted(a for n, a, _ in ctx.spans if n == name)
    out = []
    for c in ctx.calls:
        if c["start"] is None:
            continue
        inside = [a for a in starts if c["start"] <= a <= c["end"]]
        if inside:
            out.append(1e3 * (inside[0] - c["start"]))
    return float(np.mean(out)) if out else None


def replay_share(ctx):
    total = sum(ctx.modes.values())
    return 100.0 * ctx.modes.get("replay", 0) / total if total else None


def copy_ms(ctx, per_images: int):
    """Device ms of host-to-device and device-to-host copies, per
    `per_images` decoded images."""
    n = images(ctx)
    s = ctx.trace.seconds(named(COPIES))
    if not n or not s:
        return None
    return 1e3 * s / (n / per_images)


def render_roofline(ctx):
    """The render's least time (work.render_work of every image the window
    decoded) over dequant_idct8's and render_tail's device time, in %."""
    t = ctx.trace.seconds(named(RENDER_KERNELS, anywhere=True))
    if not t:
        return None
    least = 0.0
    for j in served(ctx, failed_too=True):
        f = ctx.facts[j]
        least += work.bound_s(*work.render_work(
            f["height"], f["width"], f["epf_iters"], f["gab"]))
    return 100.0 * least / t


def ans_roofline(ctx):
    """ans_decode's least time (work.ans_work of the AC symbols of every
    stream it decoded in the window) over its device time, in %."""
    t = ctx.trace.seconds(named(K3_KERNELS, anywhere=True))
    streams = served(ctx)
    if not t or not streams \
            or any(ctx.facts[j]["tokens"] is None for j in streams):
        return None
    least = sum(work.bound_s(*work.ans_work(ctx.facts[j]["tokens"],
                                            ctx.facts[j]["bytes"]))
                for j in streams)
    return 100.0 * least / t


def device_idle(ctx):
    busy = ctx.trace.busy_s(ctx.chips)
    if not busy:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)


def peak_gb(ctx):
    return ctx.peak_window_bytes / 1e9 if ctx.peak_window_bytes else None
