"""What the readers of the port's own spans share.

The port marks its host work as torch.profiler ranges whose names start
with "jxl." (libjxl_tpu_torch/base/device.span) while a profiler
records, so in the traced run they are among ctx.trace.host, clipped to
the window and on the device trace's clock. A program without them (one
older than its spans) gives these readers nothing, and they return None.
"""

from __future__ import annotations

from .trace import _merge

PREFIX = "jxl."
# each entry call's span, one a request
ROOTS = frozenset({"jxl.decode", "jxl.decode_batch_entropy",
                   "jxl.decode_batch", "jxl.decode_batch_sharded",
                   "jxl.decode_pipelined"})


def spans(ctx) -> list:
    """The port's spans in the window: (name, start s, end s)."""
    return [s for s in ctx.trace.host if s[0].startswith(PREFIX)]


def per_call_ms(ctx, name: str):
    """The window's host ms inside spans `name` (a stretch that two of
    them cover counted once) over its calls that did not raise."""
    got = [(a, b) for n, a, b in spans(ctx) if n == name]
    calls = sum(not c["raised"] for c in ctx.calls)
    if not got or not calls:
        return None
    return 1e3 * sum(b - a for a, b in _merge(got)) / calls


def idle(ctx) -> list:
    """The window's stretches in which no kernel and no copy ran on any
    card: [start, end] in the trace's seconds."""
    t = ctx.trace
    busy = _merge((a, a + d) for _, _, a, d, _ in t.ops)
    out, at = [], t.start
    for a, b in busy:
        if a > at:
            out.append([at, a])
        at = max(at, b)
    if t.end > at:
        out.append([at, t.end])
    return out


def idle_unattributed(ctx):
    """The share of the window's device-idle time, %, in which no span of
    the port is open but a request's root (or none at all): the innermost
    open span, the latest begun, names where else the idle time went."""
    mine = spans(ctx)
    gaps = idle(ctx)
    total = sum(b - a for a, b in gaps)
    if not mine or not total:
        return None
    # a sweep over every edge of a span or of an idle stretch; at one
    # instant ends come before starts, so that touching spans do not nest
    edges = []
    for k, (_, a, b) in enumerate(mine):
        edges += [(a, 1, k), (b, 0, k)]
    for a, b in gaps:
        edges += [(a, 1, -1), (b, 0, -1)]
    edges.sort()
    open_, idle_now, lost, at = {}, 0, 0.0, None
    for t, starts, k in edges:
        if idle_now and at is not None and t > at:
            inner = max(open_.values(), default=None)
            if inner is None or mine[inner[2]][0] in ROOTS:
                lost += t - at
        at = t
        if k < 0:
            idle_now += 1 if starts else -1
        elif starts:
            # (start, -end): of two spans begun at one instant, the
            # shorter is the inner
            open_[k] = (mine[k][1], -mine[k][2], k)
        else:
            open_.pop(k, None)
    return 100.0 * lost / total
