"""The comparison that decides `correct`, and its control.

A run's outputs are u8 sRGB images. Each one kept (a sample drawn from
the seed, see harness.Keeper) is compared with the frozen host decode of
its stream (the configuration maker's reference) by two numbers:

- max_steps: the largest difference of one u8 value. The configuration
  states its limit (`limits.max_steps`): the port's documented guarantee
  is one u8 step from the host decode.
- off_share: the share of u8 values that differ at all, over every value
  compared. Its limit (`limits.off_share`) lies between the highest share
  that sound runs of the program read over a dozen seeds and the lowest
  that the control reads (PERF.md gives both readings).

The control is the reference put in the program's place and computed a
precision lower than the configuration's float32: every stage of the
render (dequantization and inverse transforms, Gaborish, the EPF passes,
XYB to linear RGB) has its output rounded to bfloat16, as a program that
kept its images in bfloat16 between stages would deliver them.
"""

from __future__ import annotations

import contextlib

import numpy as np


def to_bf16(x):
    """x rounded to the nearest bfloat16 (ties to even), as float32."""
    a = np.ascontiguousarray(x, dtype=np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


@contextlib.contextmanager
def bf16_stages():
    """The frozen host decoder with each render stage's output rounded to
    bfloat16, for the length of the block."""
    from .refcodec.ops import xyb
    from .refcodec.render import pipeline
    from .refcodec.vardct import frame

    saved = [(frame, "render_groups"), (pipeline, "apply_gaborish"),
             (pipeline, "apply_epf"), (xyb, "xyb_to_linear_rgb")]
    originals = [getattr(m, n) for m, n in saved]

    def render_groups(state, _f=originals[0]):
        _f(state)
        state.xyb[...] = to_bf16(state.xyb)

    def rounded(f):
        return lambda *a, **k: to_bf16(f(*a, **k)).astype(np.float64)

    frame.render_groups = render_groups
    pipeline.apply_gaborish = rounded(originals[1])
    pipeline.apply_epf = rounded(originals[2])
    xyb.xyb_to_linear_rgb = rounded(originals[3])
    try:
        yield
    finally:
        for (m, n), f in zip(saved, originals):
            setattr(m, n, f)


class Tally:
    """The two numbers over every image compared, and the images that were
    due and never came or came in the wrong shape."""

    def __init__(self):
        self.max_steps = 0
        self.off = 0
        self.values = 0
        self.images = 0
        self.missing = 0

    def add(self, got, ref) -> None:
        ref = np.asarray(ref)
        if got is None or np.shape(got) != ref.shape:
            self.missing += 1
            return
        d = np.abs(np.asarray(got, np.int16) - ref.astype(np.int16))
        self.max_steps = max(self.max_steps, int(d.max()))
        self.off += int(np.count_nonzero(d))
        self.values += d.size
        self.images += 1

    @property
    def off_share(self) -> float:
        return self.off / self.values if self.values else 1.0

    def verdict(self, limits: dict) -> tuple[bool, dict]:
        """(correct, {name: [number, limit]}): every number within its
        limit, at least one image compared and none missing."""
        numbers = {"max_steps": [self.max_steps, limits["max_steps"]],
                   "off_share": [self.off_share, limits["off_share"]],
                   "missing": [self.missing, 0]}
        ok = self.images > 0 and all(v <= lim for v, lim in numbers.values())
        return ok, numbers
