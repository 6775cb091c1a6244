"""Megapixels of u8 output of the window's served calls over the window's
time, from its first call's start to its last call's end."""

from jxlbench import readers


def read(ctx):
    return readers.pixels(ctx) / 1e6 / ctx.window_s
