"""The render's share of its roofline: the least time of the window's frames
over dequant_idct8's and render_tail's device time, %."""

from jxlbench import readers


def read(ctx):
    return readers.render_roofline(ctx)
