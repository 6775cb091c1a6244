"""ans_decode's share of its roofline: the least time of the window's AC
symbols over the kernel's device time, %."""

from jxlbench import readers


def read(ctx):
    return readers.ans_roofline(ctx)
