"""The share of the traced window in which no kernel and no copy ran, %."""

from jxlbench import readers


def read(ctx):
    return readers.device_idle(ctx)
