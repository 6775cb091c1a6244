"""The share of the traced window in which no kernel and no copy ran, %,
averaged over the cards."""

from jxlbench import readers


def read(ctx):
    return readers.device_idle(ctx)
