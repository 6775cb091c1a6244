"""The 95th percentile of a decode's host-clock time in the traced run, ms."""

from jxlbench import readers


def read(ctx):
    return readers.p95_ms(ctx)
