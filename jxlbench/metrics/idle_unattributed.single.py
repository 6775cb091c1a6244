"""The share of the window's device-idle time, %, that no span of the port
accounts for: no jxl. span open, or only a request's root."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.idle_unattributed(ctx)
