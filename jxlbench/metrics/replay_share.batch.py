"""The share of the port's program calls in the window that replayed a captured
graph, %."""

from jxlbench import readers


def read(ctx):
    return readers.replay_share(ctx)
