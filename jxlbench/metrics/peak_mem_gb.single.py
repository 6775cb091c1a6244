"""torch.cuda.max_memory_allocated over the window, the fullest card's, GB."""

from jxlbench import readers


def read(ctx):
    return readers.peak_gb(ctx)
