"""Host ms from a decode's call to its render's program call (the first
programs.run in it, the "dec_sub" program): parse, native subsampled
entropy, staging."""

from jxlbench import readers


def read(ctx):
    return readers.host_until_ms(ctx, "programs.run")
