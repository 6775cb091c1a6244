"""Host ms a frame in its AC global section (jxl.frame.ac_global: DC
smoothing, dequant matrices, coefficient orders, histograms)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.frame.ac_global")
