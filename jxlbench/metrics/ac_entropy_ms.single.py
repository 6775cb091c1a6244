"""Host ms a frame in its AC group sections (jxl.frame.ac: the native bulk
entropy decode and its threads)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.frame.ac")
