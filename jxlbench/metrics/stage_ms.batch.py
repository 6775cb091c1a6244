"""Host ms a batch in staging (jxl.stage: the render gates, the batch's
arrays and its render configuration)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.stage")
