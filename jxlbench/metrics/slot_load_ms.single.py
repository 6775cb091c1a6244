"""Host ms a frame in the program's slot loads (jxl.program.load: the
copies of the inputs into the input slots)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.program.load")
