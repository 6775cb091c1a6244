"""Host ms a batch in its frames' DC sections (jxl.frame.dc: DC global,
the modular tree, and every DC group)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.frame.dc")
