"""Host ms a frame in staging (jxl.stage: tpu_codec.stage_image, the
special tiles and size passes laid out)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.stage")
