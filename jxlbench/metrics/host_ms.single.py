"""Host ms from a decode's call to the render's (tpu_codec.render_image):
parse, entropy decode, staging."""

from jxlbench import readers


def read(ctx):
    return readers.host_until_ms(ctx, "render_image")
