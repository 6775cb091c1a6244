"""Host ms a frame in the program's readback (jxl.program.readback: the
wait for its kernels and the copy of its outputs to the host)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.program.readback")
