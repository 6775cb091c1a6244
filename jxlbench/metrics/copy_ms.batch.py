"""Device ms of host-to-device and device-to-host copies a batch."""

from jxlbench import readers


def read(ctx):
    return readers.copy_ms(ctx, ctx.batch)
