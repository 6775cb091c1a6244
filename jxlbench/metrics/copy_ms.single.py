"""Device ms of host-to-device and device-to-host copies an image."""

from jxlbench import readers


def read(ctx):
    return readers.copy_ms(ctx, 1)
