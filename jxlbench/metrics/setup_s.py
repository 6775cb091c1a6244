"""The set-up's host-clock seconds: the port imported, the entry opened,
the traffic's warm-up calls made and the cards synchronized."""


def read(ctx):
    return ctx.setup_s
