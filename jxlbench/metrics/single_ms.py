"""The window's time over the calls served in it, ms: the single-image
caller's mean wait."""


def read(ctx):
    served = sum(not c["failed"] for c in ctx.calls)
    return 1e3 * ctx.window_s / max(1, served)
