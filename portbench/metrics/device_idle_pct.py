"""The device's idle share of the traced window: 100 x (1 - the union of
its activity intervals / the window's wall time)."""

WRAPS = []


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
