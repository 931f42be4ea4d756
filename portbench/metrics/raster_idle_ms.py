"""Device idle ms a frame put down to setup + binning + K1 (the host in the
scope "raster"): the traced window's idle intervals split by the innermost
program scope the host was in (pb/scopes.py)."""

from pb import scopes

WRAPS = []


def read(ctx):
    w = scopes.window(ctx)
    return None if w is None else w.idle_ms("raster")
