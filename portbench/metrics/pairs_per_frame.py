"""(Triangle, tile) pairs a frame: the program's counter "pairs" (the
pairs its binning placed), in the traced window (pb/scopes.py)."""

from pb import scopes

WRAPS = []


def read(ctx):
    w = scopes.window(ctx)
    return None if w is None else w.counter("pairs")
