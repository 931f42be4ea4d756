"""Draws a frame: the program's counter "draws" (the cull's compacted
draw count), in the traced window (pb/scopes.py)."""

from pb import scopes

WRAPS = []


def read(ctx):
    w = scopes.window(ctx)
    return None if w is None else w.counter("draws")
