"""Triangles posed a frame: the program's counter "skin.tris" (each skin's
triangles, counted by scene/skin.py apply_skin), in the traced window
(pb/scopes.py). A program that does not count it reads nothing."""

from pb import scopes

WRAPS = []


def read(ctx):
    w = scopes.window(ctx)
    if w is None or not any("skin.tris" in d["counters"]
                            for d in w.records):
        return None
    return w.counter("skin.tris")
