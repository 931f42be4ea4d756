"""Device idle ms a frame put down to TAA (the host in the scope "taa"): the
traced window's idle intervals split by the innermost program scope the host
was in (pb/scopes.py)."""

from pb import scopes

WRAPS = []


def read(ctx):
    w = scopes.window(ctx)
    return None if w is None else w.idle_ms("taa")
