"""The frame driver's host time: ms a frame the host spent inside the
program's scope "frame" (Renderer.render), from the program's own scopes
in the traced window (pb/scopes.py)."""

from pb import scopes

WRAPS = []


def read(ctx):
    w = scopes.window(ctx)
    return None if w is None else w.frame_host_ms()
