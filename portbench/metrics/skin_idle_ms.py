"""Device idle ms a frame put down to the skin layer: the host's innermost
program scope "update.skin" or "update.refit" or one under them
(pb/skin_scopes.py on pb/scopes.py's idle split)."""

from pb import skin_scopes

WRAPS = []


def read(ctx):
    return skin_scopes.idle_ms(ctx)
