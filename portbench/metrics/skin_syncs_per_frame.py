"""Host-device synchronisations a frame inside the program's scopes
"update.skin" and "update.refit" and those under them (its sync counter),
in the traced window (pb/skin_scopes.py)."""

from pb import skin_scopes

WRAPS = []


def read(ctx):
    return skin_scopes.syncs(ctx)
