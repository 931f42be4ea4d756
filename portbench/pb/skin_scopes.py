"""The skin layer in the program's frame scopes (pb/scopes.py): the
scopes "update.skin" (posing every skin and refitting its BLAS) and
"update.refit" (the TLAS refit) that voidin_tpu_torch/framework/renderer.py
opens, and every scope under them, read in the traced window.

Against a program without scopes, or one that opens neither scope, the
readers get None and nothing raises.
"""

from pb import scopes

SKIN_SCOPES = ("update.skin", "update.refit")
SKIN, OTHER = "skin", "other"


def skin_labels(records):
    """SKIN for each record (profiler.collect()'s dicts, parents first)
    that is a skin scope or lies under one, OTHER for the rest."""
    labels = []
    for d in records:
        p = d["parent"]
        under = p is not None and labels[p] == SKIN
        labels.append(SKIN if under or d["name"] in SKIN_SCOPES else OTHER)
    return labels


def skin_window(ctx):
    """(the Window of pb/scopes.py, its records' labels), or None where
    the program records no scopes or no skin scope in the window."""
    w = scopes.window(ctx)
    if w is None:
        return None
    labels = skin_labels(w.records)
    if SKIN not in labels:
        return None
    return w, labels


def idle_ms(ctx):
    """Device idle ms a frame with the host's innermost scope a skin
    scope or one under it: the traced window's idle intervals split by
    the innermost scope (pb/scopes.py idle_by_layer)."""
    got = skin_window(ctx)
    if got is None:
        return None
    w, labels = got
    tr = ctx.trace
    ns = scopes.idle_by_layer(tr.t0, tr.t1, tr.busy_intervals(),
                              [(d["t0"], d["t1"], lab)
                               for d, lab in zip(w.records, labels)])
    return ns.get(SKIN, 0) / 1e6 / ctx.frames


def syncs(ctx):
    """Host-device syncs a frame counted in the skin scopes."""
    got = skin_window(ctx)
    if got is None:
        return None
    w, labels = got
    return sum(d["syncs"] for d, lab in zip(w.records, labels)
               if lab == SKIN) / ctx.frames
