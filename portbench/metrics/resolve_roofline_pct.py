"""The dense resolve kernel's share of its roofline: roofline/resolve.py's
least time of the pixels it was handed over its device time in the trace,
%. A program without the kernel (no ops/resolve.py) reads nothing."""

import importlib.util

from roofline import resolve as _kernel

KERNEL = _kernel if importlib.util.find_spec(_kernel.MODULE) else None
WRAPS = []


def read(ctx):
    return None if KERNEL is None else ctx.roofline(KERNEL)
