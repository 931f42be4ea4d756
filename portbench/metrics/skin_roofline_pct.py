"""The skin pose kernel's share of its roofline: roofline/skin.py's least
time of the triangles it posed over its device time in the trace, %. A
program without the kernel (no ops/skin.py) reads nothing."""

import importlib.util

from roofline import skin as _kernel

KERNEL = _kernel if importlib.util.find_spec(_kernel.MODULE) else None
WRAPS = []


def read(ctx):
    return None if KERNEL is None else ctx.roofline(KERNEL)
