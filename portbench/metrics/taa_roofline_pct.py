"""The TAA kernel's share of its roofline: roofline/taa.py's least time of
the pixels it was handed over its device time in the trace, %. A program
without the kernel (no ops/taa.py) reads nothing."""

import importlib.util

from roofline import taa as _kernel

KERNEL = _kernel if importlib.util.find_spec(_kernel.MODULE) else None
WRAPS = []


def read(ctx):
    return None if KERNEL is None else ctx.roofline(KERNEL)
