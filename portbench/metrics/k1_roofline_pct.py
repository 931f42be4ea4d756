"""Kernel K1's share of its roofline: roofline/k1.py's least time of the
work it was handed over its device time in the trace, %."""

from roofline import k1 as KERNEL

WRAPS = []


def read(ctx):
    return ctx.roofline(KERNEL)
