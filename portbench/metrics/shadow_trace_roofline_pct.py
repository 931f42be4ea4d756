"""The shadow walk's and its packing kernel's share of their roofline:
roofline/shadow_trace.py's least time of the work they were handed over
their device time in the trace, %."""

from roofline import shadow_trace as KERNEL

WRAPS = []


def read(ctx):
    return ctx.roofline(KERNEL)
