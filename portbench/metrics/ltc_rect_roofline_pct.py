"""The fused LTC rect kernel's share of its roofline: roofline/ltc_rect.py's
least time of the work it was handed over its device time in the trace, %."""

from roofline import ltc_rect as KERNEL

WRAPS = []


def read(ctx):
    return ctx.roofline(KERNEL)
