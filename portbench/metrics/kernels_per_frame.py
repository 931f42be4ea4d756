"""The frame driver's dispatch load: CUDA kernels in the profiler's trace
of the window, a frame."""

WRAPS = []


def read(ctx):
    return ctx.trace.kernel_count() / ctx.frames
