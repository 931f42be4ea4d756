"""TAA: the span of passes/taa.py taa inside each frame, ms a frame."""

WRAPS = [("voidin_tpu_torch.passes.taa", "taa")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
