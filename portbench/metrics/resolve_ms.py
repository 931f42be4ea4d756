"""Resolve: the span of passes/resolve.py resolve_gbuffer inside each
frame, ms a frame."""

WRAPS = [("voidin_tpu_torch.passes.resolve", "resolve_gbuffer")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
