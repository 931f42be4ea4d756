"""Post + sRGB: the spans of passes/postprocess.py postprocess and of
linear_to_srgb as framework/renderer.py calls it, ms a frame."""

WRAPS = [("voidin_tpu_torch.passes.postprocess", "postprocess"),
         ("voidin_tpu_torch.framework.renderer", "linear_to_srgb")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
