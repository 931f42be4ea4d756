"""Shading: the spans of passes/shading.py shade and shade_raytraced
inside each frame, ms a frame."""

WRAPS = [("voidin_tpu_torch.passes.shading", "shade"),
         ("voidin_tpu_torch.passes.shading", "shade_raytraced")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
