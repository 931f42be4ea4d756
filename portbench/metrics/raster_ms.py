"""Triangle setup, binning and K1: the span of passes/raster.py rasterize
inside each frame, ms a frame."""

WRAPS = [("voidin_tpu_torch.passes.raster", "rasterize")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
