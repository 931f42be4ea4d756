"""Skinning: the span of scene/skin.py apply_skins inside each frame (every
skin posed into the pool tables, with its BLAS refit), ms a frame."""

WRAPS = [("voidin_tpu_torch.scene.skin", "apply_skins")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
