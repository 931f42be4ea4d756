"""Refits: the spans of scene/skin.py refit_blas (each skin's BLAS) and
refit_tlas inside each frame, ms a frame. The BLAS refits run inside
apply_skins, so their ms lie inside skin_ms too; the TLAS refit's do not."""

WRAPS = [("voidin_tpu_torch.scene.skin", "refit_blas"),
         ("voidin_tpu_torch.scene.skin", "refit_tlas")]


def read(ctx):
    return ctx.span_ms_per_frame(WRAPS)
