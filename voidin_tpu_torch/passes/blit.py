"""Blit utilities: format conversion, resize, mip generation.

Counterpart of ``voidin_tpu/passes/blit.py``: the reference Blitter
(components/src/blitter.rs:9-240), the final present blit with optional
sRGB encode and mip generation by iterated 2x2 downsampling
(blitter.rs:139-200), as dense tensor ops on the image's device; the
"formats" are dtypes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..scene.texture import linear_to_srgb


def present(hdr: torch.Tensor, srgb: bool = True, to_uint8: bool = False):
    """HDR (H, W, 3) -> displayable frame (the swapchain blit,
    app.rs:334-340)."""
    img = linear_to_srgb(hdr) if srgb else torch.clamp(hdr, 0.0, 1.0)
    if to_uint8:
        img = (img * 255.0 + 0.5).to(torch.uint8)
    return img


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """One mip step: 2x2 box filter (blitter.rs generate_mipmaps step). An
    odd row or column is dropped; the four taps add in the order XLA's
    reduction takes them."""
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w].reshape(h // 2, 2, w // 2, 2, -1)
    s = x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0] + x[:, 1, :, 1]
    return (s / 4).reshape(h // 2, w // 2, *img.shape[2:])


def generate_mipmaps(img: torch.Tensor):
    """Full mip chain down to 1x1-ish."""
    mips = [img]
    while min(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        mips.append(downsample2x(mips[-1]))
    return mips


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize (the blitter's scaling copy) of an (H, W, ...) image,
    with the triangle filter widened when it shrinks, as
    jax.image.resize(..., "bilinear") antialiases."""
    h, w = img.shape[:2]
    rest = img.shape[2:]
    x = img.reshape(h, w, -1).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).reshape(height, width, *rest)
