"""Post-processing: luma sharpen (in sqrt-luma space) + neutral tonemap.

Counterpart of ``voidin_tpu/passes/postprocess.py`` (shaders/
postprocess.wgsl:22-98, identical constants). Neighbours are
edge-clamped array shifts: the reference's bilinear +1-texel taps land
exactly on the neighbouring texel at pixel centers.
"""

from __future__ import annotations

import torch

from ..core import fastmath
from ..core.color import calculate_luma, rgb_to_ycbcr
from ..framework import profiler
from .taa import _shift


def tonemap_curve(v):
    c = v + v * v + 0.5 * v * v * v
    return c / (1.0 + c)


def neutral_tonemap(col):
    ycbcr = rgb_to_ycbcr(col)
    cb, cr = ycbcr[..., 1], ycbcr[..., 2]
    chroma = fastmath.sqrt(cb * cb + cr * cr) * 2.4
    bt = tonemap_curve(chroma)
    desat = torch.clamp((bt - 0.7) * 0.8, min=0.0)
    desat = desat * desat
    desat_col = col + (ycbcr[..., 0:1] - col) * desat[..., None]
    tm_luma = tonemap_curve(ycbcr[..., 0])
    luma = calculate_luma(col)
    tm0 = col * torch.clamp(
        tm_luma / torch.clamp(luma, min=1e-5), min=0.0
    )[..., None]
    tm1 = tonemap_curve(desat_col)
    res = tm0 + (tm1 - tm0) * (bt * bt)[..., None]
    return res * 0.97


@profiler.scoped("post.tonemap")
def postprocess(color: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) HDR -> (H, W, 3) tonemapped LDR-ish (still linear-light)."""
    sharpen_amount = 0.5

    def remap(l):
        return fastmath.sqrt(torch.clamp(l, min=0.0))

    center = remap(calculate_luma(color))
    n_x = remap(calculate_luma(_shift(color, 0, 1)))
    n_y = remap(calculate_luma(_shift(color, 1, 0)))

    neighbours = torch.zeros_like(center)
    wt_sum = torch.zeros_like(center)
    # The WGSL loop runs dim=0..1 but indexes dim_offsets[0]/[1] both times,
    # accumulating the same two neighbours twice; reproduced faithfully.
    for _dim in range(2):
        wt = torch.clamp(
            1.0 - 6.0 * ((center - n_x).abs() + (center - n_y).abs()),
            min=0.0,
        )
        wt = torch.minimum(wt, sharpen_amount * wt * 1.25)
        neighbours = neighbours + n_x * wt + n_y * wt
        wt_sum = wt_sum + wt * 2.0

    sharpened = torch.clamp(center * (wt_sum + 1.0) - neighbours, min=0.0)
    sharpened = sharpened * sharpened  # remap_inv
    luma = calculate_luma(color)
    col = color * torch.clamp(
        sharpened / torch.clamp(luma, min=1e-5), min=0.0
    )[..., None]
    return neutral_tonemap(col)
