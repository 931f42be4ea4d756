"""Temporal anti-aliasing: depth-dilated reprojection + variance-clamped
history resolve.

Counterpart of ``voidin_tpu/passes/taa.py`` on its default path (ports of
shaders/reproject.wgsl:14-38 and shaders/taa.wgsl:45-103): 3x3 max-depth
dilation, velocity = (curr_ndc + jitter) - (prev_ndc + prev_jitter), YCbCr
Gaussian-weighted 3x3 moments, Mitchell-Netravali(B=C=1/3) filtered
center, adaptive box from local contrast + texel-center distance,
mu +/- 1.5 sigma clamp, blend 1 -> 1/12 by velocity validity widened by
clamp distance. As in the JAX package, frame 0 seeds the history with the
current frame instead of converging from black.

The port writes the resolved image into the history buffer IN PLACE
(FrameState.history.copy_): one full-resolution buffer carried across
frames instead of a new one per frame. ``reproject`` and ``taa_resolve``
also run on a window of rows (a slab of the sharded frame,
framework/renderer.py), reading the whole history.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fastmath
from ..core.color import rgb_to_ycbcr, ycbcr_to_rgb
from .shading import _pixel_ndc, pixel_rows, world_position_from_depth


def _shift(img, dy, dx):
    """Edge-clamped shift: out[y, x] = img[y+dy, x+dx]."""
    H, W = img.shape[:2]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[ys][:, xs]


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _mitchell_weight_np(x: float) -> float:
    """Scalar Mitchell-Netravali weight (host-side constant)."""
    B = C = 1.0 / 3.0
    ax = abs(float(x))
    if ax < 1.0:
        return (
            (12 - 9 * B - 6 * C) * ax**3
            + (-18 + 12 * B + 6 * C) * ax**2
            + (6 - 2 * B)
        ) / 6.0
    if ax < 2.0:
        return (
            (-B - 6 * C) * ax**3
            + (6 * B + 30 * C) * ax**2
            + (-12 * B - 48 * C) * ax
            + (8 * B + 24 * C)
        ) / 6.0
    return 0.0


def history_quads(img):
    """The (H, W, C) history as its bilinear table: the 2x2 texel
    neighbourhood (clamp-to-edge) packed as one f16 row per texel, (H * W,
    4 C) (the JAX package's history table, f16 included)."""
    H, W, C = img.shape
    xn = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    yn = torch.cat([img[1:], img[-1:]], dim=0)
    xyn = torch.cat([xn[1:], xn[-1:]], dim=0)
    return torch.cat([img, xn, yn, xyn], dim=-1).to(torch.float16).reshape(
        H * W, 4 * C)


def _bilinear_clamp(img, u, v, quads=None):
    """Bilinear sample of (H, W, C) at normalized uv (clamp-to-edge) from
    its history_quads table (`quads`, built here when not given)."""
    H, W, C = img.shape
    if quads is None:
        quads = history_quads(img)
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.clamp(torch.nan_to_num(x0), 0, W - 1).to(torch.int64)
    y0i = torch.clamp(torch.nan_to_num(y0), 0, H - 1).to(torch.int64)
    q = quads[y0i * W + x0i].to(torch.float32)
    c00, c10 = q[..., :C], q[..., C: 2 * C]
    c01, c11 = q[..., 2 * C: 3 * C], q[..., 3 * C:]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def reproject(gbuffer, camera, row0: int = 0, height=None) -> torch.Tensor:
    """-> (H, W, 3): (velocity.xy in NDC units, in-bounds flag). `row0` /
    `height`: the G-buffer holds image rows [row0, row0 + H) of a
    `height`-row image; the 3x3 depth dilation makes a window's first and
    last rows exact only at the image's edges (the sharded frame gives
    each slab one row of halo on each side)."""
    depth = gbuffer.depth
    H, W = depth.shape
    height = H if height is None else height
    d = depth
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            d = torch.maximum(d, _shift(depth, dy, dx))
    x_ndc, y_ndc = _pixel_ndc(H, W, depth.device, row0, height)
    pos_ws = world_position_from_depth(d, camera.clip_to_world, row0, height)
    m = np.asarray(camera.prev_world_to_clip, np.float32)
    px_, py_, _pz, pw_ = fastmath.const_mat4_point4(
        m, pos_ws[..., 0], pos_ws[..., 1], pos_ws[..., 2]
    )
    prev_x = px_ / pw_
    prev_y = py_ / pw_
    jit = [float(v) for v in np.asarray(camera.jitter, np.float32)]
    pjit = [float(v) for v in np.asarray(camera.prev_jitter, np.float32)]
    vel_x = (x_ndc + jit[0]) - (prev_x + pjit[0])
    vel_y = (y_ndc + jit[1]) - (prev_y + pjit[1])
    lo_x, hi_x = -1.0 + float(np.float32(1.0 / W)), 1.0 - float(
        np.float32(1.0 / W))
    lo_y, hi_y = -1.0 + float(np.float32(1.0 / height)), 1.0 - float(
        np.float32(1.0 / height))
    in_bounds = (prev_x == torch.clamp(prev_x, lo_x, hi_x)) & (
        prev_y == torch.clamp(prev_y, lo_y, hi_y))
    return torch.stack([vel_x, vel_y, in_bounds.to(torch.float32)], dim=-1)


def taa_resolve(color, history, motion, row0: int = 0, quads=None):
    """taa.wgsl:45-103. color/motion: (H, W, 3); history: the whole (H',
    W, 3) image. `row0`: color and motion hold image rows [row0, row0 +
    H) of the history's image (a window of the sharded frame; its first
    and last rows are exact only at the image's edges); `quads`: the
    history's history_quads table, built here when not given."""
    H, W = color.shape[:2]
    dev = color.device
    height = history.shape[0]
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    v = pixel_rows(H, dev, row0, height)
    uu = u[None, :].expand(H, W)
    vv = v[:, None].expand(H, W)
    vel = motion
    hist_u = uu - vel[..., 0] * 0.5
    hist_v = vv + vel[..., 1] * 0.5  # * (1, -1) flip
    hist = rgb_to_ycbcr(_bilinear_clamp(history, hist_u, hist_v, quads))

    vsum = torch.zeros_like(color)
    vsum2 = torch.zeros_like(color)
    wsum = 0.0
    mn_sum = torch.zeros_like(color)
    mn_wsum = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = _shift(color, dy, dx)
            neigh = rgb_to_ycbcr(shifted)
            w = float(np.exp(-3.0 * (dx * dx + dy * dy) / 4.0))
            vsum = vsum + neigh * w
            vsum2 = vsum2 + neigh * neigh * w
            wsum += w
            wt = _mitchell_weight_np(np.sqrt(dx * dx + dy * dy))
            mn_sum = mn_sum + shifted * wt
            mn_wsum += wt

    ex = vsum / wsum
    ex2 = vsum2 / wsum
    dev_ = fastmath.sqrt(torch.clamp(ex2 - ex * ex, min=0.0))
    local_contrast = dev_[..., 0] / (ex[..., 0] + 1e-5)

    hist_px = hist_u * W
    hist_py = hist_v * height
    frac_x = hist_px - torch.floor(hist_px)
    frac_y = hist_py - torch.floor(hist_py)
    texel_center_dist = (0.5 - frac_x).abs() + (0.5 - frac_y).abs()

    box_size = 1.0 * (0.5 + 0.5 * _smoothstep(-0.1, 0.3, local_contrast))
    box_size = box_size * (
        0.5 + 0.5 * torch.clamp(1.0 - texel_center_dist, 0.0, 1.0)
    )
    center = rgb_to_ycbcr(mn_sum / mn_wsum)

    n_dev = 1.5
    bs2 = (box_size * box_size)[..., None]
    mid = center + (ex - center) * bs2
    nmin = mid - dev_ * (box_size[..., None] * n_dev)
    nmax = mid + dev_ * (box_size[..., None] * n_dev)

    clamped = torch.minimum(torch.maximum(hist, nmin), nmax)
    blend = 1.0 + (1.0 / 12.0 - 1.0) * vel[..., 2]
    clamp_dist = torch.minimum(
        (hist[..., 0] - nmin[..., 0]).abs(), (hist[..., 0] - nmax[..., 0]).abs()
    ) / torch.clamp(torch.maximum(hist[..., 0], ex[..., 0]), min=1e-5)
    blend = blend * (0.2 + 0.8 * _smoothstep(0.0, 2.0, clamp_dist))
    result = clamped + (center - clamped) * blend[..., None]
    return ycbcr_to_rgb(result)


def taa(color, gbuffer, camera, state):
    """Full TAA pass; returns (resolved color, state). The resolved image
    is written into state.history in place."""
    motion = reproject(gbuffer, camera)
    if state.history_valid:
        out = taa_resolve(color, state.history, motion)
    else:
        out = color
    state.history.copy_(out)
    state.history_valid = True
    return state.history, state
