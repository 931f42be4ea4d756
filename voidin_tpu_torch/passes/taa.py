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

The history fetch, by RasterConfig field as in the JAX package: per pixel
from the f16 history_quads table (the default), by quad blocks
(taa_quad_history: one f16 4x4 block row per 2x2 output quad, edge quads
through a compacted batch; taa_quad_where picks the JAX package's
where-chain select over its one-hot einsum, whose words differ on -0.0
and non-finite texels), or from each pixel's 5x5 window (taa_inwindow,
fast movers per 8x8 block through a compacted batch). Each gives the
default fetch's words while its batch holds (the einsum select aside).

The default fetch on the whole image (takes_taa_kernel) runs as one
launch of ops/taa.py taa_resolve_fused on the card, with the chain's
words; its twin on the CPU is this module's chain (taa_fused_reference).
The quad-block and in-window fetches keep the eager chain.

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
from ..framework import profiler
from ..ops import taa as taa_op
from .gbuffer import GBuffer
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


# the 3x3 neighbourhood of taa_resolve in its order (rows, then columns):
# (dy, dx, Gaussian weight, Mitchell-Netravali weight), Python floats
NEIGHBOURHOOD = tuple(
    (dy, dx, float(np.exp(-3.0 * (dx * dx + dy * dy) / 4.0)),
     _mitchell_weight_np(np.sqrt(dx * dx + dy * dy)))
    for dy in (-1, 0, 1) for dx in (-1, 0, 1))


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


def _history_coords(u, v, H, W):
    """(x0i, y0i, tx, ty) of normalized history uv on an (H, W) image:
    the clamped floor texel (i64) and the lerp weights (..., 1)."""
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.clamp(torch.nan_to_num(x0), 0, W - 1).to(torch.int64)
    y0i = torch.clamp(torch.nan_to_num(y0), 0, H - 1).to(torch.int64)
    return x0i, y0i, tx, ty


def _lerp(c00, c10, c01, c11, tx, ty):
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def _bilinear_clamp(img, u, v, quads=None):
    """Bilinear sample of (H, W, C) at normalized uv (clamp-to-edge) from
    its history_quads table (`quads`, built here when not given)."""
    H, W, C = img.shape
    if quads is None:
        quads = history_quads(img)
    x0i, y0i, tx, ty = _history_coords(u, v, H, W)
    q = quads[y0i * W + x0i].to(torch.float32)
    return _lerp(q[..., :C], q[..., C: 2 * C], q[..., 2 * C: 3 * C],
                 q[..., 3 * C:], tx, ty)


def _einsum_select(blk, k):
    """The corners that the JAX package's default quad-block select gives:
    a one-hot einsum of each quad's f16 4x4 block (blk (Q, 16, C)) into
    f32, at the block texels k (Q, n). The einsum adds the 15 other
    texels times 0 to the selected one, so the selected value comes out
    +0.0 for -0.0, and NaN wherever another texel of its channel in the
    block is not finite (0 * inf, 0 * NaN). Those rules applied to the
    block, then an index gather: no matmul, whose TF32 would round."""
    b = blk.to(torch.float32)
    bad = ~torch.isfinite(b)
    n_bad = bad.sum(dim=1, keepdim=True)
    b = torch.where(n_bad - bad.to(n_bad.dtype) > 0, float("nan"), b + 0.0)
    return torch.gather(b, 1, k[..., None].expand(k.shape + (b.shape[2],)))


def _bilinear_clamp_quadblock(img, u, v, capacity=0, select="einsum"):
    """_bilinear_clamp by quad blocks (RasterConfig.taa_quad_history; H
    and W even): the history coordinates of a 2x2 output quad land within
    a texel or two of each other, so one f16 4x4-texel block row of the
    history (the (H * W, 16 C) block table, clamp-to-edge, built from one
    edge-padded copy) at the quad's min floor texel serves its four
    pixels when their floor coordinates spread by 2 or less. Each pixel
    takes its corners from the block by an index gather, under `select`:
    "where" gives the selected f16 texel (the words of the default
    fetch), "einsum" the JAX package's one-hot einsum's words
    (_einsum_select). Quads that spread wider go through a compacted
    per-pixel batch of `capacity` quads (0: max(Hq * Wq // 4, 1024)),
    ascending, each pixel reading columns 0, C, 4C and 5C of its own block
    row; a quad beyond the batch keeps its block value. Returns (samples
    (H, W, C), the edge quads beyond capacity)."""
    H, W, C = img.shape
    Hq, Wq = H // 2, W // 2
    dev = img.device
    imgh = img.to(torch.float16)
    ys = torch.clamp(torch.arange(H + 3, device=dev), max=H - 1)
    xs = torch.clamp(torch.arange(W + 3, device=dev), max=W - 1)
    padded = imgh[ys][:, xs]
    # the 4x4 windows as a view, written once: texel (dy, dx) of a row at
    # columns (4 dy + dx) C
    blocks = padded.unfold(0, 4, 1).unfold(1, 4, 1).permute(
        0, 1, 3, 4, 2).reshape(H * W, 16 * C)
    x0i, y0i, tx, ty = _history_coords(u, v, H, W)

    def q4(a):  # (H, W) -> (Hq, Wq, 4), pixels (0,0) (0,1) (1,0) (1,1)
        return a.reshape(Hq, 2, Wq, 2).permute(0, 2, 1, 3).reshape(
            Hq, Wq, 4)

    x4, y4 = q4(x0i), q4(y0i)
    bx = x4.amin(dim=-1)
    by = y4.amin(dim=-1)
    ok = (x4.amax(dim=-1) - bx <= 2) & (y4.amax(dim=-1) - by <= 2)
    ox = torch.clamp(x4 - bx[..., None], 0, 2)
    oy = torch.clamp(y4 - by[..., None], 0, 2)
    # each pixel's corners (0,0) (0,1) (1,0) (1,1) as block texels
    k = ((oy * 4 + ox)[..., None]
         + torch.tensor([0, 1, 4, 5], device=dev)).reshape(Hq * Wq, 16)
    blk = blocks[(by * W + bx).reshape(-1)].reshape(Hq * Wq, 16, C)
    if select == "where":
        c = torch.gather(blk, 1, k[..., None].expand(Hq * Wq, 16, C)).to(
            torch.float32)
    else:
        c = _einsum_select(blk, k)
    c = c.reshape(Hq, Wq, 2, 2, 4, C).permute(0, 2, 1, 3, 4, 5).reshape(
        H, W, 4, C)
    out = _lerp(c[:, :, 0], c[:, :, 1], c[:, :, 2], c[:, :, 3], tx, ty)

    # edge quads: each pixel's own block row, scattered back
    F = capacity or max(Hq * Wq // 4, 1024)
    flat = (~ok).reshape(-1)
    count = flat.sum()
    qidx = fastmath.compact_indices(flat, F)
    valid = torch.arange(F, device=dev) < torch.clamp(count, max=F)
    qy = qidx // Wq
    qx = qidx - qy * Wq
    py = torch.cat([qy * 2, qy * 2, qy * 2 + 1, qy * 2 + 1])
    px = torch.cat([qx * 2, qx * 2 + 1, qx * 2, qx * 2 + 1])
    pix = py * W + px  # (4F,)
    qe = blocks[y0i.reshape(-1)[pix] * W + x0i.reshape(-1)[pix]]
    e = qe.reshape(-1, 16, C)[:, [0, 1, 4, 5]].to(torch.float32)
    vals = _lerp(e[:, 0], e[:, 1], e[:, 2], e[:, 3],
                 tx.reshape(-1, 1)[pix], ty.reshape(-1, 1)[pix])
    widx = torch.where(valid.repeat(4), pix, H * W)
    out = fastmath.scatter_rows(out, widx, vals)
    return out, torch.clamp(count - F, min=0)


def _bilinear_clamp_inwindow(img, u, v, capacity=0, quads=None):
    """_bilinear_clamp for near-static pixels (RasterConfig.taa_inwindow;
    H and W multiples of 8, else _bilinear_clamp with overflow 0): a pixel
    whose floor texel lies at offsets (ox, oy) in [-2, 1] of itself finds
    its bilinear corners in its own 5x5 clamp-shifted window, gathered
    from one edge-padded f16 copy of the history at (y + oy + d, x + ox +
    e), so no shifted copy is made. Pixels outside the window go by 8x8
    blocks through a compacted batch of `capacity` blocks (0: max(Hb * Wb
    // 8, 256)), ascending, each pixel gathering a 12 B record (its quad
    row's index as f32, tx, ty) and one f16 row of the history_quads table
    (`quads`, built here when not given). An offset outside the window
    reads the window's -2 texel, as the JAX package's where-chains do, so
    a block beyond the batch keeps that value. The words of
    _bilinear_clamp while the batch holds. Returns (samples (H, W, C),
    the blocks beyond capacity)."""
    H, W, C = img.shape
    dev = img.device
    if H % 8 or W % 8:
        return (_bilinear_clamp(img, u, v, quads),
                torch.zeros((), dtype=torch.int64, device=dev))
    x0i, y0i, tx, ty = _history_coords(u, v, H, W)
    px = torch.arange(W, device=dev)[None, :]
    py = torch.arange(H, device=dev)[:, None]
    ox = x0i - px
    oy = y0i - py
    kx = torch.where((ox >= -1) & (ox <= 1), ox, -2)
    ky = torch.where((oy >= -1) & (oy <= 1), oy, -2)
    ys = torch.clamp(torch.arange(-2, H + 2, device=dev), 0, H - 1)
    xs = torch.clamp(torch.arange(-2, W + 2, device=dev), 0, W - 1)
    padded = img.to(torch.float16)[ys][:, xs].reshape(-1, C)
    at = (py + 2 + ky) * (W + 4) + px + 2 + kx  # corner (0, 0)
    c = [padded[at + d * (W + 4) + e].to(torch.float32)
         for d in (0, 1) for e in (0, 1)]
    out = _lerp(c[0], c[1], c[2], c[3], tx, ty)

    # 8x8-block fallback for the pixels outside their window
    Hb, Wb = H // 8, W // 8
    bad = (ox < -2) | (ox > 1) | (oy < -2) | (oy > 1)
    bad_blk = bad.reshape(Hb, 8, Wb, 8).any(dim=3).any(dim=1).reshape(-1)
    count = bad_blk.sum()
    F = capacity or max(Hb * Wb // 8, 256)
    bidx = fastmath.compact_indices(bad_blk, F)
    valid = torch.arange(F, device=dev) < torch.clamp(count, max=F)
    by = bidx // Wb
    bx = bidx - by * Wb
    r8 = torch.arange(8, device=dev)
    pix = ((by[:, None, None] * 8 + r8[None, :, None]) * W
           + bx[:, None, None] * 8 + r8[None, None, :]).reshape(-1)
    valid64 = valid.repeat_interleave(64)
    pix = torch.where(valid64, pix, 0)
    if quads is None:
        quads = history_quads(img)
    rec = torch.cat([(y0i * W + x0i).to(torch.float32)[..., None], tx, ty],
                    dim=-1).reshape(H * W, 3)
    r = rec[pix]
    q = quads[r[:, 0].to(torch.int64)].to(torch.float32)
    vals = _lerp(q[:, :C], q[:, C: 2 * C], q[:, 2 * C: 3 * C], q[:, 3 * C:],
                 r[:, 1:2], r[:, 2:3])
    widx = torch.where(valid64, pix, H * W)
    out = fastmath.scatter_rows(out, widx, vals)
    return out, torch.clamp(count - F, min=0)


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


def taa_resolve(color, history, motion, row0: int = 0, quads=None,
                quad_history=False, edge_capacity=0, inwindow=False,
                block_capacity=0, quad_select="einsum"):
    """taa.wgsl:45-103. color/motion: (H, W, 3); history: the whole (H',
    W, 3) image. `row0`: color and motion hold image rows [row0, row0 +
    H) of the history's image (a window of the sharded frame; its first
    and last rows are exact only at the image's edges); `quads`: the
    history's history_quads table, built here when not given. The history
    fetch: `quad_history` (even H and W, the whole image) by quad blocks
    with `edge_capacity` and `quad_select` (_bilinear_clamp_quadblock),
    else `inwindow` (the whole image) from each pixel's window with
    `block_capacity` (_bilinear_clamp_inwindow), else per pixel. Returns
    (resolved, the fetch's overflow: 0 on the per-pixel fetch)."""
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
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    with profiler.scope("taa.history"):
        if quad_history and H % 2 == 0 and W % 2 == 0:
            hist_rgb, overflow = _bilinear_clamp_quadblock(
                history, hist_u, hist_v, capacity=edge_capacity,
                select=quad_select)
        elif inwindow:
            hist_rgb, overflow = _bilinear_clamp_inwindow(
                history, hist_u, hist_v, capacity=block_capacity, quads=quads)
        else:
            hist_rgb = _bilinear_clamp(history, hist_u, hist_v, quads)
    with profiler.scope("taa.resolve"):
        hist = rgb_to_ycbcr(hist_rgb)

        vsum = torch.zeros_like(color)
        vsum2 = torch.zeros_like(color)
        wsum = 0.0
        mn_sum = torch.zeros_like(color)
        mn_wsum = 0.0
        for dy, dx, w, wt in NEIGHBOURHOOD:
            shifted = _shift(color, dy, dx)
            neigh = rgb_to_ycbcr(shifted)
            vsum = vsum + neigh * w
            vsum2 = vsum2 + neigh * neigh * w
            wsum += w
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

        box_size = 1.0 * (0.5 + 0.5 * _smoothstep(-0.1, 0.3,
                                                  local_contrast))
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
            (hist[..., 0] - nmin[..., 0]).abs(),
            (hist[..., 0] - nmax[..., 0]).abs()
        ) / torch.clamp(torch.maximum(hist[..., 0], ex[..., 0]), min=1e-5)
        blend = blend * (0.2 + 0.8 * _smoothstep(0.0, 2.0, clamp_dist))
        result = clamped + (center - clamped) * blend[..., None]
        return ycbcr_to_rgb(result), overflow


def taa_fused_reference(color, depth, history, camera):
    """The plain twin of ops/taa.py taa_resolve_fused: reproject ->
    taa_resolve with the per-pixel fetch, the chain itself."""
    with profiler.scope("taa.reproject"):
        motion = reproject(GBuffer(normal_uv=None, material=None,
                                   depth=depth), camera)
    return taa_resolve(color, history, motion)[0]


def takes_taa_kernel(quad_history: bool, inwindow: bool) -> bool:
    """Whether taa() resolves through the one-launch TAA (ops/taa.py
    taa_resolve_fused): a static test of the fetch options. The
    quad-block and in-window fetches keep the eager chain, whose
    compacted batches and overflow counts are their own."""
    return not (quad_history or inwindow)


@profiler.scoped("taa")
def taa(color, gbuffer, camera, state, quad_history=False, edge_capacity=0,
        inwindow=False, block_capacity=0, quad_select="einsum"):
    """Full TAA pass; returns (resolved color, state, the history fetch's
    overflow). The resolved image is written into state.history in place.
    The fetch options are taa_resolve's. The first frame reads no history
    (it seeds it with the frame): it launches nothing, and its overflow
    is 0.

    The default fetch (takes_taa_kernel) resolves in one launch of
    ops/taa.py taa_resolve_fused (the profiler's scope taa.kernel), with
    the chain's words; the profiler's counters taa.kernel_px and
    taa.eager_px count the pixels each way resolved."""
    H, W = color.shape[:2]
    overflow = torch.zeros((), dtype=torch.int64, device=color.device)
    if not state.history_valid:
        out = color
    elif takes_taa_kernel(quad_history, inwindow):
        profiler.count("taa.kernel_px", H * W)
        with profiler.scope("taa.kernel"):
            out = taa_op.taa_resolve_fused(
                color, gbuffer.depth, state.history, camera,
                weights=NEIGHBOURHOOD, twin=taa_fused_reference)
    else:
        with profiler.scope("taa.reproject"):
            motion = reproject(gbuffer, camera)
        profiler.count("taa.eager_px", H * W)
        out, overflow = taa_resolve(
            color, state.history, motion, quad_history=quad_history,
            edge_capacity=edge_capacity, inwindow=inwindow,
            block_capacity=block_capacity, quad_select=quad_select)
    state.history.copy_(out)
    state.history_valid = True
    profiler.count("overflow.taa", overflow)
    return state.history, state, overflow
