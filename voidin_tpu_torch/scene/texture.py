"""Bindless-style texture pool — texel-quad packed.

Host pool + device sampler, the counterpart of ``voidin_tpu/scene/texture.py``
limited to what the north-star frame uses. Layout: every texel stores its
2x2 bilinear neighborhood (RGBA8 x [c00, c10, c01, c11]) plus the same quad
of the parent level resampled at this level's texel centers — one 32 B row
per trilinear sample, wrap addressing baked in. All mip levels of all
textures live in one flattened row axis:
row(t, level, y0, x0) = t * TOTAL + level_offset[level] + y0 * stride + x0.
Texels stay in their source encoding; sRGB decode runs after filtering.
Sampler semantics follow the reference default sampler (app.rs:43-56):
repeat addressing, bilinear filtering, linear mip blending.

The pool packs each texture on the host through the native C++ packer
(``native.pack_texture``, the JAX package's default; its deepest mip words
follow its float32 accumulation) and, where the library is unavailable or
``VOIDIN_NATIVE=0``, through numpy (``_pack_numpy``, within a few u8 steps
of it, equal in each level's own texels at mip levels 0-3).

With ``blocks`` (the default of ``TexturePool.device`` and
``World.device(tap_blocks=)``, as in the JAX package) the pool also holds
the 4x4 tap-block tables that the quad-rate albedo tap
(``sample_trilinear_quadblock``, RasterConfig.tap_block) reads: each
texel's wrap-baked 4x4 neighbourhood of its level and of the resampled
parent, derived on the device from the uploaded quad table. They add
128 B to each texel's 32 B quad row: 5x the pool's bytes. Left out (the
TPU package keeps them): the 16 B split twins, a layout of the TPU's
gather cliff that the JAX package leaves off below 2^62 rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import checks, fastmath

WHITE_TEXTURE = 0
BLACK_TEXTURE = 1
MAX_TEXTURES = 1024

_SRGB_BREAK = 0.04045


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Final blit encode (blit.wgsl)."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * torch.clamp(c, min=1e-10) ** (1 / 2.4) - 0.055,
    )


def srgb_to_linear_t(c: torch.Tensor) -> torch.Tensor:
    return torch.where(
        c <= _SRGB_BREAK, c / 12.92, ((c + 0.055) / 1.055) ** 2.4
    )


def _mip_sizes(base: int) -> List[int]:
    sizes = [base]
    while sizes[-1] > 1:
        sizes.append(sizes[-1] // 2)
    return sizes


def pool_device_bytes(n_textures: int, pool_size: int,
                      blocks: bool = False) -> int:
    """Device bytes of the pool's tables for `n_textures` slots at pool
    size S=`pool_size`: one 32 B quad row per texel over the flattened
    mip chain (sum of s^2 over the mips, ~(4/3) S^2 rows), so ~44.7 MB a
    slot at S=1024, and 5x that with `blocks` (the two 64 B tap-block
    rows a texel: 160 B). The JAX function counts the blocks as 3x, two
    64 B rows short of the tables its TexturePool.device() builds. The
    port builds no 16 B split twins (the JAX function doubles for them
    only from 2^62 rows)."""
    total_rows = sum(s * s for s in _mip_sizes(pool_size))
    return n_textures * total_rows * (160 if blocks else 32)


def _downsample2x2(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    if h == 1 and w == 1:
        return img
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h > 1 and w > 1:
        return img[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, -1).mean(
            axis=(1, 3)
        )
    if h == 1:
        return img[:, : nw * 2].reshape(1, nw, 2, -1).mean(axis=2)
    return img[: nh * 2].reshape(nh, 2, 1, -1).mean(axis=1)


def _upsample_to_child(parent: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """Bilinearly sample the parent level at this level's texel centers."""
    ph, pw = parent.shape[:2]
    if ph == ch and pw == cw:
        return parent
    py = np.clip((np.arange(ch) + 0.5) * ph / ch - 0.5, 0, ph - 1)
    px = np.clip((np.arange(cw) + 0.5) * pw / cw - 0.5, 0, pw - 1)
    y0 = np.floor(py).astype(int)
    x0 = np.floor(px).astype(int)
    y1 = np.minimum(y0 + 1, ph - 1)
    x1 = np.minimum(x0 + 1, pw - 1)
    ty = (py - y0)[:, None, None]
    tx = (px - x0)[None, :, None]
    a = parent[y0][:, x0] * (1 - tx) + parent[y0][:, x1] * tx
    b = parent[y1][:, x0] * (1 - tx) + parent[y1][:, x1] * tx
    return a * (1 - ty) + b * ty


def _quad_rows(img: np.ndarray, wrap: bool) -> np.ndarray:
    """(h, w, 4) -> (h, w, 16): each texel's 2x2 neighborhood, edge-baked."""
    if wrap:
        xn = np.roll(img, -1, axis=1)
        yn = np.roll(img, -1, axis=0)
        xyn = np.roll(xn, -1, axis=0)
    else:
        xn = np.concatenate([img[:, 1:], img[:, -1:]], axis=1)
        yn = np.concatenate([img[1:], img[-1:]], axis=0)
        xyn = np.concatenate([xn[1:], xn[-1:]], axis=0)
    return np.concatenate([img, xn, yn, xyn], axis=-1)


@dataclasses.dataclass
class TexturePoolData:
    quads: torch.Tensor  # (T * TOTAL, 32) uint8
    size: torch.Tensor  # (T, 2) i32 (w, h) at level 0
    max_lod: torch.Tensor  # (T,) f32
    srgb: torch.Tensor  # (T,) bool — decode rgb after filtering
    # (T * TOTAL, 64) uint8: the texel's 4x4 wrap-baked neighbourhood of
    # its level (child) and of the resampled parent, 16 RGBA texels in
    # row-major order (block_tables); None for a pool built without them
    child_blocks: Optional[torch.Tensor] = None
    parent_blocks: Optional[torch.Tensor] = None
    base_size: int = 0
    total: int = 0

    @property
    def count(self) -> int:
        return self.size.shape[0]


TEXTURE_LEAVES = ("quads", "size", "max_lod", "srgb")


class TexturePool:
    def __init__(self, base_size: int = 1024):
        assert base_size & (base_size - 1) == 0
        self.base_size = base_size
        self.images: List[np.ndarray] = []  # u8 (h, w, 4), source encoding
        self.srgb_flags: List[bool] = []
        white = np.full((1, 1, 4), 255, np.uint8)
        black = np.zeros((1, 1, 4), np.uint8)
        black[..., 3] = 255
        # Reserved ids (texture.rs:10-13); the LTC slots are placeholders.
        for img in (white, black, white.copy(), white.copy()):
            self.images.append(img)
            self.srgb_flags.append(False)

    def __len__(self):
        return len(self.images)

    def has_mask(self, tex_id: int) -> bool:
        """Any texel with alpha below the 0.5 cutoff (visibility.wgsl:80)."""
        return bool((self.images[tex_id][..., 3] < 128).any())

    def is_const(self, tex_id: int) -> bool:
        """1x1 texture: any sample returns its single texel."""
        return self.images[tex_id].shape[:2] == (1, 1)

    def const_value(self, tex_id: int) -> np.ndarray:
        """(4,) linear-space value of a 1x1 texture (zeros if not 1x1)."""
        if not self.is_const(tex_id):
            return np.zeros(4, np.float32)
        v = self.images[tex_id][0, 0].astype(np.float32) / 255.0
        if self.srgb_flags[tex_id]:
            c = v[:3]
            v = np.concatenate(
                [
                    np.where(c <= _SRGB_BREAK, c / 12.92,
                             ((c + 0.055) / 1.055) ** 2.4),
                    v[3:4],
                ]
            )
        return v.astype(np.float32)

    def add(self, image: np.ndarray, srgb: bool = False) -> int:
        """Add an (H, W, C) uint8/float image; returns its texture id."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (
                np.clip(img.astype(np.float32), 0.0, 1.0) * 255.0 + 0.5
            ).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full_like(img[..., :1], 255)], axis=-1
            )
        while img.shape[0] > self.base_size or img.shape[1] > self.base_size:
            img = _downsample2x2(img.astype(np.float32)).astype(np.uint8)
        if len(self.images) >= MAX_TEXTURES:
            raise ValueError("texture pool full")
        self.images.append(np.ascontiguousarray(img))
        self.srgb_flags.append(bool(srgb))
        return len(self.images) - 1

    def device(self, device="cuda", blocks: bool = True) -> TexturePoolData:
        """The pool on `device` (the card unless the caller asks for
        another); `blocks` also derives the tap-block tables there (5x
        the pool's bytes; the albedo tap takes its per-pixel rows
        without them)."""
        return pool_from_numpy(self.host_arrays(), device, blocks=blocks)

    def host_arrays(self) -> dict:
        """Packed quad table + metadata as numpy (the device leaves). Each
        texture goes through the native packer (native.pack_texture) and,
        where the library is unavailable, through _pack_numpy, as JAX's
        TexturePool.device does."""
        from .. import native

        # Size the pool to the largest actual texture (pow2).
        largest = max(max(i.shape[0], i.shape[1]) for i in self.images)
        S = 1
        while S < largest:
            S *= 2
        S = min(S, self.base_size)
        sizes = _mip_sizes(S)
        total = int(sum(s * s for s in sizes))
        T = len(self.images)
        quads = np.zeros((T, total, 32), np.uint8)
        wh = np.zeros((T, 2), np.int32)
        max_lod = np.zeros(T, np.float32)
        for t, img in enumerate(self.images):
            h, w = img.shape[:2]
            wh[t] = (w, h)
            max_lod[t] = max(0, int(np.floor(np.log2(max(min(w, h), 1)))))
            packed = native.pack_texture(img, S, total)
            quads[t] = packed if packed is not None else _pack_numpy(img, S)
        return dict(
            quads=quads.reshape(T * total, 32),
            size=wh,
            max_lod=max_lod,
            srgb=np.asarray(self.srgb_flags, bool),
        )


def _pack_numpy(img: np.ndarray, base: int) -> np.ndarray:
    """The numpy packer: one (h, w, 4) u8 texture's texel-quad mip chain as
    (total, 32) u8 rows at pool size `base` (the fallback of
    native.pack_texture)."""
    sizes = _mip_sizes(base)
    offsets = np.cumsum([0] + [s * s for s in sizes])[:-1]
    out = np.zeros((int(sum(s * s for s in sizes)), 32), np.uint8)
    levels = [img.astype(np.float32)]
    while min(levels[-1].shape[0], levels[-1].shape[1]) > 1:
        levels.append(_downsample2x2(levels[-1]))
    for li, s in enumerate(sizes):
        if li >= len(levels):
            # propagate the 1x1 tail
            out[offsets[li]: offsets[li] + s * s] = out[offsets[li - 1]]
            continue
        level = levels[li]
        lh, lw = level.shape[:2]
        parent = levels[min(li + 1, len(levels) - 1)]
        par_rs = _upsample_to_child(parent, lh, lw)
        lvl_u8 = (level + 0.5).astype(np.uint8)
        par_u8 = (par_rs + 0.5).astype(np.uint8)
        q = np.concatenate(
            [_quad_rows(lvl_u8, wrap=True), _quad_rows(par_u8, wrap=True)],
            axis=-1,
        )
        block = out[offsets[li]: offsets[li] + s * s].reshape(s, s, 32)
        block[:lh, :lw] = q[:s, :s]
    return out


def pool_from_numpy(h: dict, device, blocks: bool = False
                    ) -> TexturePoolData:
    """Device pool from its host arrays. The pow2 base size follows from
    the per-texture row count: total = (4 S^2 - 1) / 3. The tap-block
    tables come from `h` where it holds them (the leaves of a JAX pool),
    else, with `blocks`, from block_tables on the device."""
    T = h["size"].shape[0]
    total = h["quads"].shape[0] // T
    base = int(round(np.sqrt((3 * total + 1) / 4)))
    assert (4 * base * base - 1) // 3 == total, (base, total)
    pool = TexturePoolData(
        quads=torch.as_tensor(np.array(h["quads"]),
                              device=device),
        size=torch.as_tensor(np.array(h["size"], np.int32), device=device),
        max_lod=torch.as_tensor(np.array(h["max_lod"], np.float32),
                                device=device),
        srgb=torch.as_tensor(np.array(h["srgb"], bool), device=device),
        base_size=base,
        total=total,
    )
    if h.get("child_blocks") is not None:
        pool.child_blocks, pool.parent_blocks = (
            torch.as_tensor(np.array(h[k]), device=device)
            for k in ("child_blocks", "parent_blocks"))
    elif blocks:
        pool.child_blocks, pool.parent_blocks = block_tables(pool)
    return pool


# Texels a gather of block_tables covers at most (its int64 index is 8 B
# a texel): a level larger than this across the pool goes in chunks of
# textures, so the derivation's scratch stays below ~0.5 GB.
_BLOCK_CHUNK = 1 << 22


def block_tables(pool: TexturePoolData):
    """(child_blocks, parent_blocks) of a pool, each (T * TOTAL, 64)
    uint8: at a texel's row the 4x4 texels from it, texel (j, i) (j rows
    down, i columns across) at bytes 16 j + 4 i, of its level (corner c00
    of the quad rows, bytes 0:4) and of the resampled parent (bytes
    16:20), wrapped over the texture's own (lh, lw) at that level, never
    over the padded s x s; rows outside the level's texels stay 0.
    Derived from the quad table as the JAX package derives them at
    TexturePool.device(), so either packer's pool gets its own tables:
    index arithmetic and one gather per level (per chunk of textures on
    a large level) on the pool's device."""
    T, total, S = pool.count, pool.total, pool.base_size
    dev = pool.quads.device
    # each RGBA texel as one int32 word: [child, parent] per quad row
    texel = pool.quads.reshape(T * total, 32)[
        :, [0, 1, 2, 3, 16, 17, 18, 19]].contiguous().view(torch.int32)
    child = torch.zeros(T, total, 16, dtype=torch.int32, device=dev)
    parent = torch.zeros_like(child)
    size = pool.size.to(torch.int64)
    k4 = torch.arange(4, device=dev)
    off = 0
    for li, s in enumerate(_mip_sizes(S)):
        r = torch.arange(s, device=dev)[None, :, None]
        step = max(1, _BLOCK_CHUNK // (s * s * 16))
        for t0 in range(0, T, step):
            t = torch.arange(t0, min(T, t0 + step), device=dev)
            lw = torch.clamp(size[t, 0] >> li, min=1)[:, None, None]
            lh = torch.clamp(size[t, 1] >> li, min=1)[:, None, None]
            ys = (r + k4) % lh  # (n, s, 4): rows y + j, wrapped
            xs = (r + k4) % lw  # (n, s, 4): columns x + i, wrapped
            idx = (t[:, None, None, None, None] * total + off
                   + ys[:, :, None, :, None] * s + xs[:, None, :, None, :])
            valid = ((r < lh)[:, :, None, :] & (r < lw)[:, None, :, :]
                     )[..., None]
            rows = texel[idx.reshape(-1)].reshape(len(t), s * s, 16, 2)
            valid = valid.reshape(len(t), s * s, 1, 1)
            rows = torch.where(valid, rows, 0)
            child[t0:t0 + len(t), off:off + s * s] = rows[..., 0]
            parent[t0:t0 + len(t), off:off + s * s] = rows[..., 1]
        off += s * s
    return (child.view(torch.uint8).reshape(T * total, 64),
            parent.view(torch.uint8).reshape(T * total, 64))


# ---------------------------------------------------------------------------
# Device-side sampling
# ---------------------------------------------------------------------------


def _level_offset_closed(base_size: int, level):
    """Row offset of mip `level`: (4/3) (S^2 - (S >> l)^2) for pow2 S."""
    sl = torch.clamp(base_size >> level, min=1)
    return (4 * (base_size * base_size - sl * sl)) // 3


def derived_max_lod(w, h):
    """floor(log2(min(w, h))) with the +0.5 nudge that makes it exact."""
    m = torch.minimum(w, h).to(torch.float32)
    return torch.floor(torch.log2(torch.clamp(m, min=1.0) + 0.5))


def _bilinear_level(pool: TexturePoolData, tex_id, uv, level, lod_frac, wh):
    """One quad-row trilinear sample of a per-sample mip level: bilinear
    in the level, blended by `lod_frac` toward the parent-resampled quad
    of the same 32 B row. Returns raw (source-encoded) color in [0, 1]."""
    tex_id = tex_id.to(torch.int64)
    w0, h0 = wh
    lw = torch.clamp(w0.to(torch.int64) >> level, min=1)
    lh = torch.clamp(h0.to(torch.int64) >> level, min=1)
    stride = torch.clamp(pool.base_size >> level, min=1)
    off = _level_offset_closed(pool.base_size, level)

    fx = uv[..., 0] * lw.to(torch.float32) - 0.5
    fy = uv[..., 1] * lh.to(torch.float32) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), lw)
    y0i = torch.remainder(y0.to(torch.int64), lh)

    idx = tex_id * pool.total + off + y0i * stride + x0i
    idx = checks.check_index(idx, pool.quads.shape[0], "texture.quads")

    scale = float(np.float32(1.0 / 255.0))
    q = pool.quads[idx].to(torch.float32) * scale  # (..., 32)
    child = _quad_lerp(q, 0, tx, ty)
    parent = _quad_lerp(q, 16, tx, ty)
    return child + (parent - child) * lod_frac[..., None]


def sample_trilinear(pool: TexturePoolData, tex_id, uv, lod, wh=None,
                     srgb: Optional[bool] = None):
    """Trilinear texture sample with repeat wrap; returns linear-space
    (..., 4). `wh`: the level-0 (w, h) per sample when the caller holds
    it; `srgb`: a static flag shared by every texture the call site can
    touch (None = per-sample flag lookup)."""
    if wh is None:
        whg = pool.size[tex_id.to(torch.int64)]
        wh = (whg[..., 0], whg[..., 1])
    lod = torch.minimum(torch.clamp(lod, min=0.0), derived_max_lod(*wh))
    l0 = torch.floor(lod)
    raw = _bilinear_level(pool, tex_id, uv, l0.to(torch.int64),
                          lod_frac=lod - l0, wh=wh)
    return _srgb_decode(pool, tex_id, raw, srgb)


def _srgb_decode(pool: TexturePoolData, tex_id, raw, srgb):
    """Post-filter sRGB decode of raw (..., 4) rgb: per-sample flags
    (`srgb` None) or the call site's static flag."""
    if srgb is None:
        decode = pool.srgb[tex_id.to(torch.int64)][..., None]
        rgb = torch.where(decode, srgb_to_linear_t(raw[..., :3]),
                          raw[..., :3])
    elif srgb:
        rgb = srgb_to_linear_t(raw[..., :3])
    else:
        rgb = raw[..., :3]
    return torch.cat([rgb, raw[..., 3:4]], dim=-1)


def _lerp_corners(c00, c10, c01, c11, tx, ty):
    """The bilinear lerp of a texel quad's corners, in the order of every
    tap of the pool."""
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def _quad_lerp(q, base, tx, ty):
    """The bilinear sample of the quad at columns base: base + 16 of
    quad rows q (..., 32) f32."""
    return _lerp_corners(q[..., base: base + 4], q[..., base + 4: base + 8],
                         q[..., base + 8: base + 12],
                         q[..., base + 12: base + 16], tx, ty)


def sample_trilinear_quadblock(pool: TexturePoolData, tex_id, uv, lod, wh,
                               srgb: Optional[bool] = None,
                               capacity: int = 0):
    """Quad-rate trilinear tap over an (H, W) pixel grid (H, W even;
    RasterConfig.tap_block): the 2x2 bilinear footprints of a 2x2 pixel
    quad lie within a few texels of each other at a proper mip level, so
    one child-block and one parent-block row (pool.child_blocks /
    parent_blocks, 64 B each) serve all four pixels: 2 rows a quad instead
    of 4. A quad is uniform when its four pixels share a texture and a
    level and their floor coordinates spread by 2 or less; each pixel then
    takes its corners from the block (an index gather; the JAX package's
    one-hot einsum over u8 / 255 values gives the same words). Other
    quads go through a compacted batch of `capacity` quads (0: max(Hq *
    Wq // 4, 1024)), ascending, whose pixels each gather one packed 16 B
    record (the quad-row index bit-cast to f32, tx, ty, frac) and one 32 B
    quad row, scattered back. The words of sample_trilinear(..., wh=wh,
    srgb=srgb) while the batch holds; a quad beyond it keeps the block
    path's value, as in the JAX package. The block index takes the anchor
    pixel's texture and level and the quad's min x and y, which are at
    most the anchor's own, so it lies in the anchor's level (held to the
    table under debug_bounds as "texture.blocks"). Returns (samples (H,
    W, 4) linear-space, the edge quads beyond capacity)."""
    H, W = lod.shape
    Hq, Wq = H // 2, W // 2
    dev = lod.device
    w0, h0 = wh
    lodc = torch.minimum(torch.clamp(lod, min=0.0), derived_max_lod(w0, h0))
    l0 = torch.floor(lodc)
    frac = lodc - l0
    level = l0.to(torch.int64)
    lw = torch.clamp(w0.to(torch.int64) >> level, min=1)
    lh = torch.clamp(h0.to(torch.int64) >> level, min=1)
    stride = torch.clamp(pool.base_size >> level, min=1)
    off = _level_offset_closed(pool.base_size, level)
    fx = uv[..., 0] * lw.to(torch.float32) - 0.5
    fy = uv[..., 1] * lh.to(torch.float32) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.remainder(x0.to(torch.int64), lw)
    y0i = torch.remainder(y0.to(torch.int64), lh)
    tid = tex_id.to(torch.int64)
    idx_img = tid * pool.total + off + y0i * stride + x0i  # per-pixel row

    def q4(a):  # (H, W) -> (Hq, Wq, 4), pixels (0,0) (0,1) (1,0) (1,1)
        return a.reshape(Hq, 2, Wq, 2).permute(0, 2, 1, 3).reshape(
            Hq, Wq, 4)

    tex4, lev4, x4, y4 = q4(tid), q4(level), q4(x0i), q4(y0i)
    bx = x4.amin(dim=-1)
    by = y4.amin(dim=-1)
    uniform = ((tex4 == tex4[..., :1]).all(dim=-1)
               & (lev4 == lev4[..., :1]).all(dim=-1)
               & (x4.amax(dim=-1) - bx <= 2) & (y4.amax(dim=-1) - by <= 2))
    bidx = (tex4[..., 0] * pool.total + q4(off)[..., 0]
            + by * q4(stride)[..., 0] + bx)
    # never past the anchor pixel's own row, so inside the anchor's level
    bidx = checks.check_index(bidx, pool.child_blocks.shape[0],
                              "texture.blocks")
    # each pixel's four corner texels in the block, as int32 words
    ox = torch.clamp(x4 - bx[..., None], 0, 2)
    oy = torch.clamp(y4 - by[..., None], 0, 2)
    k = ((oy * 4 + ox)[..., None]
         + torch.tensor([0, 1, 4, 5], device=dev)).reshape(Hq, Wq, 16)
    scale = float(np.float32(1.0 / 255.0))

    def corners(table):  # (H, W, 4 corners, 4) f32
        blk = table[bidx].view(torch.int32)  # (Hq, Wq, 16) texels
        c = torch.gather(blk, 2, k).view(torch.uint8).reshape(
            Hq, Wq, 2, 2, 4, 4).permute(0, 2, 1, 3, 4, 5).reshape(
            H, W, 4, 4)
        return c.to(torch.float32) * scale

    txe, tye = tx[..., None], ty[..., None]

    def bilin(c):
        return _lerp_corners(c[:, :, 0], c[:, :, 1], c[:, :, 2],
                             c[:, :, 3], txe, tye)

    child = bilin(corners(pool.child_blocks))
    parent = bilin(corners(pool.parent_blocks))
    raw = child + (parent - child) * frac[..., None]

    # edge quads: per-pixel 32 B quad rows, scattered back
    F = capacity or max(Hq * Wq // 4, 1024)
    flat = (~uniform).reshape(-1)
    count = flat.sum()
    qidx = fastmath.compact_indices(flat, F)
    valid = torch.arange(F, device=dev) < torch.clamp(count, max=F)
    qy = qidx // Wq
    qx = qidx - qy * Wq
    py = torch.cat([qy * 2, qy * 2, qy * 2 + 1, qy * 2 + 1])
    px = torch.cat([qx * 2, qx * 2 + 1, qx * 2, qx * 2 + 1])
    pix = py * W + px  # (4F,)
    # one packed 16 B record a pixel: the row index's bits, tx, ty, frac
    epack = torch.stack([idx_img.to(torch.int32), tx.view(torch.int32),
                         ty.view(torch.int32), frac.view(torch.int32)],
                        dim=-1).reshape(H * W, 4)
    eg = epack[pix]
    idx_e = checks.check_index(eg[:, 0], pool.quads.shape[0],
                               "texture.quads_edge").to(torch.int64)
    ef = eg.view(torch.float32)
    qrow = pool.quads[idx_e].to(torch.float32) * scale  # (4F, 32)

    ch_e = _quad_lerp(qrow, 0, ef[:, 1:2], ef[:, 2:3])
    vals = ch_e + (_quad_lerp(qrow, 16, ef[:, 1:2], ef[:, 2:3]) - ch_e) \
        * ef[:, 3:4]
    widx = torch.where(valid.repeat(4), pix, H * W)
    raw = fastmath.scatter_rows(raw, widx, vals)
    return (_srgb_decode(pool, tid, raw, srgb),
            torch.clamp(count - F, min=0))
