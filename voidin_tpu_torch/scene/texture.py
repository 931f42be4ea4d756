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

On the device the pool is that quad table alone, 32 B a texel
(``pool_device_bytes``), and every tap is ``sample_trilinear``: one quad
row per sample. Left out (the JAX package keeps them): the 4x4 tap-block
tables of its quad-rate albedo tap (128 B more a texel, whose words the
per-pixel tap gives) and the 16 B split twins, both gather layouts of the
TPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import checks

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


def pool_device_bytes(n_textures: int, pool_size: int) -> int:
    """Device bytes of the pool's table for `n_textures` slots at pool
    size S=`pool_size`: one 32 B quad row per texel over the flattened
    mip chain (sum of s^2 over the mips, ~(4/3) S^2 rows), so ~44.7 MB a
    slot at S=1024."""
    total_rows = sum(s * s for s in _mip_sizes(pool_size))
    return n_textures * total_rows * 32


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

    def device(self, device="cuda") -> TexturePoolData:
        """The pool on `device` (the card unless the caller asks for
        another)."""
        return pool_from_numpy(self.host_arrays(), device)

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


def pool_from_numpy(h: dict, device) -> TexturePoolData:
    """Device pool from its host arrays (TEXTURE_LEAVES; other keys are
    ignored). The pow2 base size follows from the per-texture row count:
    total = (4 S^2 - 1) / 3."""
    T = h["size"].shape[0]
    total = h["quads"].shape[0] // T
    base = int(round(np.sqrt((3 * total + 1) / 4)))
    assert (4 * base * base - 1) // 3 == total, (base, total)
    return TexturePoolData(
        quads=torch.as_tensor(np.array(h["quads"]),
                              device=device),
        size=torch.as_tensor(np.array(h["size"], np.int32), device=device),
        max_lod=torch.as_tensor(np.array(h["max_lod"], np.float32),
                                device=device),
        srgb=torch.as_tensor(np.array(h["srgb"], bool), device=device),
        base_size=base,
        total=total,
    )


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
    # post-filter sRGB decode of rgb
    if srgb is None:
        decode = pool.srgb[tex_id.to(torch.int64)][..., None]
        rgb = torch.where(decode, srgb_to_linear_t(raw[..., :3]),
                          raw[..., :3])
    elif srgb:
        rgb = srgb_to_linear_t(raw[..., :3])
    else:
        rgb = raw[..., :3]
    return torch.cat([rgb, raw[..., 3:4]], dim=-1)


def _quad_lerp(q, base, tx, ty):
    """The bilinear sample of the quad at columns base: base + 16 of
    quad rows q (..., 32) f32."""
    c00, c10, c01, c11 = (q[..., base + 4 * k: base + 4 * k + 4]
                          for k in range(4))
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty
