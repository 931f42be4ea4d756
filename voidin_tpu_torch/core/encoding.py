"""G-buffer bit packing: 32-bit octahedral normals and packed half-float UVs.

Torch counterpart of ``voidin_tpu/core/encoding.py`` (reference contract:
shaders/utils/encoding.wgsl:1-28 and the WGSL pack2x16float builtin).

Torch has no general-purpose uint32 arithmetic, so every u32 word in the
port travels as an int32 tensor holding the same 32 bits. ``as_u32_np``
turns such a tensor back into a numpy uint32 array.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fastmath

_PRES = 16
_MU = (1 << _PRES) - 1  # 65535


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same low 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def as_u32_np(t: torch.Tensor) -> np.ndarray:
    """int32-carried u32 tensor -> numpy uint32 (same bits)."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def encode_octahedral_32(normal: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 unit normals -> (...,) u32 bits as int32."""
    n = normal.to(torch.float32)
    denom = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    nor = n / denom[..., None]
    # Fold the lower hemisphere (WGSL sign(0) == 0, as torch.sign).
    folded_xy = (1.0 - nor[..., [1, 0]].abs()) * torch.sign(nor[..., :2])
    xy = torch.where((nor[..., 2] < 0.0)[..., None], folded_xy, nor[..., :2])
    v = xy * 0.5 + 0.5
    d = torch.floor(v * float(_MU) + 0.5).to(torch.int64) & 0xFFFFFFFF
    return wrap_i32(((d[..., 1] << _PRES) | d[..., 0]) & 0xFFFFFFFF)


def decode_octahedral_32(data: torch.Tensor) -> torch.Tensor:
    """(...,) u32 bits (int32) -> (..., 3) float32 unit normals."""
    data = data.to(torch.int64) & 0xFFFFFFFF
    d = torch.stack([data & _MU, (data >> _PRES) & _MU], dim=-1)
    v = d.to(torch.float32) / float(_MU)
    v = v * 2.0 - 1.0
    z = 1.0 - v[..., 0].abs() - v[..., 1].abs()
    t = torch.clamp(-z, min=0.0)
    x = v[..., 0] + torch.where(v[..., 0] > 0.0, -t, t)
    y = v[..., 1] + torch.where(v[..., 1] > 0.0, -t, t)
    nor = torch.stack([x, y, z], dim=-1)
    sq = nor * nor
    norm = fastmath.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    return nor / norm[..., None]


def pack2x16float(v: torch.Tensor) -> torch.Tensor:
    """(..., 2) float32 -> (...,) u32 bits (int32), f16 halves x low, y high."""
    bits = v.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return wrap_i32(bits[..., 0] | (bits[..., 1] << 16))


def unpack2x16float(p: torch.Tensor) -> torch.Tensor:
    """(...,) u32 bits (int32) -> (..., 2) float32."""
    p = p.to(torch.int64) & 0xFFFFFFFF
    lo = p & 0xFFFF
    hi = (p >> 16) & 0xFFFF
    bits = torch.stack([lo, hi], dim=-1)
    bits = torch.where(bits >= (1 << 15), bits - (1 << 16), bits)
    return bits.to(torch.int16).view(torch.float16).to(torch.float32)


def encode_octahedral_32_np(normal):
    """Numpy twin of encode_octahedral_32 (host-side pool packing)."""
    n = np.asarray(normal, np.float32)
    denom = np.abs(n[..., 0]) + np.abs(n[..., 1]) + np.abs(n[..., 2])
    nor = n / np.maximum(denom[..., None], 1e-20)
    folded_xy = (1.0 - np.abs(nor[..., [1, 0]])) * np.sign(nor[..., :2])
    xy = np.where((nor[..., 2] < 0.0)[..., None], folded_xy, nor[..., :2])
    v = xy * 0.5 + 0.5
    d = np.floor(v * float(_MU) + 0.5).astype(np.uint32)
    return (d[..., 1] << np.uint32(_PRES)) | d[..., 0]
