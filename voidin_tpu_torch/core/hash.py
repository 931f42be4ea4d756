"""Float hash functions — utils/hash.wgsl:1-30 parity.

Counterpart of ``voidin_tpu/core/hash.py``: Dave Hoskins's sine-free float
hashes (the reference's WGSL carries the same family), on f32 tensors of
any leading shape; outputs lie in [0, 1). Each sum adds left to right, one
rounding a step, as the JAX functions do op by op."""

from __future__ import annotations

import torch


def _fract(x):
    return x - torch.floor(x)


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def hash11(x):
    """f32 -> f32 (hash.wgsl:1-6)."""
    p = _fract(_f32(x) * 0.1031)
    p = p * (p + 33.333)
    p = p * (p + p)
    return _fract(p)


def hash21(x):
    """(..., 2) -> (...) (hash.wgsl:8-12)."""
    x = _f32(x)
    p = _fract(torch.stack([x[..., 0], x[..., 1], x[..., 0]], -1) * 0.1031)
    q = p * (torch.stack([p[..., 1], p[..., 2], p[..., 0]], -1) + 33.333)
    d = q[..., 0] + q[..., 1] + q[..., 2]
    p = p + d[..., None]
    return _fract((p[..., 0] + p[..., 1]) * p[..., 2])


def hash13(x):
    """f32 -> (..., 3) (hash.wgsl:14-18)."""
    x = _f32(x)
    k = torch.tensor([0.1031, 0.1030, 0.0973], dtype=torch.float32,
                     device=x.device)
    p = _fract(x[..., None] * k)
    q = p * torch.stack([p[..., 1], p[..., 2], p[..., 0]], -1) * 33.3333
    d = q[..., 0] + q[..., 1] + q[..., 2]
    p = p + d[..., None]
    a = torch.stack([p[..., 0], p[..., 0], p[..., 1]], -1)
    b = torch.stack([p[..., 1], p[..., 2], p[..., 2]], -1)
    c = torch.stack([p[..., 2], p[..., 1], p[..., 0]], -1)
    return _fract((a + b) * c)


def hash31(x):
    """(..., 3) -> (...) (hash.wgsl:20-25)."""
    p = _fract(_f32(x) * 0.1031)
    q = p * (torch.stack([p[..., 2], p[..., 1], p[..., 0]], -1) + 31.323)
    d = q[..., 0] + q[..., 1] + q[..., 2]
    p = p + d[..., None]
    return _fract((p[..., 0] + p[..., 1]) * p[..., 2])


def hash33(x):
    """(..., 3) -> (..., 3) (hash.wgsl:27-32)."""
    x = _f32(x)
    k = torch.tensor([0.1031, 0.1030, 0.9073], dtype=torch.float32,
                     device=x.device)
    p = _fract(x * k)
    q = p * (torch.stack([p[..., 1], p[..., 0], p[..., 2]], -1) + 31.323)
    d = q[..., 0] + q[..., 1] + q[..., 2]
    p = p + d[..., None]
    a = torch.stack([p[..., 0], p[..., 0], p[..., 1]], -1)
    b = torch.stack([p[..., 1], p[..., 0], p[..., 0]], -1)
    c = torch.stack([p[..., 2], p[..., 1], p[..., 0]], -1)
    return _fract((a + b) * c)
