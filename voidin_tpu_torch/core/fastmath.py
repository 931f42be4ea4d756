"""Batched small-matrix arithmetic as explicit multiply-adds.

Torch counterpart of ``voidin_tpu/core/fastmath.py``, limited to what the
north-star frame calls. The contractions keep the JAX package's term order
so both packages round alike.
"""

from __future__ import annotations

import torch


def sqrt(x):
    """Correctly rounded f32 square root. CUDA's sqrtf is IEEE-exact; the
    CPU's vectorized sqrt is not always, so a CPU tensor takes the root in
    f64 (exact after rounding back, since 53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def sum3(a):
    """(..., 3) -> (...,) as (a0 + a1) + a2, jnp.sum's order."""
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def norm3(v):
    return sqrt(sum3(v * v))


def normalize(v, eps=1e-20):
    return v / sqrt(torch.clamp(sum3(v * v), min=eps))[..., None]


def cross(a, b):
    """(..., 3) x (..., 3) with jnp.cross's rounding: jnp.cross runs
    jitted, and XLA contracts each component a_j*b_k - a_k*b_j into
    fma(a_j, b_k, -rnd(a_k*b_j)). Emulated in f64, where the first product
    is exact, so one rounding to f32 remains."""
    def comp(j, k):
        sub = (a[..., k] * b[..., j]).to(torch.float64)
        return (a[..., j].to(torch.float64) * b[..., k].to(torch.float64)
                - sub).to(torch.float32)

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def _fma(a, b, c):
    """fma(a, b, c) in f32, emulated in f64 where a * b is exact."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def dot_fma(a, b):
    """jnp.sum(a * b, axis=-1) as XLA compiles it inside a jitted function
    on the CPU: the sequential fused chain
    fma(a_n, b_n, ... fma(a1, b1, a0 * b0))."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = _fma(a[..., k], b[..., k], acc)
    return acc


def _row3_fma(m, i, v):
    # XLA contracts m0 v0 + m1 v1 + m2 v2 into
    # fma(m2, v2, fma(m0, v0, m1 * v1))
    return _fma(m[..., i, 2], v[..., 2],
                _fma(m[..., i, 0], v[..., 0], m[..., i, 1] * v[..., 1]))


def mat3_vec_fma(m, v):
    """mat3_vec as jitted JAX code rounds it (see _row3_fma)."""
    return torch.stack([_row3_fma(m, i, v) for i in range(3)], dim=-1)


def mat4_point_fma(m, p):
    """mat4_point as jitted JAX code rounds it: the mat3_vec_fma rows plus
    the translation."""
    return torch.stack([_row3_fma(m, i, p) + m[..., i, 3]
                        for i in range(3)], dim=-1)


def mat3_vec(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3), elementwise."""
    return torch.stack(
        [
            m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
            + m[..., i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def mat3_mat3(a, b):
    """(..., 3, 3) @ (..., 3, 3) -> (..., 3, 3), elementwise."""
    rows = []
    for i in range(3):
        cols = [
            a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
            + a[..., i, 2] * b[..., 2, j]
            for j in range(3)
        ]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def mat4_point(m, p):
    """(..., 4, 4) applied to (..., 3) points (w=1) -> (..., 3)."""
    return torch.stack(
        [
            m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1]
            + m[..., i, 2] * p[..., 2] + m[..., i, 3]
            for i in range(3)
        ],
        dim=-1,
    )


def mat4_point4(m, p):
    """(..., 4, 4) applied to (..., 3) points (w=1) -> (..., 4) clip coords."""
    return torch.stack(
        [
            m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1]
            + m[..., i, 2] * p[..., 2] + m[..., i, 3]
            for i in range(4)
        ],
        dim=-1,
    )


def const_mat4_point4(m, x, y, z, w=None):
    """Constant (4, 4) matrix applied to per-pixel component planes.

    `m` is a host numpy (4, 4) array; x/y/z[/w] broadcast-compatible
    tensors. Returns a list of 4 planes."""
    out = []
    for i in range(4):
        acc = float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2]) * z
        acc = acc + (float(m[i, 3]) if w is None else float(m[i, 3]) * w)
        out.append(acc)
    return out


def const_mat_vec(m, v):
    """Constant (R, C) matrix times (..., C) batch -> (..., R)."""
    R, C = m.shape
    cols = [v[..., c] for c in range(C)]
    return torch.stack(
        [sum(float(m[r, c]) * cols[c] for c in range(C)) for r in range(R)],
        dim=-1,
    )


def matmul_fma(a, b):
    """(..., M, K) @ (..., K, N) in f32 as a sequential fused multiply-add
    chain over k (acc = fma(a_k, b_k, acc), emulated exactly in f64
    products): the rounding of the JAX package's small matrix products on
    its CPU and TPU backends, and independent of the BLAS a device picks."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (a.shape[-2], b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    for k in range(a.shape[-1]):
        acc = (a64[..., :, k, None] * b64[..., k, None, :]
               + acc.to(torch.float64)).to(torch.float32)
    return acc


def compose_mat4(a, b):
    """(4, 4) @ (N, 4, 4) -> (N, 4, 4)."""
    return matmul_fma(a[None], b)


def compact_indices(mask_flat, size):
    """Indices of the True entries of a flat bool mask, ascending, padded
    to `size` with the False entries' indices (ascending) — the order of
    the JAX package's fused-key sort, which equals a stable argsort of
    ~mask; beyond the mask length the pad is 0, like nonzero's fill."""
    n = mask_flat.shape[0]
    order = torch.argsort(
        (~mask_flat).to(torch.uint8), stable=True
    ).to(torch.int64)
    if size <= n:
        return order[:size]
    return torch.cat(
        [order, torch.zeros(size - n, dtype=order.dtype, device=order.device)]
    )
