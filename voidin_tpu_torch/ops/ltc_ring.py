"""Fused LTC ring-light evaluation (kernel K3 redesigned on the ring path).

``ltc_ring_terms`` replaces ``voidin_tpu/ops/lut_fetch.py`` ``_kernel``
(the Pallas LUT fetch) together with its consumers on the ring-light
frame, ``voidin_tpu/passes/shading.py`` ``ltc_matrix`` (:191),
``ltc_evaluate_disk`` (:771-873), ``ltc_evaluate_ring2`` (:887-904) and the
spec and diffuse terms of ``shade_ring_light`` (:969-1051): both terms of
every pixel in one launch. On a CUDA tensor it launches the hand-written
Hopper kernel in ``csrc/ltc_ring.cu`` (see its header for what bounds it
on an H100 and how the design answers that); on a CPU tensor it runs the
plain PyTorch twin ``ltc_ring_terms_reference``, the chain
``shade_ring_light`` ran before, with ``lut_fetch_reference`` as the
fetch. A CUDA tensor goes to the kernel or raises.

The disk math (``evaluate_disk``, ``evaluate_ring2``, ``solve_cubic``) is
the exact clipped-disk LTC of the reference's ring_light.wgsl:101-321;
``passes/shading.py`` calls it with K3 as the horizon fetch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import fastmath
from . import ltc_rect
from .ltc_rect import LUT_BIAS, LUT_SCALE
from .lut_fetch import TDIM, lut_fetch_reference

LAUNCHES = 0  # f32-variant kernel launches (CUDA path only)
LAUNCHES_BF16 = 0  # bf16-variant kernel launches (CUDA path only)


def relu(x):
    """jnp.maximum(x, 0.0): +0 for a zero of either sign (torch.clamp
    keeps -0, which flips atan2 downstream), NaN kept."""
    return torch.clamp(x, min=0.0) + 0.0


def guard(x, eps):
    """where(|x| > eps, x, eps)"""
    return torch.where(x.abs() > eps, x, eps)


def solve_cubic(c0, c1, c2, c3=1.0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0, branchless: the
    split-algorithm form (Blinn / Peters, "How to solve a cubic equation,
    revisited") of the reference's clipped-disk LTC
    (src/bin/ring_light.wgsl:101-187): the largest root from algorithm A,
    the smallest from algorithm D, the middle from their product, each a
    homogeneous (num, den) pair. Returns the roots with [1] the middle one
    (the reference's partial sort)."""
    B = c2 / c3 / 3.0
    C = c1 / c3 / 3.0
    D = c0 / c3
    # Hessian and discriminant
    d1 = C - B * B
    d2 = D - C * B
    d3 = B * D - C * C
    disc = relu(4.0 * d1 * d3 - d2 * d2)
    sq_disc = fastmath.sqrt(disc)

    # algorithm A (largest root)
    d_a = -2.0 * B * d1 + d2
    theta_a = torch.atan2(sq_disc, -d_a) / 3.0
    sc_a = 2.0 * fastmath.sqrt(relu(-d1))
    x1a = sc_a * torch.cos(theta_a)
    x3a = sc_a * torch.cos(theta_a + 2.0 * np.pi / 3.0)
    xl = torch.where(x1a + x3a > 2.0 * B, x1a, x3a)
    xl_num, xl_den = xl - B, torch.ones_like(xl) * c3

    # algorithm D (smallest root)
    d_d = -D * d2 + 2.0 * C * d3
    theta_d = torch.atan2(D * sq_disc, -d_d) / 3.0
    sc_d = 2.0 * fastmath.sqrt(relu(-d3))
    x1d = sc_d * torch.cos(theta_d)
    x3d = sc_d * torch.cos(theta_d + 2.0 * np.pi / 3.0)
    xs = torch.where(x1d + x3d < 2.0 * C, x1d, x3d)
    xs_num, xs_den = -D, xs + C

    e = xl_den * xs_den
    f = -xl_num * xs_den - xl_den * xs_num
    g = xl_num * xs_num
    xm_num, xm_den = C * f - B * g, -B * f + C * e

    rx = xs_num / guard(xs_den, 1e-20)
    ry = xm_num / guard(xm_den, 1e-20)
    rz = xl_num / guard(xl_den, 1e-20)
    # partial sort (ring_light.wgsl:178-184): [1] is the middle root
    x_small = (rx < ry) & (rx < rz)
    z_small = (rz < rx) & (rz < ry)
    r0 = torch.where(x_small, ry, rx)
    r1 = torch.where(x_small, rx, torch.where(z_small, rz, ry))
    r2 = torch.where(z_small, ry, rz)
    return r0, r1, r2


def ltc_basis(nor, view, mminv):
    """mminv @ [T1; T2; N], the view-aligned tangent frame's rows."""
    t1v = fastmath.normalize(view - nor * fastmath.sum3(view * nor)[..., None])
    t2v = fastmath.cross(nor, t1v)
    basis = torch.stack([t1v, t2v, nor], dim=-2)  # rows T1, T2, N
    return fastmath.mat3_mat3(mminv, basis)


def disk_points3(center, dirx, diry, halfx, halfy):
    """(3, 3) f32 numpy corner triple (-ex-ey, +ex-ey, +ex+ey) of a disk's
    bounding rect (init_disk_points, ring_light.wgsl:69-80)."""
    center = np.asarray(center, np.float32)
    ex = float(halfx) * np.asarray(dirx, np.float32)
    ey = float(halfy) * np.asarray(diry, np.float32)
    return np.stack([center - ex - ey, center + ex - ey, center + ex + ey])


def ring_points3(center, dirx, diry, halfx, halfy):
    """(2, 3, 3) f32 numpy: the annulus' outer disk (the UN-grown `disk`;
    the grown disk1 is dead code in the reference) and its inner disk,
    shrunk by clamp(0.5, 0.05, 0.95 * half) (ltc_evaluate_ring2,
    ring_light.wgsl:307-321)."""
    r, eps = 0.5, 0.05
    dx = float(np.clip(r, eps, 0.95 * halfx))
    dy = float(np.clip(r, eps, 0.95 * halfy))
    return np.stack([disk_points3(center, dirx, diry, halfx, halfy),
                     disk_points3(center, dirx, diry, halfx - dx,
                                  halfy - dy)])


def evaluate_disk(nor, view, pos, mminv, points3, scale_fetch,
                  two_sided=False):
    """EXACT clipped-disk (ellipse) LTC evaluation: the analytic sphere
    form factor of the cosine-space ellipse (ltc_evaluate_ring,
    ring_light.wgsl:189-305: ellipse eigen-decomposition, cubic solve,
    tabulated horizon-clipped sphere). points3: (3, 3) corners (-ex-ey,
    +ex-ey, +ex+ey) of the disk's bounding rect; pixel fields (..., 3);
    `scale_fetch(uv)` the LTC2 channel-3 tap at a pre-scaled uv."""
    minv = ltc_basis(nor, view, mminv)
    rel = points3[..., None, :, :] - pos[..., None, :]  # (..., 3, 3)
    l0 = fastmath.mat3_vec(minv, rel[..., 0, :])
    l1 = fastmath.mat3_vec(minv, rel[..., 1, :])
    l2 = fastmath.mat3_vec(minv, rel[..., 2, :])

    c = 0.5 * (l0 + l2)
    v1 = 0.5 * (l1 - l2)
    v2 = 0.5 * (l1 - l0)

    front = fastmath.sum3(fastmath.cross(v1, v2) * c) >= 0.0
    occlusion = (torch.ones_like(front, dtype=torch.float32) if two_sided
                 else front.to(torch.float32))

    d11 = fastmath.sum3(v1 * v1)
    d22 = fastmath.sum3(v2 * v2)
    d12 = fastmath.sum3(v1 * v2)
    skew = d12.abs() / fastmath.sqrt(
        torch.clamp(d11 * d22, min=1e-20)) > 1e-4

    # eigen-decomposition branch (branchless: both paths, then select)
    tr = d11 + d22
    det = fastmath.sqrt(relu(d11 * d22 - d12 * d12))
    u = 0.5 * fastmath.sqrt(relu(tr - 2.0 * det))
    w = 0.5 * fastmath.sqrt(relu(tr + 2.0 * det))
    e_max = (u + w) * (u + w)
    e_min = (u - w) * (u - w)
    big11 = (d11 > d22)[..., None]
    v1e = torch.where(
        big11,
        d12[..., None] * v1 + (e_max - d11)[..., None] * v2,
        d12[..., None] * v2 + (e_max - d22)[..., None] * v1,
    )
    v2e = torch.where(
        big11,
        d12[..., None] * v1 + (e_min - d11)[..., None] * v2,
        d12[..., None] * v2 + (e_min - d22)[..., None] * v1,
    )
    a_e = 1.0 / torch.clamp(e_max, min=1e-20)
    b_e = 1.0 / torch.clamp(e_min, min=1e-20)
    # aligned branch
    a_s = 1.0 / torch.clamp(d11, min=1e-20)
    b_s = 1.0 / torch.clamp(d22, min=1e-20)

    a = torch.where(skew, a_e, a_s)
    b = torch.where(skew, b_e, b_s)
    sk = skew[..., None]
    v1 = torch.where(sk, fastmath.normalize(v1e),
                     v1 * fastmath.sqrt(a_s)[..., None])
    v2 = torch.where(sk, fastmath.normalize(v2e),
                     v2 * fastmath.sqrt(b_s)[..., None])

    v3 = fastmath.cross(v1, v2)
    flip = (fastmath.sum3(c * v3) < 0.0)[..., None]
    v3 = torch.where(flip, -v3, v3)

    ll = fastmath.sum3(v3 * c)
    ll_safe = guard(ll, 1e-20)
    x0 = fastmath.sum3(v1 * c) / ll_safe
    y0 = fastmath.sum3(v2 * c) / ll_safe

    a = a * ll * ll
    b = b * ll * ll

    c0 = a * b
    c1 = a * b * (1.0 + x0 * x0 + y0 * y0) - a - b
    c2 = 1.0 - a * (1.0 + x0 * x0) - b * (1.0 + y0 * y0)
    e1, e2, e3 = solve_cubic(c0, c1, c2)

    avg_x = a * x0 / guard(a - e2, 1e-20)
    avg_y = b * y0 / guard(b - e2, 1e-20)
    # rotate = columns (V1, V2, V3): avg_world = V1 ax + V2 ay + V3 az
    avg_dir = fastmath.normalize(v1 * avg_x[..., None] + v2 * avg_y[..., None]
                                 + v3 * torch.ones_like(x0)[..., None])

    l1f = fastmath.sqrt(relu(-e2 / guard(e3, 1e-20)))
    l2f = fastmath.sqrt(relu(-e2 / guard(e1, 1e-20)))
    form = l1f * l2f / fastmath.sqrt((1.0 + l1f * l1f) * (1.0 + l2f * l2f))

    uv = torch.stack([avg_dir[..., 2] * 0.5 + 0.5, form], dim=-1)
    uv = uv * LUT_SCALE + LUT_BIAS
    return form * scale_fetch(uv) * occlusion


def evaluate_ring2(nor, view, pos, mminv, points, scale_fetch,
                   two_sided=False):
    """Annulus = full disk minus a shrunk inner disk (ltc_evaluate_ring2,
    ring_light.wgsl:307-321); `points` the (2, 3, 3) of ring_points3."""
    return (evaluate_disk(nor, view, pos, mminv, points[0], scale_fetch,
                          two_sided)
            - evaluate_disk(nor, view, pos, mminv, points[1], scale_fetch,
                            two_sided))


def ltc_ring_terms_reference(nor, rd, pos, roughness, points, ltc1, ltc2,
                             two_sided=True, bf16=False):
    """Plain PyTorch twin of the fused kernel: ltc_matrix at the constant
    `roughness`, then the annulus under the fetched matrix (times t2.x)
    and the full disk under the identity. `points` (2, 3, 3) f32 numpy
    (ring_points3). Returns (spec, diff), each (...,)."""
    rough = torch.full(nor.shape[:-1], float(roughness), dtype=torch.float32,
                       device=nor.device)
    minv, _, t2x = ltc_rect.ltc_matrix(ltc1, ltc2, nor, rd, rough, bf16=bf16)
    identity = torch.eye(3, dtype=torch.float32,
                         device=nor.device).expand(minv.shape)

    def scale_fetch(uv):
        return lut_fetch_reference([ltc2[..., 3]], uv, bf16=bf16)[0]

    pts = torch.from_numpy(np.ascontiguousarray(points)).to(nor.device)
    spec = evaluate_ring2(nor, rd, pos, minv, pts, scale_fetch,
                          two_sided) * t2x
    diff = evaluate_disk(nor, rd, pos, identity, pts[0], scale_fetch,
                         two_sided)
    return spec, diff


def ltc_ring_terms(nor, rd, pos, roughness, points, ltc1, ltc2,
                   two_sided=True, bf16=False):
    """The ring light's two LTC terms at every pixel: `nor`, `rd` (the
    view vector) and `pos` (..., 3) f32 fields, `roughness` a float,
    `points` the (2, 3, 3) outer and inner disk corners (ring_points3),
    `ltc1` / `ltc2` the scene's (64, 64, 4) tables as stored. Returns
    (spec, diff), each (...,) f32: the annulus under the fetched matrix
    times t2.x, and the full disk under the identity. `bf16` selects the
    LTC_LUT_BF16 fetch. CPU tensors run the twin; CUDA tensors launch the
    fused kernel."""
    if nor.device.type == "cpu":
        return ltc_ring_terms_reference(nor, rd, pos, roughness, points,
                                        ltc1, ltc2, two_sided=two_sided,
                                        bf16=bf16)
    global LAUNCHES, LAUNCHES_BF16
    from . import _build

    dev = nor.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    shape = tuple(nor.shape[:-1])
    for name, t in (("nor", nor), ("rd", rd), ("pos", pos)):
        ltc_rect._check(name, t, shape + (3,), dev)
    ltc_rect._check("ltc1", ltc1, (TDIM, TDIM, 4), dev)
    ltc_rect._check("ltc2", ltc2, (TDIM, TDIM, 4), dev)
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.shape != (2, 3, 3):
        raise ValueError(f"points must be (2, 3, 3), got {pts.shape}")
    spec = torch.empty(shape, dtype=torch.float32, device=dev)
    diff = torch.empty_like(spec)
    p = spec.numel()
    if p == 0:
        return spec, diff  # nothing to launch
    ins = [t.contiguous() for t in (nor, rd, pos, ltc1, ltc2)]
    lib = _build.load()
    fn = lib.voidin_ltc_ring_bf16 if bf16 else lib.voidin_ltc_ring
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in ins[:3]], ctypes.c_float(roughness),
                pts.ctypes.data, int(bool(two_sided)),
                *[t.data_ptr() for t in ins[3:]], p, spec.data_ptr(),
                diff.data_ptr(), stream)
    _build.check(lib, rc, "ltc_ring_terms")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return spec, diff
