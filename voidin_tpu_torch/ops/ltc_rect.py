"""Fused LTC rect-light evaluation (kernel K3 redesigned for the H100).

``ltc_rect_terms`` replaces ``voidin_tpu/ops/lut_fetch.py`` ``_kernel``
(the Pallas LUT fetch) together with its consumer,
``voidin_tpu/passes/shading.py`` ``ltc_matrix`` (:191), ``ltc_evaluate_rect``
(:277) and the full-resolution per-light loop of ``shade`` (:490-505): the
area-light terms of every pixel and light in one launch. On a CUDA tensor
it launches the hand-written Hopper kernel in ``csrc/ltc_rect.cu`` (see its
header for what bounds it on an H100 and how the design answers that); on
a CPU tensor it runs the plain PyTorch twin ``ltc_rect_terms_reference``,
the chain ``shade`` ran before, with ``lut_fetch_reference`` as the fetch.
A CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core import fastmath
from .lut_fetch import TDIM, lut_fetch_reference

LUT_SIZE = float(TDIM)
LUT_SCALE = (LUT_SIZE - 1.0) / LUT_SIZE
LUT_BIAS = 0.5 / LUT_SIZE

LAUNCHES = 0  # f32-variant kernel launches (CUDA path only)
LAUNCHES_BF16 = 0  # bf16-variant kernel launches (CUDA path only)


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def integrate_edge(v1, v2):
    """ltc.wgsl:52-66 — vectorized over (..., 3)."""
    x = fastmath.sum3(v1 * v2)
    y = x.abs()
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    theta_sintheta = torch.where(
        x > 0.0, v,
        0.5 / fastmath.sqrt(torch.clamp(1.0 - x * x, min=1e-7)) - v,
    )
    return _cross(v1, v2) * theta_sintheta[..., None]


def ltc_matrix(ltc1, ltc2, nor, view, roughness, bf16=False,
               fetch=lut_fetch_reference):
    """ltc.wgsl:160-177: fetch inverse-M + the LTC2 norm/fresnel texel
    through `fetch` (K3's twin, or passes/shading.py's K3 launch).
    Returns (minv (..., 3, 3), t1 (..., 4), t2.x (...,))."""
    ndotv = torch.clamp(fastmath.sum3(nor * view), 0.0, 1.0)
    uv = torch.stack([roughness, fastmath.sqrt(1.0 - ndotv)], dim=-1)
    uv = uv * LUT_SCALE + LUT_BIAS
    # Only 5 of the 8 packed channels are consumed (t1.xyzw + t2.x).
    chans = [ltc1[..., c] for c in range(4)] + [ltc2[..., 0]]
    vals = fetch(chans, uv, bf16=bf16)
    t1 = torch.stack(vals[:4], dim=-1)
    zero = torch.zeros_like(vals[4])
    one = torch.ones_like(zero)
    t2x = vals[4]
    # WGSL columns (t1.x,0,t1.y),(0,1,0),(t1.z,0,t1.w) -> row-major matrix.
    minv = torch.stack(
        [
            torch.stack([t1[..., 0], zero, t1[..., 2]], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([t1[..., 1], zero, t1[..., 3]], dim=-1),
        ],
        dim=-2,
    )
    return minv, t1, t2x


def ltc_evaluate_rect(ltc2, nor, view, pos, mminv, points, bf16=False):
    """ltc.wgsl:108-158. points: (4, 3); pixel fields (..., 3)."""
    t1v = fastmath.normalize(view - nor * fastmath.sum3(view * nor)[..., None])
    t2v = _cross(nor, t1v)
    basis = torch.stack([t1v, t2v, nor], dim=-2)  # rows T1, T2, N
    minv = fastmath.mat3_mat3(mminv, basis)
    Ln = [
        fastmath.normalize(fastmath.mat3_vec(minv, points[p] - pos))
        for p in range(4)
    ]
    direction = points[0] - pos
    light_normal = _cross(points[1] - points[0], points[3] - points[0])
    behind = fastmath.sum3(direction * light_normal) < 0.0
    vsum = (
        integrate_edge(Ln[0], Ln[1]) + integrate_edge(Ln[1], Ln[2])
        + integrate_edge(Ln[2], Ln[3]) + integrate_edge(Ln[3], Ln[0])
    )
    length = fastmath.norm3(vsum)
    z = vsum[..., 2] / torch.clamp(length, min=1e-20)
    z = torch.where(behind, -z, z)
    uv = torch.stack([z * 0.5 + 0.5, length], dim=-1) * LUT_SCALE + LUT_BIAS
    scale = lut_fetch_reference([ltc2[..., 3]], uv, bf16=bf16)[0]
    # (...,) scalar irradiance (a vec3 splat in WGSL)
    return torch.where(behind, 0.0, length * scale)


def ltc_rect_terms_reference(nor, rd, pos, roughness, area_points, ltc1,
                             ltc2, bf16=False):
    """Plain PyTorch twin of the fused kernel: ltc_matrix, then per light
    ltc_evaluate_rect with the identity (diffuse) and with the fetched
    matrix (specular, times t2.x). Returns (diff, spec), each (L, ...)."""
    minv, _, t2x = ltc_matrix(ltc1, ltc2, nor, rd, roughness, bf16=bf16)
    identity = torch.eye(3, dtype=torch.float32,
                         device=nor.device).expand(minv.shape)
    diffs, specs = [], []
    for pts in area_points:  # (4, 3) each
        diffs.append(ltc_evaluate_rect(ltc2, nor, rd, pos, identity, pts,
                                       bf16=bf16))
        spec = ltc_evaluate_rect(ltc2, nor, rd, pos, minv, pts, bf16=bf16)
        specs.append(spec * t2x)  # scolor = vec3(1): spec *= t2.x
    return torch.stack(diffs), torch.stack(specs)


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} f32 on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} {t.device}")


def ltc_rect_terms(nor, rd, pos, roughness, area_points, ltc1, ltc2,
                   bf16=False):
    """Area-light terms of L rect lights at every pixel: `nor`, `rd` (the
    view vector), `pos` (..., 3) and `roughness` (...,) f32 fields,
    `area_points` (L, 4, 3), `ltc1` / `ltc2` the scene's (64, 64, 4)
    tables as stored. Returns (diff, spec), each (L, ...) f32: the
    identity-matrix evaluation and the specular one times t2.x. `bf16`
    selects the LTC_LUT_BF16 fetch. CPU tensors run the twin; CUDA tensors
    launch the fused kernel."""
    if nor.device.type == "cpu":
        return ltc_rect_terms_reference(nor, rd, pos, roughness, area_points,
                                        ltc1, ltc2, bf16=bf16)
    global LAUNCHES, LAUNCHES_BF16
    from . import _build

    dev = nor.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    shape = tuple(roughness.shape)
    n_lights = area_points.shape[0]
    for name, t in (("nor", nor), ("rd", rd), ("pos", pos)):
        _check(name, t, shape + (3,), dev)
    _check("roughness", roughness, shape, dev)
    _check("area_points", area_points, (n_lights, 4, 3), dev)
    _check("ltc1", ltc1, (TDIM, TDIM, 4), dev)
    _check("ltc2", ltc2, (TDIM, TDIM, 4), dev)
    p = roughness.numel()
    diff = torch.empty((n_lights,) + shape, dtype=torch.float32, device=dev)
    spec = torch.empty_like(diff)
    if p == 0 or n_lights == 0:
        return diff, spec  # nothing to launch
    ins = [t.contiguous() for t in (nor, rd, pos, roughness, area_points,
                                    ltc1, ltc2)]
    lib = _build.load()
    fn = lib.voidin_ltc_rect_bf16 if bf16 else lib.voidin_ltc_rect
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in ins[:5]], n_lights,
                *[t.data_ptr() for t in ins[5:]], p, diff.data_ptr(),
                spec.data_ptr(), stream)
    _build.check(lib, rc, "ltc_rect_terms")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return diff, spec
