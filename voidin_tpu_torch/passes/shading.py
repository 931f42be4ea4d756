"""Deferred shading: ambient + emissive, point lights, LTC area lights.

Counterpart of ``voidin_tpu/passes/shading.py`` ``shade`` at
area_light_scale=1 (shaders/shading.wgsl:36-118), with the reference
quirks kept for parity:
* world position reconstructed from reverse-Z depth + clip_to_world
  (utils/uv.wgsl world_position_from_depth);
* ambient = 0.01 * albedo + emissive; LIGHT_MATERIAL pixels render
  albedo + emissive and skip all lights (shading.wgsl:66-71);
* point lights: smooth attenuation (1-s^2)^2/(1+f*s^2), lambert diffuse and
  the reference's pow-16 "spec" term on dot(-rd, normal), which is ~always
  zero for front-facing surfaces (shading.wgsl:85-95);
* area lights: LTC rect evaluation (utils/ltc.wgsl) with roughness from
  metallic_roughness.x, radius-25 attenuation on the specular term only,
  base_color ignored by shading (shading.wgsl:58, 98-112).

The LTC table fetch goes through kernel K3 (ops/lut_fetch.py): 5 channels
in ltc_matrix and one per ltc_evaluate_rect call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import encoding, fastmath
from ..ops.lut_fetch import lut_fetch
from ..scene.material import LIGHT_MATERIAL
from ..scene.scene import SceneData

LUT_SIZE = 64.0
LUT_SCALE = (LUT_SIZE - 1.0) / LUT_SIZE
LUT_BIAS = 0.5 / LUT_SIZE

# Fetch the LTC tables through K3's bf16 variant (bf16 row weights and
# table entries, f32 sums): the JAX package's switch of the same name,
# read at each fetch. Costs ~1e-3 absolute on the LUT values.
LTC_LUT_BF16 = False


def _sum3(a):
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def _norm3(v):
    return fastmath.sqrt(_sum3(v * v))


def _normalize(v, eps=1e-20):
    return v / fastmath.sqrt(torch.clamp(_sum3(v * v), min=eps))[..., None]


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _pixel_ndc(H, W, device):
    u = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
    v = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
    x_ndc = (u * 2.0 - 1.0)[None, :].expand(H, W)
    y_ndc = ((1.0 - v) * 2.0 - 1.0)[:, None].expand(H, W)
    return x_ndc, y_ndc


def world_position_from_depth(depth: torch.Tensor,
                              clip_to_world) -> torch.Tensor:
    """(H, W) raw depth -> (H, W, 3) world positions (uv.wgsl:18-23)."""
    H, W = depth.shape
    x_ndc, y_ndc = _pixel_ndc(H, W, depth.device)
    m = np.asarray(clip_to_world, np.float32)
    wx, wy, wz, ww = fastmath.const_mat4_point4(m, x_ndc, y_ndc, depth)
    # depth == 0 (background, infinite far) gives w == 0: clamp so the
    # position is huge-but-finite and the light math stays NaN-free.
    w = torch.where(ww.abs() > 1e-12, ww,
                    torch.where(ww < 0, -1e-12, 1e-12))[..., None]
    return torch.clamp(torch.stack([wx, wy, wz], dim=-1) / w, -1e12, 1e12)


def attenuation(max_intensity, falloff, dist, radius):
    s = dist / radius
    s2 = s * s
    one = 1.0 - s2
    att = max_intensity * (one * one) / (1.0 + falloff * s2)
    return torch.where(s >= 1.0, 0.0, att)


def uv_lod(uv: torch.Tensor, tex_w, tex_h) -> torch.Tensor:
    """Mip level from screen-space finite differences of the uv image."""
    du = torch.cat([uv[:, 1:] - uv[:, :-1], torch.zeros_like(uv[:, :1])],
                   dim=1)
    dv = torch.cat([uv[1:] - uv[:-1], torch.zeros_like(uv[:1])], dim=0)
    rho = torch.maximum(
        du[..., 0].abs() * tex_w + du[..., 1].abs() * tex_h,
        dv[..., 0].abs() * tex_w + dv[..., 1].abs() * tex_h,
    )
    return torch.clamp(torch.log2(torch.clamp(rho, min=1e-8)), 0.0, 16.0)


# ---------------------------------------------------------------------------
# LTC (utils/ltc.wgsl)
# ---------------------------------------------------------------------------


def sample_lut_bilinear_multi(tables, uv: torch.Tensor):
    """Bilinear samples of several (64, 64) tables at `uv` (..., 2),
    pre-scaled by LUT_SCALE/BIAS: kernel K3 on the card, its twin on the
    CPU; its bf16 variant when LTC_LUT_BF16 is set."""
    return lut_fetch(tables, uv, bf16=LTC_LUT_BF16)


def integrate_edge(v1, v2):
    """ltc.wgsl:52-66 — vectorized over (..., 3)."""
    x = _sum3(v1 * v2)
    y = x.abs()
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    theta_sintheta = torch.where(
        x > 0.0, v,
        0.5 / fastmath.sqrt(torch.clamp(1.0 - x * x, min=1e-7)) - v,
    )
    return _cross(v1, v2) * theta_sintheta[..., None]


def ltc_matrix(scene: SceneData, nor, view, roughness):
    """ltc.wgsl:160-177: fetch inverse-M + the LTC2 norm/fresnel texel."""
    ndotv = torch.clamp(_sum3(nor * view), 0.0, 1.0)
    uv = torch.stack([roughness, fastmath.sqrt(1.0 - ndotv)], dim=-1)
    uv = uv * LUT_SCALE + LUT_BIAS
    # Only 5 of the 8 packed channels are consumed (t1.xyzw + t2.x).
    chans = [scene.ltc1[..., c] for c in range(4)] + [scene.ltc2[..., 0]]
    vals = sample_lut_bilinear_multi(chans, uv)
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
    return minv, t2x


def ltc_evaluate_rect(scene: SceneData, nor, view, pos, mminv, points):
    """ltc.wgsl:108-158. points: (4, 3); pixel fields (..., 3)."""
    t1v = _normalize(view - nor * _sum3(view * nor)[..., None])
    t2v = _cross(nor, t1v)
    basis = torch.stack([t1v, t2v, nor], dim=-2)  # rows T1, T2, N
    minv = fastmath.mat3_mat3(mminv, basis)
    Ln = [
        _normalize(fastmath.mat3_vec(minv, points[p] - pos))
        for p in range(4)
    ]
    direction = points[0] - pos
    light_normal = _cross(points[1] - points[0], points[3] - points[0])
    behind = _sum3(direction * light_normal) < 0.0
    vsum = (
        integrate_edge(Ln[0], Ln[1]) + integrate_edge(Ln[1], Ln[2])
        + integrate_edge(Ln[2], Ln[3]) + integrate_edge(Ln[3], Ln[0])
    )
    length = _norm3(vsum)
    z = vsum[..., 2] / torch.clamp(length, min=1e-20)
    z = torch.where(behind, -z, z)
    uv = torch.stack([z * 0.5 + 0.5, length], dim=-1) * LUT_SCALE + LUT_BIAS
    scale = sample_lut_bilinear_multi([scene.ltc2[..., 3]], uv)[0]
    # (...,) scalar irradiance (a vec3 splat in WGSL)
    return torch.where(behind, 0.0, length * scale)


def shade(scene: SceneData, gbuffer, camera, aux) -> torch.Tensor:
    """G-buffer + the resolve pass's material fields -> (H, W, 3) HDR."""
    depth = gbuffer.depth
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])
    albedo, emissive, mr = aux.albedo, aux.emissive, aux.mr
    pos = world_position_from_depth(depth, camera.clip_to_world)
    cam_pos = torch.as_tensor(np.asarray(camera.position, np.float32)[:3],
                              device=depth.device)
    rd = _normalize(cam_pos - pos)

    is_light = (gbuffer.material == LIGHT_MATERIAL)[..., None]
    color = albedo[..., :3] * 0.01 + emissive
    color = torch.where(is_light, albedo[..., :3] + emissive, color)

    lights = scene.lights
    for i in range(lights.point_radius.shape[0]):
        lpos = lights.point_position[i]
        lrad = lights.point_radius[i]
        lcol = lights.point_color[i]
        light_vec = lpos - pos
        dist = _norm3(light_vec)
        atten = attenuation(1.0, 1.0, dist, lrad)
        light_dir = _normalize(light_vec)
        shade_t = torch.clamp(_sum3(nor * light_dir), min=0.0)
        diff = lcol * albedo[..., :3] * (shade_t * atten)[..., None]
        covr = torch.clamp(_sum3(-rd * nor), min=0.0)
        c2 = covr * covr
        c4 = c2 * c2
        c8 = c4 * c4
        spec = lcol * (mr[..., 2] * (c8 * c8) * atten)[..., None]
        contrib = torch.where((dist - lrad > 0.0)[..., None], 0.0,
                              diff + spec)
        color = color + torch.where(is_light, 0.0, contrib)

    if lights.area_intensity.shape[0] > 0:
        roughness = torch.clamp(mr[..., 0], 0.0, 1.0)
        minv, t2x = ltc_matrix(scene, nor, rd, roughness)
        identity = torch.eye(3, dtype=torch.float32,
                             device=depth.device).expand(minv.shape)
        for i in range(lights.area_intensity.shape[0]):
            pts = lights.area_points[i]  # (4, 3)
            intensity = lights.area_intensity[i]
            lcol = lights.area_color[i]
            center = (pts[0] + pts[2]) * 0.5
            diff = ltc_evaluate_rect(scene, nor, rd, pos, identity, pts)
            spec = ltc_evaluate_rect(scene, nor, rd, pos, minv, pts)
            spec = spec * t2x  # scolor = vec3(1): spec *= t2.x
            dist_c = _norm3(center - pos)
            atten = attenuation(intensity, 500.0, dist_c, 25.0)
            contrib = (lcol * intensity) * (
                (spec * atten)[..., None] + albedo[..., :3] * diff[..., None]
            )
            color = color + torch.where(is_light, 0.0, contrib)

    return torch.clamp(color, min=0.0)
