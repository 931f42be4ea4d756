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

The area-light terms of every light (ltc_matrix, ltc_evaluate_rect and the
LUT fetches of both) come from one launch of the fused LTC kernel
(ops/ltc_rect.py); the per-light combine stays here, in the JAX package's
order.

``shade_raytraced`` is the raytraced-shadows variant (JAX ``shade_raytraced``,
src/bin/raytraced_shadows.wgsl:58-119): point lights only, each pixel's
shadow ray walked through the TLAS by the traversal kernel
(ops/shadow_trace.py), one launch per point light.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import encoding, fastmath
from ..ops import ltc_rect, shadow_trace
from ..rt import traverse
from ..scene.material import LIGHT_MATERIAL
from ..scene.scene import SceneData

# Fetch the LTC tables with K3's bf16 semantics (bf16 row weights and
# table entries, f32 sums): the JAX package's switch of the same name,
# read at each shade call. Costs ~1e-3 absolute on the LUT values.
LTC_LUT_BF16 = False


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


def _pow16(x):
    """x**16 as jnp's integer_pow computes it: four squarings."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * x8


def shade(scene: SceneData, gbuffer, camera, aux) -> torch.Tensor:
    """G-buffer + the resolve pass's material fields -> (H, W, 3) HDR."""
    depth = gbuffer.depth
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])
    albedo, emissive, mr = aux.albedo, aux.emissive, aux.mr
    pos = world_position_from_depth(depth, camera.clip_to_world)
    cam_pos = torch.as_tensor(np.asarray(camera.position, np.float32)[:3],
                              device=depth.device)
    rd = fastmath.normalize(cam_pos - pos)

    is_light = (gbuffer.material == LIGHT_MATERIAL)[..., None]
    color = albedo[..., :3] * 0.01 + emissive
    color = torch.where(is_light, albedo[..., :3] + emissive, color)

    lights = scene.lights
    for i in range(lights.point_radius.shape[0]):
        lpos = lights.point_position[i]
        lrad = lights.point_radius[i]
        lcol = lights.point_color[i]
        light_vec = lpos - pos
        dist = fastmath.norm3(light_vec)
        atten = attenuation(1.0, 1.0, dist, lrad)
        light_dir = fastmath.normalize(light_vec)
        shade_t = torch.clamp(fastmath.sum3(nor * light_dir), min=0.0)
        diff = lcol * albedo[..., :3] * (shade_t * atten)[..., None]
        covr = torch.clamp(fastmath.sum3(-rd * nor), min=0.0)
        spec = lcol * (mr[..., 2] * _pow16(covr) * atten)[..., None]
        contrib = torch.where((dist - lrad > 0.0)[..., None], 0.0,
                              diff + spec)
        color = color + torch.where(is_light, 0.0, contrib)

    if lights.area_intensity.shape[0] > 0:
        roughness = torch.clamp(mr[..., 0], 0.0, 1.0)
        diffs, specs = ltc_rect.ltc_rect_terms(
            nor, rd, pos, roughness, lights.area_points, scene.ltc1,
            scene.ltc2, bf16=LTC_LUT_BF16)
        for i in range(lights.area_intensity.shape[0]):
            pts = lights.area_points[i]  # (4, 3)
            intensity = lights.area_intensity[i]
            lcol = lights.area_color[i]
            center = (pts[0] + pts[2]) * 0.5
            diff, spec = diffs[i], specs[i]  # spec already times t2.x
            dist_c = fastmath.norm3(center - pos)
            atten = attenuation(intensity, 500.0, dist_c, 25.0)
            contrib = (lcol * intensity) * (
                (spec * atten)[..., None] + albedo[..., :3] * diff[..., None]
            )
            color = color + torch.where(is_light, 0.0, contrib)

    return torch.clamp(color, min=0.0)


def _trace_shadow_rays(tables, max_leaf, pos, nor, lpos, needs_ray):
    """Occlusion of the shadow rays from pos + 1e-4 nor toward `lpos`
    (t_max = 1 in light-vector units), in one kernel launch over every
    pixel with `needs_ray` as the active mask (JAX's active=needs_ray):
    the other pixels walk nothing and hit nothing. Returns ((h, w) bool
    hits, exhausted)."""
    h, w = needs_ray.shape
    res = shadow_trace.occluded(
        *tables, (pos + nor * 1e-4).reshape(-1, 3),
        (lpos - pos).reshape(-1, 3), t_max=1.0,
        active=needs_ray.reshape(-1), max_leaf=max_leaf)
    return res.hit.reshape(h, w), res.exhausted


def shade_raytraced(scene: SceneData, gbuffer, camera, aux,
                    shadow_scale: int = 1):
    """Deferred shading with TLAS-traced point-light shadows (JAX
    shading.py shade_raytraced, :555-710): ambient 0.3 * albedo +
    emissive; per point light a shadow ray from pos + 1e-4 * normal toward
    the light (t_max = 1), occlusion 0.5 on a hit, times attenuation on
    (diff + spec); magenta for material 0 where geometry was hit. Needs
    scene.tlas (World.device(with_tlas=True)).

    Exact ray skip: occlusion only scales (diff + spec) * atten, so the
    pixels where that is zero whatever the ray finds (backfacing with the
    pow-16 "spec" base <= 0, or out of the light's range) trace no ray.
    `shadow_scale=s` (the JAX package's documented deviation) traces the
    top-left sample of each s x s block and repeats its occlusion.

    Returns (hdr, rt) with rt = dict(exhausted=rays still walking at the
    step limit, rays=the rays traced), () tensors summed over lights."""
    depth = gbuffer.depth
    material_id = gbuffer.material
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])
    H, W = depth.shape
    albedo, emissive, mr = aux.albedo, aux.emissive, aux.mr
    pos = world_position_from_depth(depth, camera.clip_to_world)
    cam_pos = torch.as_tensor(np.asarray(camera.position, np.float32)[:3],
                              device=depth.device)
    rd = fastmath.normalize(cam_pos - pos)

    is_light = material_id == LIGHT_MATERIAL
    color = albedo[..., :3] * 0.3 + emissive
    color = torch.where(is_light[..., None], albedo[..., :3] + emissive,
                        color)

    tables = traverse.scene_rays_threaded(scene)
    max_leaf = scene.meshes.bvh_max_leaf
    lights = scene.lights
    shadable = (depth > 0.0) & ~is_light
    exhausted = torch.zeros((), dtype=torch.int32, device=depth.device)
    rays = torch.zeros((), dtype=torch.int64, device=depth.device)
    s = shadow_scale
    for i in range(lights.point_radius.shape[0]):
        lpos = lights.point_position[i]
        lrad = lights.point_radius[i]
        lcol = lights.point_color[i]
        light_vec = lpos - pos
        dist = fastmath.norm3(light_vec)
        ndl = fastmath.sum3(nor * fastmath.normalize(light_vec))
        cov = fastmath.sum3(-rd * nor)
        needs_ray = shadable & (dist < lrad) & ((ndl > 0.0) | (cov > 0.0))
        traced = needs_ray[::s, ::s]
        occ, ex = _trace_shadow_rays(tables, max_leaf, pos[::s, ::s],
                                     nor[::s, ::s], lpos, traced)
        if s > 1:
            occ = occ.repeat_interleave(s, 0).repeat_interleave(s, 1)
            occ = occ[:H, :W]
        exhausted = exhausted + ex
        rays = rays + traced.sum()
        occlusion = torch.where(occ, 0.5, 1.0)

        atten = attenuation(1.0, 1.0, dist, lrad)
        light_dir = fastmath.normalize(light_vec)
        shade_t = torch.clamp(fastmath.sum3(nor * light_dir), min=0.0)
        diff = lcol * albedo[..., :3] * shade_t[..., None]
        covr = torch.clamp(fastmath.sum3(-rd * nor), min=0.0)
        spec = lcol * (mr[..., 2] * _pow16(covr))[..., None]
        contrib = (diff + spec) * (occlusion * atten)[..., None]
        color = color + torch.where(shadable[..., None], contrib, 0.0)

    # the reference renders material 0 as magenta (debug,
    # raytraced_shadows.wgsl:83-85); background pixels resolve to material
    # 0 too, so only where geometry was hit
    magenta = torch.tensor([1.0, 0.0, 1.0], device=depth.device)
    color = torch.where(((material_id == 0) & (depth > 0.0))[..., None],
                        magenta, color)
    return torch.clamp(color, min=0.0), dict(exhausted=exhausted, rays=rays)
