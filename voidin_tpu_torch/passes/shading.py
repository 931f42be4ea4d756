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

``shade_ring_light`` is the ring_light demo's shading (JAX
``shade_ring_light``, src/bin/ring_light.wgsl:340-440) with the EXACT
clipped-disk LTC evaluation (``ltc_evaluate_disk``: ellipse
eigen-decomposition, cubic solve, horizon-clipped sphere LUT); its
``ltc_matrix`` fetches its 5 LUT channels through kernel K3
(ops/lut_fetch.py), one launch a frame. Also here: the polygon evaluation
(``ltc_evaluate_polygon``, ``ring_points``) and the textured-light lookup
(``ltc_apply_texture``), which no frame calls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import encoding, fastmath
from ..ops import ltc_rect, lut_fetch, shadow_trace
from ..ops.ltc_rect import LUT_BIAS, LUT_SCALE, integrate_edge
from ..rt import traverse
from ..scene.material import LIGHT_MATERIAL
from ..scene.scene import SceneData
from ..scene.texture import sample_trilinear

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


# ---------------------------------------------------------------------------
# LTC matrix, disk, ring and polygon lights (utils/ltc.wgsl, ring_light.wgsl)
# ---------------------------------------------------------------------------


def _norm(v):
    """jnp.linalg.norm over the last axis, a jitted sum whose products XLA
    fuses (fastmath.dot_fma)."""
    return fastmath.sqrt(fastmath.dot_fma(v, v))


def _relu(x):
    """jnp.maximum(x, 0.0): +0 for a zero of either sign (torch.clamp
    keeps -0, which flips atan2 downstream), NaN kept."""
    return torch.clamp(x, min=0.0) + 0.0


def _guard(x, eps):
    """where(|x| > eps, x, eps)"""
    return torch.where(x.abs() > eps, x, eps)


def _lut_scale(scene: SceneData, uv):
    """The horizon-clipped sphere's form-factor scale, LTC2 channel 3, at
    `uv`: the plain bilinear tap the JAX package computes in jnp
    (sample_lut_bilinear_mxu; LTC_LUT_BF16 honoured)."""
    return lut_fetch.lut_fetch_reference([scene.ltc2[..., 3]], uv,
                                         bf16=LTC_LUT_BF16)[0]


def ltc_matrix(scene: SceneData, nor, view, roughness):
    """ltc.wgsl:160-177: the inverse-M matrix and the LTC2 texel. Its 5
    LUT channels (t1.xyzw, t2.x) come from one launch of kernel K3
    (ops/lut_fetch.py; the twin on CPU tensors), with LTC_LUT_BF16's fetch
    where that switch is on. Returns (minv (..., 3, 3), t1 (..., 4), t2
    (..., 4) with t2.yzw zero)."""
    minv, t1, t2x = ltc_rect.ltc_matrix(scene.ltc1, scene.ltc2, nor, view,
                                        roughness, bf16=LTC_LUT_BF16,
                                        fetch=lut_fetch.lut_fetch)
    zero = torch.zeros_like(t2x)
    return minv, t1, torch.stack([t2x, zero, zero, zero], dim=-1)


def ltc_apply_texture(scene: SceneData, tex_id, p0, p1, p2):
    """Filtered light-texture lookup for textured area lights
    (ltc.wgsl:75-106 apply_texture; in the reference's LTC library, called
    by no shipped shader). p0/p1/p2: three corners of the cosine-space quad
    per pixel (..., 3); returns a filtered (..., 3) rgb: the blur width
    grows with the distance from the quad plane and outside the unit
    square, three taps of decreasing footprint."""
    v1 = p0 - p1
    v2 = p2 - p1
    plane_orto = fastmath.cross(v1, v2)
    plane_area_sq = fastmath.sum3(plane_orto * plane_orto)
    dist_x_area = fastmath.sum3(plane_orto * p1)
    denom = _guard(plane_area_sq, 1e-20)
    p = dist_x_area[..., None] * plane_orto / denom[..., None] - p1

    dot_v1_v2 = fastmath.sum3(v1 * v2)
    inv_dot_v1_v1 = 1.0 / torch.clamp(fastmath.sum3(v1 * v1), min=1e-20)
    v2p = v2 - v1 * (dot_v1_v2 * inv_dot_v1_v1)[..., None]
    uv_y = fastmath.sum3(v2p * p) / torch.clamp(fastmath.sum3(v2p * v2p),
                                                min=1e-20)
    uv_x = (fastmath.sum3(v1 * p) * inv_dot_v1_v1
            - dot_v1_v2 * inv_dot_v1_v1 * uv_y)
    uv = torch.stack([uv_x, uv_y], dim=-1)

    # sdsquare: signed distance to the unit square (ltc.wgsl:65-69)
    q = (uv - 0.5).abs() - 0.5
    sd = _norm(_relu(q)) + torch.clamp(
        torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    sigma = dist_x_area.abs() / torch.clamp(denom ** 0.75, min=1e-20)
    sigma = sigma + _relu(sd)

    def gaussian_kernel(x, s):
        si = 1.0 / torch.clamp(s, min=1e-8)
        return 0.39894 * torch.exp(-0.5 * x * x * si * si) * si

    y0 = gaussian_kernel(0.0, sigma)
    xs = [gaussian_kernel(y0 * f, sigma) for f in (0.25, 0.5, 0.75)]

    size = scene.textures.size[tex_id.long()].to(torch.float32)
    col = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32,
                      device=uv.device)
    for xk in xs:
        # textureSampleGrad footprint 0.5 * xk in uv -> mip level
        rho = 0.5 * xk * torch.maximum(size[..., 0], size[..., 1])
        lod = torch.clamp(torch.log2(torch.clamp(rho, min=1e-8)), 0.0, 16.0)
        col = col + sample_trilinear(scene.textures, tex_id, uv,
                                     lod)[..., :3] * 0.333
    return col


def _solve_cubic(c0, c1, c2, c3=1.0):
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
    disc = _relu(4.0 * d1 * d3 - d2 * d2)
    sq_disc = fastmath.sqrt(disc)

    # algorithm A (largest root)
    d_a = -2.0 * B * d1 + d2
    theta_a = torch.atan2(sq_disc, -d_a) / 3.0
    sc_a = 2.0 * fastmath.sqrt(_relu(-d1))
    x1a = sc_a * torch.cos(theta_a)
    x3a = sc_a * torch.cos(theta_a + 2.0 * np.pi / 3.0)
    xl = torch.where(x1a + x3a > 2.0 * B, x1a, x3a)
    xl_num, xl_den = xl - B, torch.ones_like(xl) * c3

    # algorithm D (smallest root)
    d_d = -D * d2 + 2.0 * C * d3
    theta_d = torch.atan2(D * sq_disc, -d_d) / 3.0
    sc_d = 2.0 * fastmath.sqrt(_relu(-d3))
    x1d = sc_d * torch.cos(theta_d)
    x3d = sc_d * torch.cos(theta_d + 2.0 * np.pi / 3.0)
    xs = torch.where(x1d + x3d < 2.0 * C, x1d, x3d)
    xs_num, xs_den = -D, xs + C

    e = xl_den * xs_den
    f = -xl_num * xs_den - xl_den * xs_num
    g = xl_num * xs_num
    xm_num, xm_den = C * f - B * g, -B * f + C * e

    rx = xs_num / _guard(xs_den, 1e-20)
    ry = xm_num / _guard(xm_den, 1e-20)
    rz = xl_num / _guard(xl_den, 1e-20)
    # partial sort (ring_light.wgsl:178-184): [1] is the middle root
    x_small = (rx < ry) & (rx < rz)
    z_small = (rz < rx) & (rz < ry)
    r0 = torch.where(x_small, ry, rx)
    r1 = torch.where(x_small, rx, torch.where(z_small, rz, ry))
    r2 = torch.where(z_small, ry, rz)
    return r0, r1, r2


def _ltc_basis(nor, view, mminv):
    """mminv @ [T1; T2; N], the view-aligned tangent frame's rows."""
    t1v = fastmath.normalize(view - nor * fastmath.sum3(view * nor)[..., None])
    t2v = fastmath.cross(nor, t1v)
    basis = torch.stack([t1v, t2v, nor], dim=-2)  # rows T1, T2, N
    return fastmath.mat3_mat3(mminv, basis)


def ltc_evaluate_disk(scene: SceneData, nor, view, pos, mminv, points3,
                      two_sided=False):
    """EXACT clipped-disk (ellipse) LTC evaluation: the analytic sphere
    form factor of the cosine-space ellipse (ltc_evaluate_ring,
    ring_light.wgsl:189-305: ellipse eigen-decomposition, cubic solve,
    tabulated horizon-clipped sphere). points3: (3, 3) corners (-ex-ey,
    +ex-ey, +ex+ey) of the disk's bounding rect; pixel fields (..., 3)."""
    minv = _ltc_basis(nor, view, mminv)
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
    det = fastmath.sqrt(_relu(d11 * d22 - d12 * d12))
    u = 0.5 * fastmath.sqrt(_relu(tr - 2.0 * det))
    w = 0.5 * fastmath.sqrt(_relu(tr + 2.0 * det))
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
    ll_safe = _guard(ll, 1e-20)
    x0 = fastmath.sum3(v1 * c) / ll_safe
    y0 = fastmath.sum3(v2 * c) / ll_safe

    a = a * ll * ll
    b = b * ll * ll

    c0 = a * b
    c1 = a * b * (1.0 + x0 * x0 + y0 * y0) - a - b
    c2 = 1.0 - a * (1.0 + x0 * x0) - b * (1.0 + y0 * y0)
    e1, e2, e3 = _solve_cubic(c0, c1, c2)

    avg_x = a * x0 / _guard(a - e2, 1e-20)
    avg_y = b * y0 / _guard(b - e2, 1e-20)
    # rotate = columns (V1, V2, V3): avg_world = V1 ax + V2 ay + V3 az
    avg_dir = fastmath.normalize(v1 * avg_x[..., None] + v2 * avg_y[..., None]
                                 + v3 * torch.ones_like(x0)[..., None])

    l1f = fastmath.sqrt(_relu(-e2 / _guard(e3, 1e-20)))
    l2f = fastmath.sqrt(_relu(-e2 / _guard(e1, 1e-20)))
    form = l1f * l2f / fastmath.sqrt((1.0 + l1f * l1f) * (1.0 + l2f * l2f))

    uv = torch.stack([avg_dir[..., 2] * 0.5 + 0.5, form], dim=-1)
    uv = uv * LUT_SCALE + LUT_BIAS
    return form * _lut_scale(scene, uv) * occlusion


def disk_points3(center, dirx, diry, halfx, halfy):
    """(3, 3) f32 numpy corner triple (-ex-ey, +ex-ey, +ex+ey) of a disk's
    bounding rect (init_disk_points, ring_light.wgsl:69-80)."""
    center = np.asarray(center, np.float32)
    ex = float(halfx) * np.asarray(dirx, np.float32)
    ey = float(halfy) * np.asarray(diry, np.float32)
    return np.stack([center - ex - ey, center + ex - ey, center + ex + ey])


def ltc_evaluate_ring2(scene: SceneData, nor, view, pos, mminv, center, dirx,
                       diry, halfx, halfy, two_sided=False):
    """Annulus = full disk minus a shrunk inner disk (ltc_evaluate_ring2,
    ring_light.wgsl:307-321): the outer disk is the UN-grown `disk` (the
    grown disk1 is dead code in the reference), the inner shrinks by
    clamp(0.5, 0.05, 0.95 * half)."""
    r, eps = 0.5, 0.05
    dx = float(np.clip(r, eps, 0.95 * halfx))
    dy = float(np.clip(r, eps, 0.95 * halfy))
    dev = pos.device
    p_out = torch.from_numpy(disk_points3(center, dirx, diry, halfx,
                                          halfy)).to(dev)
    p_in = torch.from_numpy(disk_points3(center, dirx, diry, halfx - dx,
                                         halfy - dy)).to(dev)
    return (ltc_evaluate_disk(scene, nor, view, pos, mminv, p_out, two_sided)
            - ltc_evaluate_disk(scene, nor, view, pos, mminv, p_in,
                                two_sided))


def ltc_evaluate_polygon(scene: SceneData, nor, view, pos, mminv, points,
                         two_sided=False):
    """N-vertex generalization of ltc_evaluate_rect; a ring as outer
    polygon minus inner polygon is an approximation (only the vector form
    factor is linear in the edge integral) that the exact disk replaced.
    points: (P, 3), counter-clockwise."""
    P = points.shape[-2]
    minv = _ltc_basis(nor, view, mminv)
    rel = points[..., None, :, :] - pos[..., None, :]  # (..., P, 3)
    Ln = [fastmath.normalize(fastmath.mat3_vec(minv, rel[..., p, :]))
          for p in range(P)]
    direction = points[..., 0, :] - pos
    light_normal = fastmath.cross(points[..., 1, :] - points[..., 0, :],
                                  points[..., P - 1, :] - points[..., 0, :])
    behind = fastmath.sum3(direction * light_normal) < 0.0

    vsum = 0.0
    for p in range(P):
        vsum = vsum + integrate_edge(Ln[p], Ln[(p + 1) % P])
    length = _norm(vsum)
    z = vsum[..., 2] / torch.clamp(length, min=1e-20)
    z = torch.where(behind, -z, z)
    uv = torch.stack([z * 0.5 + 0.5, length], dim=-1) * LUT_SCALE + LUT_BIAS
    total = length * _lut_scale(scene, uv)
    if not two_sided:
        total = torch.where(behind, 0.0, total)
    return total


def ring_points(center, normal_dir, radius, n=16):
    """CCW n-gon approximating a disk boundary (host-side numpy)."""
    normal_dir = np.asarray(normal_dir, np.float32)
    normal_dir = normal_dir / np.linalg.norm(normal_dir)
    up = np.array([0, 1, 0], np.float32)
    if abs(np.dot(up, normal_dir)) > 0.99:
        up = np.array([1, 0, 0], np.float32)
    t = np.cross(up, normal_dir)
    t /= np.linalg.norm(t)
    b = np.cross(normal_dir, t)
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return (np.asarray(center, np.float32)
            + radius * (np.cos(a)[:, None] * t + np.sin(a)[:, None] * b)
            ).astype(np.float32)


def shade_ring_light(scene: SceneData, gbuffer, camera,
                     disk_center=(-3.0, 3.5, 10.0),
                     disk_dirx=(1.0, 0.0, 0.0), disk_diry=(0.0, 1.0, 0.0),
                     halfx=3.0, halfy=3.0, roughness=0.3, two_sided=True,
                     albedo=None):
    """Deferred shading with one LTC ring light, the ring_light demo's FS
    (src/bin/ring_light.wgsl:340-440), quirks kept:

    * the pixel ray (from the shaded point TOWARD the camera) is
      intersected with the disk plane; hits inside the annulus band
      0.7 <= (x/hx)^2 + (y/hy)^2 <= 1 render as the emitter;
    * material 0 renders flat 0.13 grey, LIGHT_MATERIAL albedo + emissive;
    * spec = ltc_evaluate_ring2 (full disk minus shrunk disk) * t2.x with
      the fitted Minv at a fixed roughness; diffuse = the FULL disk with
      the identity matrix (the reference's diffuse is the whole disk, not
      the annulus);
    * color = spec + diffuse (scolor = dcolor = 1; albedo unused).

    Returns (H, W, 3) HDR."""
    depth = gbuffer.depth
    material_id = gbuffer.material.long()
    dev = depth.device
    uv = encoding.unpack2x16float(gbuffer.normal_uv[..., 1])
    nor = encoding.decode_octahedral_32(gbuffer.normal_uv[..., 0])
    mats = scene.materials
    mat_albedo = mats.albedo[material_id]
    sizes = scene.textures.size[mat_albedo.long()].to(torch.float32)
    lod = uv_lod(uv, sizes[..., 0], sizes[..., 1])
    if albedo is None:
        albedo = sample_trilinear(scene.textures, mat_albedo, uv, lod)
    emissive = sample_trilinear(scene.textures, mats.emissive[material_id],
                                uv, lod)[..., :3]
    pos = world_position_from_depth(depth, camera.clip_to_world)
    cam_pos = torch.as_tensor(np.asarray(camera.position, np.float32)[:3],
                              device=dev)
    rd = fastmath.normalize(cam_pos - pos)

    center = np.asarray(disk_center, np.float32)
    dirx = np.asarray(disk_dirx, np.float32)
    diry = np.asarray(disk_diry, np.float32)
    dn = np.cross(dirx, diry)

    rough = torch.full(depth.shape, float(roughness), dtype=torch.float32,
                       device=dev)
    minv, _t1, t2 = ltc_matrix(scene, nor, rd, rough)
    identity = torch.eye(3, dtype=torch.float32, device=dev).expand(
        minv.shape)

    spec = ltc_evaluate_ring2(scene, nor, rd, pos, minv, center, dirx, diry,
                              halfx, halfy, two_sided=two_sided) * t2[..., 0]
    diff = ltc_evaluate_disk(
        scene, nor, rd, pos, identity,
        torch.from_numpy(disk_points3(center, dirx, diry, halfx,
                                      halfy)).to(dev),
        two_sided=two_sided)
    lit = _relu(spec + diff)[..., None].expand(
        depth.shape + (3,))

    # ray_disc_intersect (ring_light.wgsl:82-98) with Ray2(pos, rd)
    plane_n = torch.from_numpy(dn).to(dev)
    denom = fastmath.sum3(rd * plane_n)
    t_hit = -(fastmath.sum3(pos * plane_n) - float(np.dot(dn, center))) / (
        _guard(denom, 1e-12))
    hit_p = pos + rd * t_hit[..., None]
    lp = hit_p - torch.from_numpy(center).to(dev)
    hx = fastmath.sum3(lp * torch.from_numpy(dirx).to(dev)) / halfx
    hy = fastmath.sum3(lp * torch.from_numpy(diry).to(dev)) / halfy
    ab = hx * hx + hy * hy
    disk_hit = (t_hit > 0.0) & (ab >= 0.7) & (ab <= 1.0)

    grey = torch.tensor([0.13, 0.13, 0.13], device=dev)
    emit = albedo[..., :3] + emissive
    out = torch.where((material_id == 0)[..., None], grey, lit)
    out = torch.where((material_id == LIGHT_MATERIAL)[..., None], emit, out)
    out = torch.where(disk_hit[..., None], emit, out)
    return _relu(out)
