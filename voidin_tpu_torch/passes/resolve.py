"""Visibility-buffer -> G-buffer resolve, default dense path.

Counterpart of ``voidin_tpu/passes/resolve.py`` ``resolve_gbuffer`` for a
scene without alpha masking (no runner-up candidate). Per winning pixel it
recomputes perspective-correct barycentrics from the resolve record and
evaluates the reference's attribute math (visibility.wgsl:66-97):
* normal matrix = upper-left 3x3 of the instance transform (not inverse
  transpose) — visibility.wgsl:43-46;
* bitangent = cross(normal, tangent) * tangent.w — visibility.wgsl:47;
* normal map applied iff material.normal != 0 (WHITE) — visibility.wgsl:83-89;
* alpha cutoff: base_color.w < 0.5 || albedo.a < 0.5 -> background;
* G-buffer = (octahedral normal u32, pack2x16float uv, material id, depth).
It also produces the per-pixel material fields the shading pass consumes
(ResolveAux), so shading reads no material table.
"""

from __future__ import annotations

import dataclasses
import torch

from ..core import encoding, fastmath
from ..scene.scene import SceneData
from ..scene.texture import sample_trilinear
from .gbuffer import GBuffer, VisBuffer
from .shading import uv_lod


@dataclasses.dataclass
class ResolveAux:
    """Per-pixel material fields for the shading pass."""

    albedo: torch.Tensor  # (H, W, 4) filtered albedo (shading.wgsl:58)
    emissive: torch.Tensor  # (H, W, 3)
    mr: torch.Tensor  # (H, W, 4) metallic-roughness texel


def _normalize(v, eps=1e-20):
    return v / fastmath.sqrt(torch.clamp(_sum_last(v * v), min=eps))[..., None]


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _sum_last(a):
    """Sequential sum over a small trailing axis (term order of the JAX
    package's reductions)."""
    acc = a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
    return acc


def _inst_rec(scene: SceneData):
    """ONE fused per-instance record: transform basis + the full material
    row (24 f32)."""
    n_inst = scene.instances.count
    mats = scene.materials
    mid = scene.instances.material_id.to(torch.int64)
    alb = mats.albedo.to(torch.int64)[mid]
    albedo_sz = scene.textures.size[alb].to(torch.float32)
    return torch.cat(
        [
            scene.instances.transform[:, :3, :3].reshape(n_inst, 9),
            mid.to(torch.float32)[:, None],
            alb.to(torch.float32)[:, None],
            mats.normal[mid].to(torch.float32)[:, None],
            mats.base_color[mid, 3][:, None],
            mats.emissive[mid].to(torch.float32)[:, None],
            mats.metallic_roughness[mid].to(torch.float32)[:, None],
            albedo_sz,
            mats.emissive_rgba[mid, :3],
            mats.mr_rgba[mid],
        ],
        dim=-1,
    )  # (N, 24)


def _fetch_rows(scene: SceneData, vis: VisBuffer, tri_id):
    """The per-pixel row fetches: resolve record, packed corner-attribute
    row (u32 bits as int32), fused instance+material record."""
    tid = torch.clamp(tri_id.to(torch.int64), min=0)
    rec = vis.resolve_rec[tid]  # (*S, 12)
    tri_pool = (rec[..., 10] / 3.0).to(torch.int64)  # idx_start / 3
    pk = scene.meshes.tri_attr_packed[tri_pool]  # (*S, 12)
    inst = rec[..., 9].to(torch.int64)
    irec = _inst_rec(scene)[inst]  # (*S, 24)
    return dict(rec=rec, pk=pk, irec=irec)


def _decode_channels(rows, tangents: bool = True):
    """Row tables -> f32 channels: cl (clip x/y/w per vertex), uv_c, n_c,
    t_c/t_sign (when tangents) and irec."""
    rec = rows["rec"]
    S = rec.shape[:-1]
    pk = rows["pk"]
    uv_c = pk[..., 0:6].contiguous().view(torch.float32)
    n_c = encoding.decode_octahedral_32(pk[..., 6:9])
    out = dict(cl=rec[..., :9], uv_c=uv_c, n_c=n_c.reshape(S + (9,)),
               irec=rows["irec"])
    if tangents:
        t_enc = pk[..., 9:12]
        out["t_sign"] = 1.0 - 2.0 * (t_enc & 1).to(torch.float32)
        out["t_c"] = encoding.decode_octahedral_32(t_enc).reshape(S + (9,))
    return out


def _pixel_fields(scene: SceneData, vis: VisBuffer, tri_id, depth, x_ndc,
                  y_ndc):
    """Per-pixel resolve over the (H, W) image: unmasked fields + masks."""
    S = tri_id.shape
    hit = tri_id >= 0
    # tangents feed only the normal-map TBN transform
    tangents = not scene.no_normal_maps
    channels = _decode_channels(_fetch_rows(scene, vis, tri_id), tangents)
    cl = channels["cl"].reshape(S + (3, 3))

    # Perspective-correct barycentrics via 2D homogeneous coordinates.
    u = cl[..., 0] - x_ndc[..., None] * cl[..., 2]
    v = cl[..., 1] - y_ndc[..., None] * cl[..., 2]
    bc = _cross(u, v)
    bsum = _sum_last(bc)[..., None]
    sign = torch.where(bsum < 0, -1.0, 1.0)
    lam_p = bc * sign / torch.clamp(bsum * sign, min=1e-20)

    uv_c = channels["uv_c"].reshape(S + (3, 2))
    n_c = channels["n_c"].reshape(S + (3, 3))
    normal_raw = _sum_last((n_c * lam_p[..., None]).movedim(-2, -1))
    uv = _sum_last((uv_c * lam_p[..., None]).movedim(-2, -1))

    irec = channels["irec"]
    basis = irec[..., :9].reshape(S + (3, 3))
    material_id = irec[..., 9].to(torch.int32)
    mat_albedo = irec[..., 10].to(torch.int64)
    mat_normal = irec[..., 11].to(torch.int64)
    base_color_a = irec[..., 12]
    # Object -> world with the plain upper 3x3 (reference parity).
    n_ws = fastmath.mat3_vec(basis, normal_raw)
    tex_w = irec[..., 15]
    tex_h = irec[..., 16]
    lod = uv_lod(uv, tex_w, tex_h)

    albedo = sample_trilinear(scene.textures, mat_albedo, uv, lod,
                              wh=(tex_w, tex_h), srgb=scene.albedo_srgb)
    n_geo = _normalize(n_ws)
    if scene.no_normal_maps:
        normal = n_geo
    else:
        t_c = channels["t_c"].reshape(S + (3, 3))
        tangent_raw = _sum_last((t_c * lam_p[..., None]).movedim(-2, -1))
        tangent_w = _sum_last(channels["t_sign"] * lam_p)
        t_ws = fastmath.mat3_vec(basis, tangent_raw)
        b_ws = _cross(n_ws, t_ws) * tangent_w[..., None]
        normal_tex = sample_trilinear(scene.textures, mat_normal, uv, lod,
                                      srgb=scene.normal_srgb)
        tbn_t = _normalize(t_ws)
        tbn_b = _normalize(b_ws)
        mapped = (
            tbn_t * (normal_tex[..., 0:1] * 2.0 - 1.0)
            + tbn_b * (normal_tex[..., 1:2] * 2.0 - 1.0)
            + n_geo * (normal_tex[..., 2:3] * 2.0 - 1.0)
        )
        use_map = (mat_normal != 0)[..., None]
        normal = _normalize(torch.where(use_map, mapped, n_geo))

    cut = (base_color_a < 0.5) | (albedo[..., 3] < 0.5)
    keep = hit & ~cut
    zero = torch.zeros((), dtype=torch.int32, device=tri_id.device)
    out = dict(
        packed_n=torch.where(keep, encoding.encode_octahedral_32(normal),
                             zero),
        packed_uv=torch.where(keep, encoding.pack2x16float(uv), zero),
        material=torch.where(keep, material_id, zero),
        depth=torch.where(keep, depth, 0.0),
        keep=keep,
    )

    # Shading-pass material fields: background / cut pixels revert to the
    # material-0 lookup the reference makes from its cleared G-buffer;
    # emissive / mr are const-folded or sampled at the pack2x16float-
    # quantized uv the reference shading FS reads back.
    mats = scene.materials
    out["albedo"] = torch.where(keep[..., None], albedo,
                                torch.ones_like(albedo))
    mat_emissive = irec[..., 13].to(torch.int64)
    mat_mr = irec[..., 14].to(torch.int64)
    if not (scene.emissive_const and scene.mr_const):
        uv_s = encoding.unpack2x16float(out["packed_uv"])
        lod_s = uv_lod(uv_s, torch.where(keep, tex_w, 1.0),
                       torch.where(keep, tex_h, 1.0))
    if scene.emissive_const:
        out["emissive"] = torch.where(keep[..., None], irec[..., 17:20],
                                      mats.emissive_rgba[0, :3])
    else:
        out["emissive"] = sample_trilinear(
            scene.textures,
            torch.where(keep, mat_emissive, mats.emissive[0].to(torch.int64)),
            uv_s, lod_s, srgb=scene.emissive_srgb,
        )[..., :3]
    if scene.mr_const:
        out["mr"] = torch.where(keep[..., None], irec[..., 20:24],
                                mats.mr_rgba[0])
    else:
        out["mr"] = sample_trilinear(
            scene.textures,
            torch.where(keep, mat_mr,
                        mats.metallic_roughness[0].to(torch.int64)),
            uv_s, lod_s, srgb=scene.mr_srgb,
        )
    return out


def resolve_gbuffer(scene: SceneData, vis: VisBuffer):
    """Resolve the winning candidate per pixel. Returns (GBuffer,
    ResolveAux). Alpha-masked scenes (runner-up fallback) are not part of
    the port yet."""
    if scene.alpha_masked:
        raise NotImplementedError(
            "alpha-masked scenes need the runner-up fallback, not ported"
        )
    H, W = vis.depth.shape
    dev = vis.depth.device
    x_ndc = ((torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
             * 2.0 - 1.0)[None, :].expand(H, W)
    y_ndc = (1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)
             / H * 2.0)[:, None].expand(H, W)
    f = _pixel_fields(scene, vis, vis.tri_id, vis.depth, x_ndc, y_ndc)
    gbuffer = GBuffer(
        normal_uv=torch.stack([f["packed_n"], f["packed_uv"]], dim=-1),
        material=f["material"],
        depth=f["depth"],
    )
    return gbuffer, ResolveAux(albedo=f["albedo"], emissive=f["emissive"],
                               mr=f["mr"])
