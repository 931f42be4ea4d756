"""Visibility-buffer -> G-buffer resolve.

Counterpart of ``voidin_tpu/passes/resolve.py`` ``resolve_gbuffer``: the
dense per-pixel path and, for alpha-masked scenes, the runner-up fallback
(lazy compacted batch by default, dense two-pass twin). Per winning pixel it
recomputes perspective-correct barycentrics from the resolve record and
evaluates the reference's attribute math (visibility.wgsl:66-97):
* normal matrix = upper-left 3x3 of the instance transform (not inverse
  transpose) — visibility.wgsl:43-46;
* bitangent = cross(normal, tangent) * tangent.w — visibility.wgsl:47;
* normal map applied iff material.normal != 0 (WHITE) — visibility.wgsl:83-89;
* alpha cutoff: base_color.w < 0.5 || albedo.a < 0.5 -> background;
* G-buffer = (octahedral normal u32, pack2x16float uv, material id, depth).
It also produces the per-pixel material fields the shading pass consumes
(ResolveAux), so shading reads no material table. With
RasterConfig.slim_rec the resolve record is the slim 96 B row (world-space
normals and the material scalars ride in it) and resolve fetches one row
per pixel, or none where K1 handed over the winner's record
(RasterConfig.kernel_payload, VisBuffer.payload_img).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import checks, encoding, fastmath
from ..scene.scene import SceneData
from ..scene.texture import sample_trilinear
from .gbuffer import GBuffer, VisBuffer
from .shading import pixel_rows, uv_lod


@dataclasses.dataclass
class ResolveAux:
    """Per-pixel material fields for the shading pass."""

    albedo: torch.Tensor  # (H, W, 4) filtered albedo (shading.wgsl:58)
    emissive: torch.Tensor  # (H, W, 3)
    mr: torch.Tensor  # (H, W, 4) metallic-roughness texel
    # () alpha-fallback pixels beyond capacity (lazy path), else None
    overflow: Optional[torch.Tensor] = None
    # () pixels whose winner was alpha-cut, and those of them resolved to
    # the runner-up (alpha-masked scenes), else None
    cut: Optional[torch.Tensor] = None
    fallback: Optional[torch.Tensor] = None


def _normalize(v, eps=1e-20):
    return v / fastmath.sqrt(torch.clamp(_sum_last(v * v), min=eps))[..., None]


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


def _inst_rec_f16(scene: SceneData):
    """The fused instance record as f16 pairs in 12 u32 columns (int32
    bits), (instances, 12): what RasterConfig.slim_rec threads through the
    draw record. f16 keeps ids exact only below 2048, so larger material
    or texture pools raise."""
    n_mats = scene.materials.albedo.shape[0]
    n_tex = scene.textures.size.shape[0]
    if n_mats > 2048 or n_tex > 2048:
        raise ValueError(
            f"inst_rec_f16 requires material/texture ids < 2048 (f16 "
            f"integer exactness); scene has {n_mats} materials / "
            f"{n_tex} textures")
    rec = _inst_rec(scene).to(torch.float16)  # (N, 24)
    return rec.contiguous().view(torch.int32)  # (N, 12)


def _fetch_rows(scene: SceneData, vis: VisBuffer, tri_id,
                slim: bool = False):
    """The per-pixel row fetches: resolve record, packed corner-attribute
    row (u32 bits as int32), fused instance+material record. With `slim`
    the slim record alone: K1's payload image where it covers these
    pixels (RasterConfig.kernel_payload), else the record gather."""
    if (slim and vis.payload_img is not None
            and tri_id.shape == vis.payload_img.shape[:-1]):
        return dict(rec=vis.payload_img)
    tid = torch.clamp(tri_id.to(torch.int64), min=0)
    rec = vis.resolve_rec[
        checks.check_index(tid, vis.resolve_rec.shape[0], "resolve.rec")
    ]  # (*S, 12 | 24)
    if slim:
        return dict(rec=rec)
    tri_pool = (rec[..., 10] / 3.0).to(torch.int64)  # idx_start / 3
    pk = scene.meshes.tri_attr_packed[checks.check_index(
        tri_pool, scene.meshes.tri_attr_packed.shape[0], "resolve.tri_attr")
    ]  # (*S, 12)
    inst = checks.check_index(rec[..., 9].to(torch.int64),
                              scene.instances.count, "resolve.instance")
    irec = _inst_rec(scene)[inst]  # (*S, 24)
    return dict(rec=rec, pk=pk, irec=irec)


def _decode_slim_channels(rows):
    """Slim-record decode (RasterConfig.slim_rec): clip and uv straight
    off the f32 columns, corner normals already in world space (oct32,
    columns 15:18), and the 12 f16 material scalars (columns 18:24)."""
    rec = rows["rec"]
    S = rec.shape[:-1]
    n_c = encoding.decode_octahedral_32(
        rec[..., 15:18].contiguous().view(torch.int32))
    pay = rec[..., 18:24].contiguous().view(torch.float16)
    return dict(cl=rec[..., :9], uv_c=rec[..., 9:15],
                n_c=n_c.reshape(S + (9,)), pay=pay.to(torch.float32))


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
                  y_ndc, want_aux: bool = True, lod_probe=None,
                  slim: bool = False):
    """Per-pixel resolve for any pixel-set shape S: unmasked fields plus
    the keep/cut masks. x_ndc / y_ndc broadcast to S. `lod_probe`: None
    takes the mip lod from image-space finite differences (S = (H, W));
    (dx, dy) NDC steps take it from analytic within-triangle barycentric
    probes (any S), as the flat fallback batch does. `slim`: the rows are
    slim records (RasterConfig.slim_rec)."""
    S = tri_id.shape
    hit = tri_id >= 0
    # the fetched rows die with the decode (the packed attribute rows are
    # not needed past it); tangents feed only the normal-map TBN transform
    if slim:
        if not scene.no_normal_maps:
            raise ValueError("slim_rec requires a scene with no normal maps")
        channels = _decode_slim_channels(
            _fetch_rows(scene, vis, tri_id, slim=True))
    else:
        channels = _decode_channels(_fetch_rows(scene, vis, tri_id),
                                    not scene.no_normal_maps)
    cl = channels["cl"].reshape(S + (3, 3))

    # Perspective-correct barycentrics via 2D homogeneous coordinates.
    def bary(xn, yn):
        u = cl[..., 0] - xn[..., None] * cl[..., 2]
        v = cl[..., 1] - yn[..., None] * cl[..., 2]
        bc = fastmath.cross(u, v)
        bsum = _sum_last(bc)[..., None]
        sign = torch.where(bsum < 0, -1.0, 1.0)
        return bc * sign / torch.clamp(bsum * sign, min=1e-20)

    def interp(corners, lam):  # (*S, 3, C) corners -> (*S, C)
        return _sum_last((corners * lam[..., None]).movedim(-2, -1))

    lam_p = bary(x_ndc, y_ndc)
    uv_c = channels["uv_c"].reshape(S + (3, 2))
    n_c = channels["n_c"].reshape(S + (3, 3))
    normal_raw = interp(n_c, lam_p)
    uv = interp(uv_c, lam_p)

    if slim:
        # corner normals went to world space at setup; the f16 payload
        # carries the material scalars
        pay = channels["pay"]
        material_id = pay[..., 0].to(torch.int32)
        mat_albedo = pay[..., 1].to(torch.int64)
        base_color_a = pay[..., 11]
        n_ws = normal_raw
        tex_w = pay[..., 2]
        tex_h = pay[..., 3]
    else:
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
    if lod_probe is None:
        lod = uv_lod(uv, tex_w, tex_h)
    else:
        dxn, dyn = lod_probe
        du = interp(uv_c, bary(x_ndc + dxn, y_ndc)) - uv
        dv = interp(uv_c, bary(x_ndc, y_ndc - dyn)) - uv
        rho = torch.maximum(
            du[..., 0].abs() * tex_w + du[..., 1].abs() * tex_h,
            dv[..., 0].abs() * tex_w + dv[..., 1].abs() * tex_h,
        )
        lod = torch.clamp(torch.log2(torch.clamp(rho, min=1e-8)), 0.0, 16.0)

    albedo = sample_trilinear(scene.textures, mat_albedo, uv, lod,
                              wh=(tex_w, tex_h), srgb=scene.albedo_srgb)
    n_geo = _normalize(n_ws)
    if scene.no_normal_maps:
        normal = n_geo
    else:
        t_c = channels["t_c"].reshape(S + (3, 3))
        tangent_raw = interp(t_c, lam_p)
        tangent_w = _sum_last(channels["t_sign"] * lam_p)
        t_ws = fastmath.mat3_vec(basis, tangent_raw)
        b_ws = fastmath.cross(n_ws, t_ws) * tangent_w[..., None]
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
        cut=cut,
    )
    if not want_aux:
        return out

    # Shading-pass material fields: background / cut pixels revert to the
    # material-0 lookup the reference makes from its cleared G-buffer;
    # emissive / mr are const-folded or sampled at the pack2x16float-
    # quantized uv the reference shading FS reads back.
    mats = scene.materials
    out["albedo"] = torch.where(keep[..., None], albedo,
                                torch.ones_like(albedo))
    if slim:
        if not (scene.emissive_const and scene.mr_const):
            raise ValueError(
                "slim_rec requires const-folded emissive/metallic-roughness")
        out["emissive"] = torch.where(keep[..., None], pay[..., 4:7],
                                      mats.emissive_rgba[0, :3])
        out["mr"] = torch.where(keep[..., None], pay[..., 7:11],
                                mats.mr_rgba[0])
        return out
    mat_emissive = irec[..., 13].to(torch.int64)
    mat_mr = irec[..., 14].to(torch.int64)
    if not (scene.emissive_const and scene.mr_const):
        uv_s = encoding.unpack2x16float(out["packed_uv"])
        if lod_probe is None:
            lod_s = uv_lod(uv_s, torch.where(keep, tex_w, 1.0),
                           torch.where(keep, tex_h, 1.0))
        else:
            lod_s = lod  # flat batch: reuse the analytic lod
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


def _assemble(fields, **counts):
    gbuffer = GBuffer(
        normal_uv=torch.stack([fields["packed_n"], fields["packed_uv"]],
                              dim=-1),
        material=fields["material"],
        depth=fields["depth"],
    )
    aux = ResolveAux(albedo=fields["albedo"], emissive=fields["emissive"],
                     mr=fields["mr"], **counts)
    return gbuffer, aux


# Packed fallback row: the flat batch's fields return to the image through
# ONE row scatter. u32 bits held as int32 (the port's convention):
# [n, uv, material, depth, albedo*4, emissive*3, mr*4, processed flag].
_FB_F = 16


def _pack_fallback_rows(fields):
    def bits(x):
        return x.to(torch.float32).view(torch.int32)

    cols = [fields["packed_n"], fields["packed_uv"],
            fields["material"].to(torch.int32), bits(fields["depth"])]
    cols += [bits(fields["albedo"][..., c]) for c in range(4)]
    cols += [bits(fields["emissive"][..., c]) for c in range(3)]
    cols += [bits(fields["mr"][..., c]) for c in range(4)]
    cols.append(torch.ones_like(fields["packed_n"]))
    return torch.stack(cols, dim=-1)  # (F, 16) int32


def _unpack_fallback(img):
    def f32(x):
        return x.contiguous().view(torch.float32)

    return dict(
        packed_n=img[..., 0],
        packed_uv=img[..., 1],
        material=img[..., 2],
        depth=f32(img[..., 3]),
        albedo=f32(img[..., 4:8]),
        emissive=f32(img[..., 8:11]),
        mr=f32(img[..., 11:15]),
        flag=img[..., 15] > 0,
    )


def resolve_gbuffer(scene: SceneData, vis: VisBuffer, config, row0: int = 0,
                    height=None, rows=None):
    """Resolve the winning candidate per pixel. Returns (GBuffer,
    ResolveAux). With a runner-up in `vis` (RasterConfig.alpha_mask),
    pixels whose winner is alpha-cut fall back to the runner-up —
    visibility.wgsl:79-81 `discard`, where a cut fragment writes no depth
    and the triangle behind it stays visible. One level of fallback: a
    cutout behind a cutout resolves to background. `lazy_alpha_resolve`
    resolves the fallback on a compacted flat batch of the cut pixels
    (capacity alpha_fallback_capacity, overflow counted in
    ResolveAux.overflow); otherwise every pixel is resolved twice.

    Row window (a slab of the sharded frame): `vis` holds the image rows
    [row0, row0 + H) of a `height`-row image (default H), and `rows =
    (lo, hi)` names the window rows that are the caller's own; the rows
    around them are halo. Every row is resolved, the halo's fallbacks
    included; the mip level's finite difference makes a window's last row
    exact only where it is the image's last, so the caller gives it one
    row of halo below. The counts (cut, fallback and overflow, the
    fallback pixels left unresolved) are those of the own rows, and the
    fallback capacity is the whole image's."""
    H, W = vis.depth.shape
    dev = vis.depth.device
    height = H if height is None else height
    x_ndc = ((torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
             * 2.0 - 1.0)[None, :].expand(H, W)
    y_ndc = (1.0 - pixel_rows(H, dev, row0, height) * 2.0)[:, None].expand(
        H, W)

    slim = config.slim_rec

    def dense_fields(tri_id, depth, want_aux=True):
        return _pixel_fields(scene, vis, tri_id, depth, x_ndc, y_ndc,
                             want_aux=want_aux, slim=slim)

    if vis.tri_id2 is None:
        return _assemble(dense_fields(vis.tri_id, vis.depth))

    if not config.lazy_alpha_resolve:
        # Dense two-pass fallback (the lazy path's oracle twin): pass 1
        # finds cut winners, pass 2 re-resolves every pixel with the
        # runner-up substituted.
        f1 = dense_fields(vis.tri_id, vis.depth, want_aux=False)
        fall = (vis.tri_id >= 0) & f1["cut"]
        tid = torch.where(fall, vis.tri_id2, vis.tri_id)
        dep = torch.where(fall, vis.depth2, vis.depth)
        n_fall = _own(fall, rows).sum()
        return _assemble(dense_fields(tid, dep), cut=n_fall, fallback=n_fall)

    # Lazy fallback: full resolve of the winners (the final result for
    # every non-cut pixel), then a compacted flat batch over the cut
    # pixels only, scattered back as packed rows.
    f1 = dense_fields(vis.tri_id, vis.depth)
    fall = (vis.tri_id >= 0) & f1["cut"]
    F = config.alpha_fallback_capacity or max((height * W) // 16, 1024)

    flat = fall.reshape(-1)
    count = flat.sum()
    idx = fastmath.compact_indices(flat, F)  # (F,) pixel indices
    valid = torch.arange(F, device=dev) < torch.clamp(count, max=F)
    tid2 = torch.where(valid, vis.tri_id2.reshape(-1)[idx], -1)
    dep2 = vis.depth2.reshape(-1)[idx]
    fx = (idx % W).to(torch.float32)
    fy = (idx // W + row0).to(torch.float32)
    xb = (fx + 0.5) / W * 2.0 - 1.0
    yb = 1.0 - (fy + 0.5) / height * 2.0
    fb = _pixel_fields(scene, vis, tid2, dep2, xb, yb,
                       lod_probe=(2.0 / W, 2.0 / height), slim=slim)
    fb_rows = _pack_fallback_rows(fb)

    # invalid slots write the extra row H*W, which is dropped
    buf = torch.zeros(H * W + 1, _FB_F, dtype=torch.int32, device=dev)
    buf[torch.where(valid, idx, H * W)] = fb_rows
    fbimg = _unpack_fallback(buf[: H * W].reshape(H, W, _FB_F))
    use = fall & fbimg["flag"]

    merged = dict(f1)
    for k in ("packed_n", "packed_uv", "material", "depth"):
        merged[k] = torch.where(use, fbimg[k], f1[k])
    for k in ("albedo", "emissive", "mr"):
        merged[k] = torch.where(use[..., None], fbimg[k], f1[k])
    # overflow: the cut pixels left unresolved (count - F on a whole image)
    return _assemble(merged, overflow=_own(fall & ~use, rows).sum(),
                     cut=_own(fall, rows).sum(),
                     fallback=_own(use, rows).sum())


def _own(mask, rows):
    """The rows (lo, hi) of an (H, W) mask, or all of it for None."""
    return mask if rows is None else mask[rows[0]:rows[1]]
