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
(ResolveAux), so shading reads no material table.

The default layout (takes_dense_kernel: no alpha mask, the 12-column
record, none of the options below, const-folded emissive and
metallic-roughness) resolves in one launch of the hand-written kernel
ops/resolve.py resolve_dense, whose twin on the CPU is this module's
chain; every other input runs the chain (_fetch_rows -> _decode_channels
-> _channel_fields) eagerly.

The JAX package's record layouts and coherent paths, by RasterConfig
field:
* slim_rec: the slim 96 B record (world-space normals and the material
  scalars ride in it), one row per pixel, or none where K1 handed over the
  winner's record (kernel_payload, VisBuffer.payload_img);
* inst_rec_f16: the fused instance record as f16 pairs in 12 words;
* fused_resolve_rec / fused_inst_rec: the corner-attribute row (and the
  f16 instance record) ride the resolve record from setup;
* quad_rate_resolve: the rows fetched once per uniform 2x2 quad, edge
  quads through a compacted batch (_quad_fetch);
* slot_resolve: the decoded channels fetched once per (8x16 tile,
  distinct triangle) and selected per pixel by a one-hot product
  (_slot_fetch_channels), overflowing tiles re-resolved per pixel;
* planar_resolve: accepted for the JAX package's config and resolved by
  the dense path, whose words the JAX package's planar twin gives.
The albedo tap is the per-pixel trilinear sample (texture.sample_trilinear)
on every path; the JAX package's quad-rate tap over 4x4 block tables
gives its words and is not ported.
The coherent paths give the words of the per-pixel path while their edge
batches hold; what overflows them is counted in ResolveAux.overflow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import checks, encoding, fastmath
from ..framework import profiler
from ..ops import fine_raster as fr
from ..ops import resolve as dense_op
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
    # () what overflowed a capacity: the alpha-fallback pixels beyond
    # alpha_fallback_capacity (lazy path) plus the quad / slot edge batches'
    # overflow; None on a dense path without a coherent fetch
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
    bits), (instances, 12), 48 B rows (RasterConfig.inst_rec_f16; threaded
    through the draw record by slim_rec and fused_inst_rec). f16 keeps ids
    and power-of-two texture extents exact, the basis and colours within
    ~1e-3; ids are exact only below 2048, so larger material or texture
    pools raise."""
    n_mats = scene.materials.albedo.shape[0]
    n_tex = scene.textures.size.shape[0]
    if n_mats > 2048 or n_tex > 2048:
        raise ValueError(
            f"inst_rec_f16 requires material/texture ids < 2048 (f16 "
            f"integer exactness); scene has {n_mats} materials / "
            f"{n_tex} textures — disable RasterConfig.inst_rec_f16")
    rec = _inst_rec(scene).to(torch.float16)  # (N, 24)
    return rec.contiguous().view(torch.int32)  # (N, 12)


def _fetch_rows(scene: SceneData, vis: VisBuffer, tri_id,
                inst_f16: bool = False, slim: bool = False):
    """The per-pixel row fetches for any pixel-set shape S, undecoded so
    the quad path can scatter them: rec, the resolve record (12, 24 or 36
    f32 columns); pk (*S, 12), the packed corner-attribute row (u32 bits
    as int32), from record columns 12:24 where fused_resolve_rec put it
    there, else from the pool; irec, the fused instance+material record,
    from record columns 24:36 where fused_inst_rec put it there, else
    gathered: (*S, 12) int32 f16 pairs with `inst_f16`, else (*S, 24)
    f32. With `slim` the slim record alone: K1's payload image where it
    covers these pixels (RasterConfig.kernel_payload), else the record
    gather."""
    if (slim and vis.payload_img is not None
            and tri_id.shape == vis.payload_img.shape[:-1]):
        return dict(rec=vis.payload_img)
    tid = torch.clamp(tri_id.to(torch.int64), min=0)
    rec = vis.resolve_rec[
        checks.check_index(tid, vis.resolve_rec.shape[0], "resolve.rec")
    ]  # (*S, 12 | 24 | 36)
    if slim:
        return dict(rec=rec)
    if rec.shape[-1] >= 24:
        pk = rec[..., 12:24].view(torch.int32)
    else:
        tri_pool = (rec[..., 10] / 3.0).to(torch.int64)  # idx_start / 3
        pk = scene.meshes.tri_attr_packed[checks.check_index(
            tri_pool, scene.meshes.tri_attr_packed.shape[0],
            "resolve.tri_attr")]  # (*S, 12)
    if rec.shape[-1] >= 36:
        # the words of the inst_f16 gather, carried as f32 columns
        return dict(rec=rec, pk=pk, irec=rec[..., 24:36].view(torch.int32))
    inst = checks.check_index(rec[..., 9].to(torch.int64),
                              scene.instances.count, "resolve.instance")
    table = _inst_rec_f16(scene) if inst_f16 else _inst_rec(scene)
    return dict(rec=rec, pk=pk, irec=table[inst])


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


def _f16_words(words):
    """(..., n) int32 words of f16 pairs -> (..., 2n) f32, each word's low
    half first."""
    return words.contiguous().view(torch.float16).to(torch.float32)


def _decode_channels(rows, inst_f16: bool = False, tangents: bool = True):
    """Row tables -> f32 channels of any shape S (trailing dims flat): cl
    (9, clip x/y/w per vertex), uv_c (6), n_c (9), irec (24; decoded from
    f16 pairs with `inst_f16`) and, when `tangents`, t_sign (3) and t_c
    (9). Elementwise, so it commutes with an exact selection (the slot
    path decodes at tile rate)."""
    rec = rows["rec"]
    S = rec.shape[:-1]
    pk = rows["pk"]
    uv_c = pk[..., 0:6].contiguous().view(torch.float32)
    n_c = encoding.decode_octahedral_32(pk[..., 6:9])
    irec = _f16_words(rows["irec"]) if inst_f16 else rows["irec"]
    out = dict(cl=rec[..., :9], uv_c=uv_c, n_c=n_c.reshape(S + (9,)),
               irec=irec)
    if tangents:
        t_enc = pk[..., 9:12]
        out["t_sign"] = 1.0 - 2.0 * (t_enc & 1).to(torch.float32)
        out["t_c"] = encoding.decode_octahedral_32(t_enc).reshape(S + (9,))
    return out


def _quad_fetch(scene: SceneData, vis: VisBuffer, tri_id,
                inst_f16: bool = False, capacity: int = 0):
    """RasterConfig.quad_rate_resolve: the rows of _fetch_rows fetched
    once per uniform 2x2 quad (its four pixels hit one triangle) and
    broadcast; the pixels of edge quads through a compacted flat batch,
    written back over the broadcast. The same rows feed the same math, so
    the fields are the per-pixel path's. Returns (dense row tables (H, W,
    C), the edge quads beyond `capacity` (0: max(Hq * Wq // 4, 1024)),
    whose pixels keep their anchor's rows). Edge quads are compacted in
    ascending order, as the JAX package compacts them."""
    H, W = tri_id.shape
    Hq, Wq = H // 2, W // 2
    dev = tri_id.device
    q = tri_id.reshape(Hq, 2, Wq, 2)
    anchor = q[:, 0, :, 0]
    uniform = (q == anchor[:, None, :, None]).all(dim=3).all(dim=1)

    def up(t):  # (Hq, Wq, C) -> (H, W, C), 2x2 broadcast
        c = t.shape[2:]
        return t[:, None, :, None].expand((Hq, 2, Wq, 2) + c).reshape(
            (H, W) + c)

    dense = {k: up(v) for k, v in
             _fetch_rows(scene, vis, anchor, inst_f16).items()}
    F = capacity or max(Hq * Wq // 4, 1024)
    flat = (~uniform).reshape(-1)
    count = flat.sum()
    qidx = fastmath.compact_indices(flat, F)
    valid = torch.arange(F, device=dev) < torch.clamp(count, max=F)
    qy = qidx // Wq
    qx = qidx - qy * Wq
    # all four pixels of each edge quad as one flat batch
    py = torch.cat([qy * 2, qy * 2, qy * 2 + 1, qy * 2 + 1])
    px = torch.cat([qx * 2, qx * 2 + 1, qx * 2, qx * 2 + 1])
    pix = py * W + px
    rows_e = _fetch_rows(scene, vis, tri_id.reshape(-1)[pix], inst_f16)
    widx = torch.where(valid.repeat(4), pix, H * W)
    dense = {k: fastmath.scatter_rows(v, widx, rows_e[k])
             for k, v in dense.items()}
    return dense, torch.clamp(count - F, min=0)


def _onehot_select(match, table):
    """The slot path's select: each pixel's slot's channels, with the
    words of the JAX package's f32 one-hot einsum. match (..., P, K) bool,
    at most one slot a pixel; table (..., K, C). The product adds the
    other slots' 0 * value to the selected value, so a -0.0 comes out
    +0.0, a pixel that matches no slot 0, and a non-finite value of one
    slot NaN (0 * inf) on every pixel of its tile that does not select
    that slot. Those rules are applied to the (K, C) table, and each pixel
    gathers its slot's row: no matmul."""
    C = table.shape[-1]
    bad = ~torch.isfinite(table)
    n_bad = bad.sum(dim=-2, keepdim=True)
    slot_val = torch.where(n_bad - bad.to(n_bad.dtype) > 0, float("nan"),
                           table + 0.0)
    no_match = torch.where(n_bad > 0, float("nan"), 0.0).to(table.dtype)
    k = match.to(torch.uint8).argmax(dim=-1, keepdim=True)
    sel = torch.gather(slot_val, -2, k.expand(k.shape[:-1] + (C,)))
    return torch.where(match.any(dim=-1, keepdim=True), sel, no_match)


def _slot_fetch_channels(scene: SceneData, vis: VisBuffer, tri_id,
                         inst_f16: bool = False, k_slots: int = 16,
                         capacity: int = 0):
    """RasterConfig.slot_resolve: an 8x16 tile of K1 shows a handful of
    distinct winning triangles, so the rows are fetched and decoded once
    per (tile, slot), k_slots slots a tile (its distinct ids, largest
    first, by k_slots max passes), and each pixel selects its slot's
    channels (_onehot_select). Every pixel of a tile with more than
    k_slots distinct ids is re-resolved per pixel through a compacted
    batch of tiles (ascending; `capacity` tiles, 0: max(NT // 32, 64)),
    written back over the select. Returns (channels of _decode_channels
    as dense (H, W, C) f32, the overflowing tiles beyond capacity, whose
    unmatched pixels keep the select's zeros)."""
    H, W = tri_id.shape
    dev = tri_id.device
    TH, TW = fr.TILE_H, fr.TILE_W
    Ty, Tx = H // TH, W // TW
    NT, PX = Ty * Tx, TH * TW
    t = tri_id.reshape(Ty, TH, Tx, TW).permute(0, 2, 1, 3).reshape(
        Ty, Tx, PX)
    # k_slots max passes: distinct ids, descending; -2 marks consumed
    # lanes (ids are >= -1), and exhausted slots stay -2
    uniq, cur = [], t
    for _ in range(k_slots):
        m = cur.amax(dim=-1)
        uniq.append(m)
        cur = torch.where(cur == m[..., None], -2, cur)
    uniq = torch.stack(uniq, dim=-1)  # (Ty, Tx, K)
    tile_ovf = cur.amax(dim=-1) > -2  # ids left after k_slots passes

    tangents = not scene.no_normal_maps
    ch = _decode_channels(
        _fetch_rows(scene, vis, torch.clamp(uniq, min=-1), inst_f16),
        inst_f16, tangents)
    keys = list(ch)
    table = torch.cat([ch[k] for k in keys], dim=-1)  # (Ty, Tx, K, C)
    C = table.shape[-1]
    match = t[..., None] == uniq[..., None, :]
    dense = _onehot_select(match, table).reshape(
        Ty, Tx, TH, TW, C).permute(0, 2, 1, 3, 4).reshape(H, W, C)

    # per-tile fallback: all PX pixels of each overflowing tile
    F = capacity or max(NT // 32, 64)
    flat = tile_ovf.reshape(-1)
    count = flat.sum()
    tidx = fastmath.compact_indices(flat, F)
    valid = torch.arange(F, device=dev) < torch.clamp(count, max=F)
    tid_e = torch.where(valid[:, None], t.reshape(NT, PX)[tidx], -1)
    ch_e = _decode_channels(_fetch_rows(scene, vis, tid_e, inst_f16),
                            inst_f16, tangents)
    rows_flat = torch.cat([ch_e[k] for k in keys], dim=-1).reshape(
        F * PX, C)
    ty = tidx // Tx
    tx = tidx - ty * Tx
    lane = torch.arange(PX, device=dev)
    pix = ((ty[:, None] * TH + lane[None, :] // TW) * W
           + tx[:, None] * TW + lane[None, :] % TW)
    widx = torch.where(valid[:, None], pix, H * W).reshape(F * PX)
    dense = fastmath.scatter_rows(dense, widx, rows_flat)

    out, off = {}, 0
    for k in keys:
        c = ch[k].shape[-1]
        out[k] = dense[..., off:off + c]
        off += c
    return out, torch.clamp(count - F, min=0)


def _pixel_fields(scene: SceneData, vis: VisBuffer, tri_id, depth, x_ndc,
                  y_ndc, want_aux: bool = True, lod_probe=None,
                  inst_f16: bool = False, rows=None, channels=None,
                  slim: bool = False):
    """Per-pixel resolve for any pixel-set shape S: unmasked fields plus
    the keep/cut masks. x_ndc / y_ndc broadcast to S. `lod_probe`: None
    takes the mip lod from image-space finite differences (S = (H, W));
    (dx, dy) NDC steps take it from analytic within-triangle barycentric
    probes (any S), as the flat fallback batch does. `rows`: row tables
    already fetched (the quad path), `channels`: channels already decoded
    (the slot path); by default fetched per pixel. `inst_f16`: the
    instance record is f16 pairs. `slim`: the rows are slim records
    (RasterConfig.slim_rec). The fetch and decode run in the profiler's
    scope resolve.fetch, the rest in resolve.fields."""
    # the fetched rows die with the decode (the packed attribute rows are
    # not needed past it); tangents feed only the normal-map TBN transform
    if channels is None:
        if slim and not scene.no_normal_maps:
            raise ValueError("slim_rec requires a scene with no normal maps")
        with profiler.scope("resolve.fetch"):
            if rows is None:
                rows = _fetch_rows(scene, vis, tri_id, inst_f16, slim=slim)
            channels = (_decode_slim_channels(rows) if slim else
                        _decode_channels(rows, inst_f16,
                                         not scene.no_normal_maps))
            del rows
    with profiler.scope("resolve.fields"):
        return _channel_fields(scene, tri_id, depth, x_ndc, y_ndc, channels,
                               want_aux, lod_probe)


def _channel_fields(scene: SceneData, tri_id, depth, x_ndc, y_ndc, channels,
                    want_aux, lod_probe):
    """_pixel_fields from the decoded channels."""
    S = tri_id.shape
    hit = tri_id >= 0
    slim = "pay" in channels
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
        if "t_c" not in channels:
            raise ValueError(
                "tangent channels were pruned but the scene has normal maps")
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
    if counts.get("overflow") is not None:
        profiler.count("overflow.resolve", counts["overflow"])
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


def pixel_ndc(H: int, W: int, device, row0: int = 0, height=None):
    """The pixel centres' NDC x and y, each broadcast to (H, W), of the
    image rows [row0, row0 + H) of a `height`-row image (default H)."""
    height = H if height is None else height
    x_ndc = ((torch.arange(W, dtype=torch.float32, device=device) + 0.5)
             / W * 2.0 - 1.0)[None, :].expand(H, W)
    y_ndc = (1.0 - pixel_rows(H, device, row0, height) * 2.0)[:, None]
    return x_ndc, y_ndc.expand(H, W)


def resolve_dense_reference(scene: SceneData, vis: VisBuffer, row0: int = 0,
                            height=None):
    """The plain twin of ops/resolve.py resolve_dense: this module's dense
    per-pixel fields of `vis` (rows [row0, row0 + H) of a `height`-row
    image), as dense_op.FIELDS."""
    H, W = vis.depth.shape
    x_ndc, y_ndc = pixel_ndc(H, W, vis.depth.device, row0, height)
    f = _pixel_fields(scene, vis, vis.tri_id, vis.depth, x_ndc, y_ndc)
    f["normal_uv"] = torch.stack([f["packed_n"], f["packed_uv"]], dim=-1)
    return {k: f[k] for k in dense_op.FIELDS}


def takes_dense_kernel(config, scene, vis) -> bool:
    """Whether resolve_gbuffer resolves `vis` through the one-launch
    dense resolve (ops/resolve.py resolve_dense): a static test of the
    layout its inputs show. No runner-up (no alpha mask), none of the
    record layouts and coherent fetches (they change the rows or how
    they are fetched), and const-folded emissive and metallic-roughness.
    Every other input keeps the eager chain."""
    return (vis.tri_id2 is None
            and not (config.slot_resolve or config.quad_rate_resolve
                     or config.slim_rec
                     or config.fused_resolve_rec or config.fused_inst_rec
                     or config.inst_rec_f16)
            and scene.emissive_const and scene.mr_const)


@profiler.scoped("resolve")
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

    The dense (H, W) resolve takes the coherent fetch the config names:
    slot_resolve (H % 8 == W % 16 == 0; it subsumes quad), else
    quad_rate_resolve (H and W even), else the per-pixel one
    (planar_resolve included). The edge batches' overflow is counted in
    ResolveAux.overflow (on the two-pass path the final pass's alone).
    Neither coherent fetch goes with fused_resolve_rec or slim_rec
    (ValueError).

    Row window (a slab of the sharded frame): `vis` holds the image rows
    [row0, row0 + H) of a `height`-row image (default H), and `rows =
    (lo, hi)` names the window rows that are the caller's own; the rows
    around them are halo. Every row is resolved, the halo's fallbacks
    included; the mip level's finite difference makes a window's last row
    exact only where it is the image's last, so the caller gives it one
    row of halo below. The counts (cut, fallback and overflow, the
    fallback pixels left unresolved) are those of the own rows, and the
    fallback capacity is the whole image's.

    Inputs of the default layout (takes_dense_kernel) resolve in one
    launch of ops/resolve.py resolve_dense (the profiler's scope
    resolve.kernel), with the chain's words; the profiler's counters
    resolve.kernel_px and resolve.eager_px count the pixels each way
    resolved (eager: each dense pass's H x W, and the fallback batch's
    pixels resolved to their runner-up)."""
    H, W = vis.depth.shape
    dev = vis.depth.device
    height = H if height is None else height
    if takes_dense_kernel(config, scene, vis):
        profiler.count("resolve.kernel_px", H * W)
        with profiler.scope("resolve.kernel"):
            f = dense_op.resolve_dense(scene, vis, row0, height,
                                       twin=resolve_dense_reference)
        return (GBuffer(normal_uv=f["normal_uv"], material=f["material"],
                        depth=f["depth"]),
                ResolveAux(albedo=f["albedo"], emissive=f["emissive"],
                           mr=f["mr"]))
    x_ndc, y_ndc = pixel_ndc(H, W, dev, row0, height)

    f16 = config.inst_rec_f16
    slim = config.slim_rec
    slot = config.slot_resolve and H % fr.TILE_H == 0 and W % fr.TILE_W == 0
    quad = (config.quad_rate_resolve and not slot and H % 2 == 0
            and W % 2 == 0)
    if (quad or slot) and config.fused_resolve_rec:
        raise ValueError(
            "quad/slot_rate_resolve and fused_resolve_rec are mutually "
            "exclusive: the coherence paths re-split the fused record's "
            "gathers")
    if slim and (quad or slot):
        raise ValueError(
            "slim_rec and quad/slot_rate_resolve are mutually exclusive")
    track = quad or slot
    edge_ovf = torch.zeros((), dtype=torch.int64, device=dev)

    def dense_fields(tri_id, depth, want_aux=True):
        nonlocal edge_ovf
        profiler.count("resolve.eager_px", H * W)
        fetched, channels = None, None
        if slot:
            with profiler.scope("resolve.fetch"):
                channels, ovf = _slot_fetch_channels(
                    scene, vis, tri_id, inst_f16=f16, k_slots=config.slot_k,
                    capacity=config.slot_edge_capacity)
                edge_ovf = edge_ovf + ovf
        elif quad:
            with profiler.scope("resolve.fetch"):
                fetched, ovf = _quad_fetch(scene, vis, tri_id, inst_f16=f16,
                                           capacity=config.quad_edge_capacity)
                edge_ovf = edge_ovf + ovf
        return _pixel_fields(scene, vis, tri_id, depth, x_ndc, y_ndc,
                             want_aux=want_aux, inst_f16=f16, rows=fetched,
                             channels=channels, slim=slim)

    if vis.tri_id2 is None:
        fields = dense_fields(vis.tri_id, vis.depth)
        return _assemble(fields, overflow=edge_ovf if track else None)

    if not config.lazy_alpha_resolve:
        # Dense two-pass fallback (the lazy path's oracle twin): pass 1
        # finds cut winners, pass 2 re-resolves every pixel with the
        # runner-up substituted. Pass 1 visits the same edge quads and
        # tiles, so only pass 2's edge overflow counts.
        f1 = dense_fields(vis.tri_id, vis.depth, want_aux=False)
        edge_ovf = torch.zeros_like(edge_ovf)
        fall = (vis.tri_id >= 0) & f1["cut"]
        tid = torch.where(fall, vis.tri_id2, vis.tri_id)
        dep = torch.where(fall, vis.depth2, vis.depth)
        n_fall = _own(fall, rows).sum()
        with profiler.scope("resolve.fallback"):
            fields = dense_fields(tid, dep)
        return _assemble(fields, overflow=edge_ovf if track else None,
                         cut=n_fall, fallback=n_fall)

    # Lazy fallback: full resolve of the winners (the final result for
    # every non-cut pixel), then a compacted flat batch over the cut
    # pixels only, scattered back as packed rows.
    f1 = dense_fields(vis.tri_id, vis.depth)
    fall = (vis.tri_id >= 0) & f1["cut"]
    F = config.alpha_fallback_capacity or max((height * W) // 16, 1024)

    with profiler.scope("resolve.fallback"):
        flat = fall.reshape(-1)
        count = flat.sum()
        idx = fastmath.compact_indices(flat, F)  # (F,) pixel indices
        n_fb = torch.clamp(count, max=F)
        profiler.count("resolve.eager_px", n_fb)
        valid = torch.arange(F, device=dev) < n_fb
        tid2 = torch.where(valid, vis.tri_id2.reshape(-1)[idx], -1)
        dep2 = vis.depth2.reshape(-1)[idx]
        fx = (idx % W).to(torch.float32)
        fy = (idx // W + row0).to(torch.float32)
        xb = (fx + 0.5) / W * 2.0 - 1.0
        yb = 1.0 - (fy + 0.5) / height * 2.0
        fb = _pixel_fields(scene, vis, tid2, dep2, xb, yb,
                           lod_probe=(2.0 / W, 2.0 / height), inst_f16=f16,
                           slim=slim)
        fb_rows = _pack_fallback_rows(fb)

        # invalid slots write the pixel index H*W, which is dropped
        fbimg = _unpack_fallback(fastmath.scatter_rows(
            torch.zeros(H, W, _FB_F, dtype=torch.int32, device=dev),
            torch.where(valid, idx, H * W), fb_rows))
        use = fall & fbimg["flag"]

    merged = dict(f1)
    for k in ("packed_n", "packed_uv", "material", "depth"):
        merged[k] = torch.where(use, fbimg[k], f1[k])
    for k in ("albedo", "emissive", "mr"):
        merged[k] = torch.where(use[..., None], fbimg[k], f1[k])
    # overflow: the cut pixels left unresolved (count - F on a whole
    # image) plus the edge batches'
    return _assemble(merged,
                     overflow=_own(fall & ~use, rows).sum() + edge_ovf,
                     cut=_own(fall, rows).sum(),
                     fallback=_own(use, rows).sum())


def _own(mask, rows):
    """The rows (lo, hi) of an (H, W) mask, or all of it for None."""
    return mask if rows is None else mask[rows[0]:rows[1]]
