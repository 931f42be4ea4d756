"""Tile-binned software visibility-buffer rasterizer.

Counterpart of ``voidin_tpu/passes/raster.py``:
1. setup: expand the compact draw stream into triangle work items, fetch
   one de-indexed corner row + one per-draw record per triangle,
   transform, near-clip (<= 2 triangles, extras into a capacity tail),
   reduce each triangle to an affine coefficient record (edge planes +
   depth plane in a per-triangle anchor frame) plus a resolve record
   (48 B; 96 B with the corner-attribute row under fused_resolve_rec, 144
   B with the f16 instance record too under fused_inst_rec; the 96 B slim
   record under slim_rec);
2. binning, by RasterConfig.backend:
   "pallas" (default), the pair path: two-stream (triangle, tile) pairs —
   every triangle's first tile is a 1:1 slot, multi-tile extras expand at
   pair_capacity/4 — or with two_stream_bin=False one stream expanded at
   pair_capacity, stably sorted by tile, records gathered into tile
   order and their b coefficients baked to each pair's tile origin;
   "xla", the block path: one (triangle, tile) stream expanded at
   pair_capacity, stably sorted by tile, each tile's first
   tile_tri_capacity records gathered into a (tiles, K, 16) block;
3. fine raster: on the pair path kernel K1 (ops/fine_raster.py), the
   per-tile reverse-Z depth/id competition, with its track2 variant (the
   runner-up among distinct depths, alpha-masked scenes) and its payload
   variant (the winner's slim resolve record per pixel,
   RasterConfig.kernel_payload); on the block path kernel K2, the same
   competition over the blocks, and its track2 variant.

The backend names are the JAX package's, so one dict of options builds
both packages' configs. The port has no XLA: on the card "xla" launches
K2, and the block path's plain twin runs only for CPU tensors.

Every sort here is stable: the record order inside a tile decides ties in
the kernels. Depth semantics: reverse-Z max with ndc.z affine in screen
space.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import encoding, fastmath
from ..framework import profiler
from ..ops import fine_raster as fr
from ..scene.instance import InstanceData
from ..scene.mesh import MeshPoolData
from .cull import DrawList
from .gbuffer import VisBuffer

NEAR_EPS = 1e-8

@dataclasses.dataclass(frozen=True)
class RasterConfig:
    width: int = 1920
    height: int = 1080
    tri_capacity: int = 1 << 20  # max live triangle work items per frame
    pair_capacity: int = 1 << 22  # max (triangle, tile) pairs
    tile_tri_capacity: int = 128  # block path: max records per tile (K)
    # "pallas": the pair path (K1); "xla": the block path (K2)
    backend: str = "pallas"
    # The JAX package's sort that carries the 16 record fields through the
    # tile sort. It gives the records of the gather after the sort, in the
    # same order (the sort is stable), so the port accepts it and runs
    # that one gather either way.
    sort_payload: bool = False
    # Two-stream pair binning (first tile 1:1, extras through a compacted
    # expansion at pair_capacity/4) or one stream expanded at
    # pair_capacity (False). A tile's records come in another order, which
    # decides K1's ties between records of different chunks.
    two_stream_bin: bool = True
    # Track the runner-up depth candidate per pixel (K1's track2 variant)
    # so resolve can apply the per-texel alpha cutoff inside the depth
    # competition (visibility.wgsl:79-81 discard). The Renderer sets it
    # from SceneData.alpha_masked.
    alpha_mask: bool = False
    # Alpha-mask fallback: resolve the runner-up only on a compacted list
    # of cut pixels (capacity alpha_fallback_capacity; 0 = max(H*W // 16,
    # 1024)) instead of re-resolving every pixel densely.
    lazy_alpha_resolve: bool = True
    alpha_fallback_capacity: int = 0
    # The slim 96 B resolve record (24 columns): clip x/y/w (9 f32), corner
    # uv (6 f32), WORLD-space octahedral corner normals (3 u32, through the
    # instance basis at setup) and a 12 x f16 material payload; resolve
    # then fetches one row per pixel. An image-budget variant: normals pay
    # a second octahedral quantization. Needs a scene with no normal maps,
    # const-folded emissive / metallic-roughness, no alpha mask and
    # f16-exact material and texture ids (the Renderer checks).
    slim_rec: bool = False
    # The corner-attribute row (12 words) rides the resolve record (24
    # columns): resolve fetches it with the record. The same words.
    fused_resolve_rec: bool = False
    # The fused instance+material record as f16 pairs (12 words, 48 B;
    # resolve._inst_rec_f16): ids and power-of-two texture extents exact,
    # basis and colours within the 1e-2 image budget. Material and texture
    # ids must stay below 2048.
    inst_rec_f16: bool = False
    # The f16 instance record rides the draw record and the resolve record
    # (36 columns) from setup: the words of inst_rec_f16's gather. Needs
    # fused_resolve_rec + inst_rec_f16; the Renderer threads the record
    # through rasterize(inst_rec=...).
    fused_inst_rec: bool = False
    # The JAX package's channel-major twin of the dense resolve. Accepted
    # for its config and resolved by the port's dense path, whose G-buffer
    # words the twin gives (aux within its ulp budget).
    planar_resolve: bool = False
    # Resolve's rows fetched once per uniform 2x2 quad, edge quads through
    # a compacted batch of quad_edge_capacity quads (0: max(quads // 4,
    # 1024)); overflowed edge pixels keep their quad's anchor rows and are
    # counted in ResolveAux.overflow. Not with fused_resolve_rec or
    # slim_rec; off under a mesh.
    quad_rate_resolve: bool = False
    quad_edge_capacity: int = 0
    # Resolve's channels fetched once per (8x16 tile, distinct triangle),
    # slot_k slots a tile, selected per pixel by a one-hot product;
    # tiles with more distinct ids re-resolved per pixel, slot_edge_capacity
    # tiles of them (0: max(tiles // 32, 64)), the rest counted in
    # ResolveAux.overflow. Subsumes quad_rate_resolve; not with
    # fused_resolve_rec or slim_rec; off under a mesh.
    slot_resolve: bool = False
    slot_k: int = 16
    slot_edge_capacity: int = 0
    # TAA history fetch by quad blocks (taa._bilinear_clamp_quadblock):
    # one 4x4-texel f16 block row per 2x2 output quad instead of one 2x2
    # row per pixel; quads whose history coordinates spread wider go
    # through a compacted per-pixel batch of taa_edge_capacity quads (0:
    # max(quads // 4, 1024)), the rest counted in the frame's overflow.
    # The words of the default fetch while the batch holds, under the
    # JAX package's select rules (taa_quad_where). Needs even sides; off
    # under a mesh.
    taa_quad_history: bool = False
    taa_edge_capacity: int = 0
    # TAA history fetch from each pixel's 5x5 clamp-shifted window for
    # pixels whose corners lie in it (taa._bilinear_clamp_inwindow), fast
    # movers per 8x8 block through a compacted batch of
    # taa_block_capacity blocks (0: max(blocks // 8, 256)), overflow
    # counted. The words of the default fetch; sides that are not
    # multiples of 8 take the default fetch. taa_quad_history comes
    # first where both are set; off under a mesh.
    taa_inwindow: bool = False
    taa_block_capacity: int = 0
    # taa_quad_history's in-block select: the JAX package's where-chains
    # (the selected f16 texel, as the default fetch reads it) instead of
    # its one-hot einsum, whose f32 sum turns a -0.0 texel into +0.0 and
    # makes every corner of a quad NaN where its 4x4 block holds a
    # non-finite texel it does not select. The two differ only there.
    taa_quad_where: bool = False
    # K1 hands resolve the winner's slim record per pixel
    # (VisBuffer.payload_img), so resolve skips its per-pixel record
    # gather; bit-identical to it. Needs slim_rec and the pair path.
    kernel_payload: bool = False
    # Hold every data-dependent gather index of the frame to its table
    # (core/checks.py): the Renderer sets the bounds mode for its frame;
    # an out-of-range index raises an IndexError naming the gather.
    debug_bounds: bool = False
    # K1's tile shape; the tile count pads to a multiple of 8 like the JAX
    # layout's grid step, so both packages bin to the same tile table
    tile_h = fr.TILE_H
    tile_w = fr.TILE_W
    tile_pad = 8

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def n_tiles_padded(self) -> int:
        return -(-self.n_tiles // self.tile_pad) * self.tile_pad


_SAT = 1 << 29


def saturating_cumsum(counts: torch.Tensor) -> torch.Tensor:
    """Cumulative sum clamped at 2^29 — identical to the JAX package's
    saturating int32 scan for non-negative counts."""
    return torch.clamp(torch.cumsum(counts.to(torch.int64), 0), max=_SAT)


def segment_ids_from_counts(counts: torch.Tensor, cap: int,
                            need_local: bool = True):
    """Variable-rate expansion: for each stream position e in [0, cap),
    (segment id, position-within-segment, valid), via a scatter of segment
    starts and a running max."""
    dev = counts.device
    cum = saturating_cumsum(counts)
    total = torch.clamp(cum[-1], max=cap)
    starts = torch.cat([torch.zeros(1, dtype=cum.dtype, device=dev), cum[:-1]])
    seg_of_start = torch.arange(counts.shape[0], device=dev)
    marks = torch.zeros(cap, dtype=torch.int64, device=dev)
    # Empty segments share a start position; max keeps the last one.
    # Starts at or beyond cap are dropped.
    keep = starts < cap
    marks.scatter_reduce_(0, starts[keep], seg_of_start[keep], "amax")
    seg = torch.cummax(marks, 0).values
    e = torch.arange(cap, device=dev)
    if not need_local:
        return seg, None, e < total
    local = e - starts[seg]
    return seg, local, e < total


# ---------------------------------------------------------------------------
# 1. Triangle setup
# ---------------------------------------------------------------------------


def _project(clip, config: RasterConfig):
    """Clip-space (..., 4) -> pixel coords + ndc z (y down)."""
    w = clip[..., 3]
    inv_w = 1.0 / torch.where(w.abs() > NEAR_EPS, w, NEAR_EPS)
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * config.width
    sy = (0.5 - ndc[..., 1] * 0.5) * config.height
    return sx, sy, ndc[..., 2]


def _front_face(sx, sy):
    """wgpu culls clockwise given front_face=Ccw (pass/visibility.rs:124)."""
    area2 = (sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0]) - (
        sy[..., 1] - sy[..., 0]
    ) * (sx[..., 2] - sx[..., 0])
    return area2 < 0.0


def setup_draw_records(meshes: MeshPoolData, instances: InstanceData,
                       draws: DrawList, camera, config: RasterConfig,
                       materials=None, inst_rec=None):
    """Per-draw record (mvp + offsets + instance id, 24 f32), triangle
    counts and their running sum. `inst_rec` (instances, 12) int32, the
    f16 instance record of resolve._inst_rec_f16 (slim_rec,
    fused_inst_rec), rides as 12 more columns of u32 bits (36 f32)."""
    dev = instances.transform.device
    inst_ids = draws.instance.to(torch.int64)
    safe_inst = torch.clamp(inst_ids, min=0)
    if draws.mesh is not None:
        mesh_ids = torch.clamp(draws.mesh.to(torch.int64), min=0)
    else:
        mesh_ids = instances.mesh_id.to(torch.int64)[safe_inst]
    n_draws = inst_ids.shape[0]
    n_tris = torch.where(
        torch.arange(n_draws, device=dev) < draws.count,
        meshes.index_count.to(torch.int64)[mesh_ids] // 3,
        0,
    )
    view_proj = fastmath.matmul_fma(
        torch.as_tensor(camera.projection, device=dev),
        torch.as_tensor(camera.view, device=dev),
    )
    mvp = fastmath.compose_mat4(view_proj, instances.transform)
    if materials is not None:
        bc_w = materials.base_color[
            instances.material_id.to(torch.int64)[safe_inst], 3]
    else:
        bc_w = torch.ones(n_draws, dtype=torch.float32, device=dev)
    cum_draws = saturating_cumsum(n_tris)
    draw_start = torch.cat(
        [torch.zeros(1, dtype=torch.float32, device=dev),
         cum_draws[:-1].to(torch.float32)]
    )
    base_index = meshes.base_index.to(torch.int64)[mesh_ids]
    cols = [
        mvp.reshape(-1, 16)[safe_inst],
        (base_index // 3).to(torch.float32)[:, None],
        base_index.to(torch.float32)[:, None],
        safe_inst.to(torch.float32)[:, None],
        bc_w[:, None],
        draw_start[:, None],
        torch.zeros(n_draws, 3, dtype=torch.float32, device=dev),
    ]
    if inst_rec is not None:
        cols.append(inst_rec.contiguous().view(torch.float32)[safe_inst])
    draw_rec = torch.cat(cols, dim=-1)  # (N, 24 | 36)
    return draw_rec, n_tris, cum_draws


def _slim_resolve_rec(clip, attr, rec, num):
    """The slim 24-column resolve record (RasterConfig.slim_rec) of `num`
    work items: clip x/y/w (9 f32), corner uv (6 f32 from the packed
    corner-attribute row `attr`, (num, 12) int32), the corner normals in
    world space through the instance basis of the f16 instance record in
    draw-record columns 24:36, re-encoded as oct32 (3 words), and 12 f16
    material scalars (6 words). u32 and f16 words travel as f32 bits."""
    irec = rec[:, 24:36].contiguous().view(torch.float16).to(torch.float32)
    basis = irec[:, :9].reshape(num, 1, 3, 3)
    n_c = encoding.decode_octahedral_32(attr[:, 6:9])  # (num, 3, 3)
    n_ws = fastmath.mat3_vec(basis, n_c)
    n_enc = encoding.encode_octahedral_32(n_ws)  # (num, 3) int32
    pay = irec[:, [9, 10, 15, 16, 17, 18, 19, 20, 21, 22, 23, 12]]
    return torch.cat(
        [
            clip[:, :, [0, 1, 3]].reshape(num, 9),
            attr[:, 0:6].contiguous().view(torch.float32),
            n_enc.view(torch.float32),
            pay.to(torch.float16).contiguous().view(torch.float32),
        ],
        dim=-1,
    )  # (num, 24)


def setup_work_slice(tri_pos, tri_attr_packed, draw_rec, n_tris,
                     config: RasterConfig, lo: int = 0, num=None):
    """Per-work-item transform, near clip, projection and packing of the
    global work slots [lo, lo + num) (default all tri_capacity slots).
    Every operation is per slot, so a slice computes the same words as
    those rows of the whole run: the sharded raster runs tri_capacity / N
    slots on each device (parallel/sharding.py). `tri_attr_packed` is
    read only for slim_rec and fused_resolve_rec. Columns that carry u32
    or f16 words as f32 are only ever copied, so every bit pattern (NaN
    ones included) comes through."""
    cap = config.tri_capacity
    if num is None:
        num = cap
    dev = tri_pos.device
    draw_slot, _, valid = segment_ids_from_counts(n_tris, cap,
                                                  need_local=False)
    draw_slot, valid = draw_slot[lo:lo + num], valid[lo:lo + num]
    slot_ids = lo + torch.arange(num, device=dev)
    rec = draw_rec[draw_slot]  # (num, 24)
    inst = torch.where(valid, rec[:, 18].to(torch.int64), 0)
    bc_cut = rec[:, 19] < 0.5  # base_color.w cutoff: drop the triangle
    local_tri = slot_ids - rec[:, 20].to(torch.int64)
    tri_pool = rec[:, 16].to(torch.int64) + local_tri
    idx_start = rec[:, 17].to(torch.int64) + 3 * local_tri

    pos = tri_pos[torch.where(valid, tri_pool, 0)].reshape(num, 3, 3)
    m = rec[:, :16].reshape(num, 4, 4)
    clip = fastmath.mat4_point4(m[:, None, :, :], pos)  # (num, 3, 4)

    # --- near-plane clipping (s = w - z > 0) ----------------------------
    s_dist = clip[..., 3] - clip[..., 2]
    is_in = s_dist > 0.0
    n_in = is_in.to(torch.int64).sum(dim=-1)
    r1 = torch.argmax(is_in.to(torch.uint8), dim=-1)
    r2 = (torch.argmax((~is_in).to(torch.uint8), dim=-1) + 1) % 3
    r = torch.where(n_in == 1, r1, torch.where(n_in == 2, r2, 0))
    rot1 = clip[:, [1, 2, 0]]
    rot2 = clip[:, [2, 0, 1]]
    rsel = r[:, None, None]
    rclip = torch.where(rsel == 1, rot1, torch.where(rsel == 2, rot2, clip))
    a, b, c = rclip[:, 0], rclip[:, 1], rclip[:, 2]

    def lerp_to_plane(p, q):
        sp = p[..., 3] - p[..., 2]
        sq = q[..., 3] - q[..., 2]
        den = sp - sq
        t = sp / torch.where(den.abs() > 1e-20, den, 1e-20)
        return p + (q - p) * t[..., None]

    i_ab = lerp_to_plane(a, b)
    i_ac = lerp_to_plane(a, c)
    i_bc = lerp_to_plane(b, c)

    tri1 = torch.where(
        (n_in == 3)[:, None, None],
        clip,
        torch.where(
            (n_in == 2)[:, None, None],
            torch.stack([a, b, i_bc], dim=1),
            torch.stack([a, i_ab, i_ac], dim=1),
        ),
    )
    tri2 = torch.stack([a, i_bc, i_ac], dim=1)  # only when n_in == 2

    sx1, sy1, z1 = _project(tri1, config)
    sx2, sy2, z2 = _project(tri2, config)
    alive1 = valid & (n_in >= 1) & _front_face(sx1, sy1) & ~bc_cut
    needs2 = valid & (n_in == 2) & ~bc_cut
    alive2 = needs2 & _front_face(sx2, sy2)

    rec1 = _pack_raster(sx1, sy1, z1, alive1, slot_ids)
    # Resolve record: original clip x/y/w per vertex + instance + idx_start
    # (clip z == znear under the infinite reverse-Z projection).
    if config.slim_rec:
        if draw_rec.shape[-1] < 36:
            raise ValueError(
                "slim_rec needs the f16 instance record threaded through "
                "the draw record (rasterize(inst_rec=...))")
        attr = tri_attr_packed[torch.where(valid, tri_pool, 0)]
        resolve1 = _slim_resolve_rec(clip, attr, rec, num)
    else:
        cols = [
            clip[:, :, [0, 1, 3]].reshape(num, 9),
            inst.to(torch.float32)[:, None],
            idx_start.to(torch.float32)[:, None],
            torch.zeros(num, 1, dtype=torch.float32, device=dev),
        ]
        if config.fused_resolve_rec:
            # the corner-attribute row, then (fused_inst_rec) the f16
            # instance record copied from the draw record
            attr = tri_attr_packed[torch.where(valid, tri_pool, 0)]
            cols.append(attr.view(torch.float32))
            if draw_rec.shape[-1] >= 36:
                cols.append(rec[:, 24:36])
        resolve1 = torch.cat(cols, dim=-1)  # (num, 12 | 24 | 36)
    extra_geom = torch.cat(
        [sx2, sy2, z2, alive2[:, None].to(torch.float32)], dim=-1
    )  # (num, 10)
    return dict(rec1=rec1, resolve1=resolve1, sx1=sx1, sy1=sy1, z1=z1,
                needs2=needs2, extra_geom=extra_geom)


def _pack_raster(sxv, syv, zv, alivev, ids):
    """Affine coefficient record: e_k(p) = ax_k*px + ay_k*py + b_k and the
    depth plane, in a per-triangle anchor frame (bbox corner). Dead
    records zero out with bd = -1 and id -1."""
    idf = torch.where(alivev, ids.to(torch.float32), -1.0)
    n = sxv.shape[0]
    anchor_x = torch.floor(torch.amin(sxv, dim=-1))
    anchor_y = torch.floor(torch.amin(syv, dim=-1))
    rx = sxv - anchor_x[:, None]
    ry = syv - anchor_y[:, None]
    nxt = [1, 2, 0]
    dx = rx[:, nxt] - rx
    dy = ry[:, nxt] - ry
    ax = dy
    ay = -dx
    b = ry * dx - rx * dy
    area2 = dy[:, 0] * dx[:, 1] - dx[:, 0] * dy[:, 1]  # = e0+e1+e2
    inv = 1.0 / torch.where(area2.abs() > 1e-20, area2, 1e-20)
    zrot = zv[:, [2, 0, 1]]  # weight of edge k is z[(k+2)%3]
    axd = fastmath.sum3(ax * zrot) * inv
    ayd = fastmath.sum3(ay * zrot) * inv
    bd = fastmath.sum3(b * zrot) * inv
    # zmax bounds the affine depth in K1 (sliver guard)
    zmax = torch.amax(zv, dim=-1)
    rec = torch.stack(
        [ax[:, 0], ay[:, 0], b[:, 0], ax[:, 1], ay[:, 1], b[:, 1],
         ax[:, 2], ay[:, 2], b[:, 2], axd, ayd, bd, idf, anchor_x, anchor_y,
         zmax],
        dim=-1,
    )
    dead_row = torch.zeros(16, dtype=torch.float32, device=rec.device)
    dead_row[fr.F_D + 2] = -1.0
    dead_row[fr.F_ID] = -1.0
    return torch.where((~alivev)[:, None], dead_row.expand(n, 16), rec)


def setup_finalize(parts: dict, cum_draws, config: RasterConfig):
    """Compact the clipped second triangles into the extras region
    (tri_capacity / 8 slots) and emit the final packed streams."""
    cap = config.tri_capacity
    dev = cum_draws.device
    ecap = cap // 8
    needs2 = parts["needs2"]
    n_extras = needs2.to(torch.int64).sum()
    overflow = torch.clamp(cum_draws[-1] - cap, min=0) + torch.clamp(
        n_extras - ecap, min=0
    )
    extra_src = fastmath.compact_indices(needs2, ecap)
    valid_extra = torch.arange(ecap, device=dev) < torch.clamp(n_extras,
                                                               max=ecap)
    extra_ids = cap + torch.arange(ecap, device=dev)
    extra_geom = parts["extra_geom"][extra_src]
    sx2e, sy2e, z2e = extra_geom[:, 0:3], extra_geom[:, 3:6], \
        extra_geom[:, 6:9]
    alive2e = extra_geom[:, 9] > 0.5
    rec2 = _pack_raster(sx2e, sy2e, z2e, alive2e & valid_extra, extra_ids)
    raster_rec = torch.cat([parts["rec1"], rec2])  # (cap + ecap, 16)
    resolve_rec = torch.cat([parts["resolve1"], parts["resolve1"][extra_src]])
    return dict(
        sx=torch.cat([parts["sx1"], sx2e]),
        sy=torch.cat([parts["sy1"], sy2e]),
        sz=torch.cat([parts["z1"], z2e]),
        alive=raster_rec[:, fr.F_ID] >= 0.0,
        raster_rec=raster_rec,
        resolve_rec=resolve_rec,
        setup_overflow=overflow,
    )


def triangle_setup(meshes: MeshPoolData, instances: InstanceData,
                   draws: DrawList, camera, config: RasterConfig,
                   materials=None, inst_rec=None):
    """Per-work-item screen data and packed records, capacity padded.
    `materials`: triangles whose base_color.w < 0.5 are dropped here (every
    fragment of them discards, visibility.wgsl:79). `inst_rec`: the f16
    instance record, needed by slim_rec and folded into the resolve
    record by fused_inst_rec."""
    draw_rec, n_tris, cum_draws = setup_draw_records(
        meshes, instances, draws, camera, config, materials=materials,
        inst_rec=inst_rec,
    )
    parts = setup_work_slice(meshes.tri_pos, meshes.tri_attr_packed,
                             draw_rec, n_tris, config)
    return setup_finalize(parts, cum_draws, config)


# ---------------------------------------------------------------------------
# 2. Binning
# ---------------------------------------------------------------------------


def bake_tile_origin(rec, tiles, config: RasterConfig, row_px_offset=0):
    """Re-base the b coefficients from the per-triangle anchor frame to
    each pair's tile origin: b' = b + (ax*(tx0 - anchor_x) +
    ay*(ty0 - anchor_y)). `row_px_offset`: the global pixel row of tile
    row 0 (slab-local tile ids in the sharded raster), so records stay
    baked to GLOBAL pixel origins."""
    tx0 = ((tiles % config.tiles_x) * config.tile_w).to(torch.float32)
    ty0 = ((tiles // config.tiles_x) * config.tile_h
           + row_px_offset).to(torch.float32)
    offx = tx0 - rec[..., fr.F_ANCHOR]
    offy = ty0 - rec[..., fr.F_ANCHOR + 1]
    out = rec.clone()
    for q in range(4):  # e0, e1, e2, depth
        out[..., 3 * q + 2] = rec[..., 3 * q + 2] + (
            rec[..., 3 * q] * offx + rec[..., 3 * q + 1] * offy
        )
    return out


def _to_index(x):
    """Float pixel bound -> int64 the way a saturating f32->i32 cast does
    (the bounds only feed tile clamps, so +-2^30 is as good as +-inf)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0 ** 30, neginf=-2.0 ** 30)
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(torch.int64)


def _tile_bounds(setup: dict, config: RasterConfig):
    """Per work item: (alive and on screen, first tile column, first tile
    row, last tile column, last tile row) of its screen bounding box."""
    TX, TY = config.tiles_x, config.tiles_y
    sx, sy, alive = setup["sx"], setup["sy"], setup["alive"]
    x0 = torch.floor(torch.amin(sx, dim=-1))
    x1 = torch.ceil(torch.amax(sx, dim=-1))
    y0 = torch.floor(torch.amin(sy, dim=-1))
    y1 = torch.ceil(torch.amax(sy, dim=-1))
    on_screen = (x1 >= 0) & (y1 >= 0) & (x0 < config.width) & (
        y0 < config.height)
    tx0 = torch.clamp(_to_index(x0) // config.tile_w, 0, TX - 1)
    tx1 = torch.clamp(_to_index(x1) // config.tile_w, 0, TX - 1)
    ty0 = torch.clamp(_to_index(y0) // config.tile_h, 0, TY - 1)
    ty1 = torch.clamp(_to_index(y1) // config.tile_h, 0, TY - 1)
    return alive & on_screen, tx0, ty0, tx1, ty1


def bin_triangles(setup: dict, config: RasterConfig):
    """Block binning: (triangle, tile) pairs -> per-tile record blocks.

    One stream of pair_capacity slots (segment expansion of each alive
    triangle's bounding-box tiles), stably sorted by tile, so a tile's
    records keep the triangle order; the first tile_tri_capacity (K) of
    each tile land in a (NT, K) table (the rest are dropped and counted),
    are gathered into (NT, K, 16) blocks and baked to the tile's origin.
    Empty slots carry record 0's coefficients with id -1. Returns (blocks,
    counts (NT,) int32 capped at K, overflow): overflow counts the pairs
    beyond pair_capacity plus the records ranked at K or above."""
    TX = config.tiles_x
    NT = config.n_tiles_padded
    K = config.tile_tri_capacity
    E = config.pair_capacity
    dev = setup["sx"].device
    alive, tx0, ty0, tx1, ty1 = _tile_bounds(setup, config)
    bw = tx1 - tx0 + 1
    n_pairs = torch.where(alive, bw * (ty1 - ty0 + 1), 0)
    bbox_rec = torch.stack([tx0, ty0, bw], dim=-1)

    tri, local, pair_valid = segment_ids_from_counts(n_pairs, E)
    overflow = torch.clamp(saturating_cumsum(n_pairs)[-1] - E, min=0)
    br = bbox_rec[tri]
    tile = (br[:, 1] + local // br[:, 2]) * TX + (br[:, 0] + local % br[:, 2])
    tile = torch.where(pair_valid, tile, NT)
    tile_sorted, order = torch.sort(tile, stable=True)
    tri_sorted = tri[order]

    # rank within the tile: distance to the segment start (cummax)
    e = torch.arange(E, device=dev)
    is_start = torch.ones(E, dtype=torch.bool, device=dev)
    is_start[1:] = tile_sorted[1:] != tile_sorted[:-1]
    rank = e - torch.cummax(torch.where(is_start, e, 0), 0).values
    binned = tile_sorted < NT
    in_cap = (rank < K) & binned
    overflow = overflow + ((rank >= K) & binned).sum()
    # out-of-cap pairs write a spare slot NT*K, which is dropped
    tile_tris = torch.full((NT * K + 1,), -1, dtype=torch.int64, device=dev)
    tile_tris[torch.where(in_cap, tile_sorted * K + rank, NT * K)] = \
        tri_sorted
    tile_tris = tile_tris[:NT * K].reshape(NT, K)

    tiles = torch.arange(NT + 1, device=dev)
    bounds = torch.searchsorted(tile_sorted, tiles)
    counts = torch.clamp(bounds[1:] - bounds[:-1], max=K).to(torch.int32)

    blocks = setup["raster_rec"][torch.clamp(tile_tris, min=0)]
    blocks = bake_tile_origin(blocks, tiles[:NT, None], config)
    blocks[:, :, fr.F_ID] = torch.where(tile_tris >= 0,
                                        blocks[:, :, fr.F_ID], -1.0)
    return blocks, counts, overflow


def bin_triangles_pairs(setup: dict, config: RasterConfig, ty_range=None):
    """Pair-centric binning: tile-sorted baked records plus per-tile
    ranges, padded for K1. Returns (rec_sorted, starts, counts, overflow)
    with starts/counts int32. Two streams (config.two_stream_bin: each
    alive triangle's first tile 1:1, the other tiles of multi-tile
    triangles compacted and expanded at pair_capacity / 4; overflow the
    pairs not placed), or one stream expanded at pair_capacity (overflow
    the pairs beyond it). Inside a tile the records keep their stream
    order: two streams put the records of triangles whose first tile it
    is first.

    `ty_range=(ty_lo, rows)`: bin only the `rows` tile rows from tile row
    `ty_lo` (one slab of the sharded raster): every triangle's tile rows
    are clamped to the slab and rebased to local row 0, triangles left
    with no row drop out, and tile ids count the slab's
    ceil(rows * tiles_x / tile_pad) * tile_pad tiles; record b
    coefficients are still baked to GLOBAL pixel origins, so K1, which
    evaluates tile-local pixel coordinates only, runs unchanged."""
    TX = config.tiles_x
    if ty_range is None:
        NT = config.n_tiles_padded
        ty_lo, row_px_offset = 0, 0
    else:
        ty_lo, local_rows = ty_range
        NT = -(-(local_rows * TX) // config.tile_pad) * config.tile_pad
        row_px_offset = ty_lo * config.tile_h
    EB = config.pair_capacity // 4  # extra-pair stream capacity
    dev = setup["sx"].device
    alive, tx0, ty0, tx1, ty1 = _tile_bounds(setup, config)
    if ty_range is not None:
        # clamp to the slab's tile rows; rebase to local row 0
        ty0 = torch.clamp(ty0, min=ty_lo) - ty_lo
        ty1 = torch.clamp(ty1, max=ty_lo + local_rows - 1) - ty_lo
        alive = alive & (ty1 >= ty0)
    bw = tx1 - tx0 + 1
    n_pairs = torch.where(alive, bw * (ty1 - ty0 + 1), 0)
    bbox_rec = torch.stack([tx0, ty0, bw], dim=-1)
    EA = n_pairs.shape[0]

    if config.two_stream_bin:
        # Stream A: first tile per alive triangle, slot i <-> triangle i.
        tile_a = torch.where(alive, ty0 * TX + tx0, NT)
        tri_a = torch.arange(EA, device=dev)
        # Stream B: remaining tiles of multi-tile triangles, compacted.
        n_extra = torch.clamp(n_pairs - 1, min=0)
        has_extra = n_extra > 0
        parents = torch.argsort((~has_extra).to(torch.uint8),
                                stable=True)[:EB]
        counts_b = torch.where(has_extra[parents], n_extra[parents], 0)
        seg_b, local_b, valid_b = segment_ids_from_counts(counts_b, EB)
        tri_b = parents[seg_b]
        br = bbox_rec[tri_b]
        k = local_b + 1  # tile within the parent bbox, skipping (0, 0)
        tile_b = (br[:, 1] + k // br[:, 2]) * TX + (br[:, 0] + k % br[:, 2])
        tile_b = torch.where(valid_b, tile_b, NT)
        # pairs not placed in B (exact integer form of the JAX f32 count)
        total_extra = n_extra.sum()
        placed_b = torch.clamp(counts_b.sum(), max=EB)
        overflow = torch.clamp(total_extra - placed_b, min=0)
        tile = torch.cat([tile_a, tile_b])
        tri = torch.cat([tri_a, tri_b])
    else:
        # one stream: every pair of every triangle, expanded at E
        E = config.pair_capacity
        tri, local, pair_valid = segment_ids_from_counts(n_pairs, E)
        overflow = torch.clamp(saturating_cumsum(n_pairs)[-1] - E, min=0)
        br = bbox_rec[tri]
        tile = (br[:, 1] + local // br[:, 2]) * TX + (
            br[:, 0] + local % br[:, 2])
        tile = torch.where(pair_valid, tile, NT)

    tile_sorted, order = torch.sort(tile, stable=True)
    rec_sorted = setup["raster_rec"][tri[order]]
    rec_sorted = bake_tile_origin(rec_sorted, tile_sorted, config,
                                  row_px_offset=row_px_offset)
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(NT + 1, device=dev), right=False
    )
    starts = bounds[:-1].to(torch.int32)
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)

    # pad: one chunk for round-down + up to a chunk of capacity remainder
    C = fr.CHUNK
    e_total = rec_sorted.shape[0]
    pad = 2 * C - (e_total % C if e_total % C else C) + C
    rec_sorted = torch.cat(
        [rec_sorted,
         torch.zeros(pad, fr.RECORD_F, dtype=torch.float32, device=dev)]
    )
    return rec_sorted, starts, counts, overflow


# ---------------------------------------------------------------------------
# 3. Fine raster + assembly
# ---------------------------------------------------------------------------


def _untile(depth, trif, config: RasterConfig):
    NT = config.n_tiles
    TY, TX = config.tiles_y, config.tiles_x
    th, tw = config.tile_h, config.tile_w

    def untile(a):
        return (
            a[:NT].reshape(TY, TX, th, tw).permute(0, 2, 1, 3)
            .reshape(TY * th, TX * tw)
        )

    return untile(depth), untile(trif).to(torch.int32)


def fine_raster(records, counts, config: RasterConfig):
    """The block path's fine raster: kernel K2 on the card, its twin on
    the CPU (ops/fine_raster.fine_raster_blocks). Returns the untiled
    (depth, tri_id) images."""
    with profiler.scope("raster.k1"):
        depth, trif = fr.fine_raster_blocks(records, counts)
    with profiler.scope("raster.untile"):
        return _untile(depth, trif, config)


def _pair_payload_stream(rec_sorted, resolve_rec):
    """(E_pad, 24) per-pair payload rows for K1's payload variant
    (RasterConfig.kernel_payload): the slim resolve record gathered in
    pair order. The kernel copies the winner's row as raw 32-bit words,
    so the bitcast u32 / f16 columns ride as they are."""
    if resolve_rec.shape[1] != 24:
        raise ValueError(
            "kernel_payload requires the 24-column slim resolve record "
            "(RasterConfig.slim_rec)")
    ids = rec_sorted[:, fr.F_ID].to(torch.int64)
    return resolve_rec[torch.clamp(ids, 0, resolve_rec.shape[0] - 1)]


def _untile_payload(pay, tri_id, resolve_rec, config: RasterConfig):
    """(NT, 24, TILE_PX) kernel payload -> (H, W, 24) rows, bit-identical
    to resolve_rec[max(tri_id, 0)]: misses get the row-0 record, as the
    gather's clamped index does."""
    NT = config.n_tiles
    TY, TX = config.tiles_y, config.tiles_x
    th, tw = config.tile_h, config.tile_w
    H, W = config.height, config.width
    img = (
        pay[:NT].view(torch.int32).permute(0, 2, 1)
        .reshape(TY, TX, th, tw, -1).permute(0, 2, 1, 3, 4)
        .reshape(TY * th, TX * tw, -1)[:H, :W]
    )
    row0 = resolve_rec[0].view(torch.int32)
    return torch.where(tri_id[..., None] >= 0, img, row0).view(torch.float32)


def count_bins(counts, overflow):
    """The profiler's binning counters: the (triangle, tile) pairs binned
    and the fullest tile's (the per-tile counts, summed and maxed after
    the frames) and the overflow."""
    profiler.count("pairs", counts)
    profiler.count("tile_max", counts)
    profiler.count("overflow.bin", overflow)


@profiler.scoped("raster")
def rasterize(meshes: MeshPoolData, instances: InstanceData, draws: DrawList,
              camera, config: RasterConfig, materials=None,
              inst_rec=None) -> VisBuffer:
    """Setup, binning and fine raster of one frame. `inst_rec`: the f16
    instance record (resolve._inst_rec_f16), needed by slim_rec."""
    if config.kernel_payload and (config.backend != "pallas"
                                  or not config.slim_rec):
        raise ValueError("kernel_payload requires slim_rec and the pair "
                         "path (backend='pallas')")
    track2 = config.alpha_mask
    with profiler.scope("raster.setup"):
        setup = triangle_setup(meshes, instances, draws, camera, config,
                               materials=materials, inst_rec=inst_rec)
        profiler.count("overflow.setup", setup["setup_overflow"])
    H, W = config.height, config.width
    payload_img = None
    if config.backend == "pallas":
        with profiler.scope("raster.bin"):
            rec_sorted, starts, counts, overflow = bin_triangles_pairs(
                setup, config)
            count_bins(counts, overflow)
            payload = None
            if config.kernel_payload:
                payload = _pair_payload_stream(rec_sorted,
                                               setup["resolve_rec"])
        with profiler.scope("raster.k1"):
            outs = fr.fine_raster_pairs(rec_sorted, starts, counts,
                                        track2=track2, payload=payload)
        with profiler.scope("raster.untile"):
            depth, tri_id = _untile(outs[0], outs[1], config)
            if payload is not None:
                payload_img = _untile_payload(outs[-1], tri_id[:H, :W],
                                              setup["resolve_rec"], config)
    elif config.backend == "xla":
        with profiler.scope("raster.bin"):
            records, counts, overflow = bin_triangles(setup, config)
            count_bins(counts, overflow)
        if track2:
            with profiler.scope("raster.k1"):
                outs = fr.fine_raster_blocks(records, counts, track2=True)
            with profiler.scope("raster.untile"):
                depth, tri_id = _untile(outs[0], outs[1], config)
        else:
            depth, tri_id = fine_raster(records, counts, config)
    else:
        raise ValueError(f"unknown raster backend {config.backend!r}")
    with profiler.scope("raster.untile"):
        vis = VisBuffer(
            tri_id=tri_id[:H, :W],
            depth=depth[:H, :W],
            resolve_rec=setup["resolve_rec"],
            overflow=overflow + setup["setup_overflow"],
            payload_img=payload_img,
        )
        if track2:
            depth2, tri_id2 = _untile(outs[2], outs[3], config)
            vis.tri_id2 = tri_id2[:H, :W]
            vis.depth2 = depth2[:H, :W]
    return vis
