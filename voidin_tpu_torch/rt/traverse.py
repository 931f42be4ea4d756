"""Shadow-ray traversal over TLAS -> BLAS: host packing and the plain
PyTorch walk.

Counterpart of the any-hit (occlusion) traversal of
``voidin_tpu/rt/traverse.py`` (shaders/utils/bvh.wgsl:33-122; rays stop at
the first intersection closer than t_max,
src/bin/raytraced_shadows.wgsl:96-102). The JAX package walks the tree in
lock-step ``lax.while_loop``s: a per-ray stack loop (``occluded``), a
packet stack loop (``occluded_packets``) and a stackless packet walk over
exit links (``occluded_threaded``), all with the same hits. The port
takes the table of ``occluded_threaded`` (``pack_threaded_table``) and
repacks it every frame (the skinned scene refits its boxes) into the
layout of its walk (``pack_shadow_rows``): the hand-written kernel in
``csrc/shadow_trace.cu``, reached through ``ops/shadow_trace.py
occluded``, and its plain version here, ``occluded_reference``.

The walk is any hit, so its order decides only how soon a ray stops.
Each step slab-tests both children of a node whose box the ray passed
(their rows lie side by side) and keeps a stack of the second child when
both pass, nearer box first; see ``occluded_reference``. A ray reaches a
leaf only through ancestors whose boxes it passed, as in the JAX walks;
the packet walks visit the union of their lanes' paths, but a lane's hit
is decided by its own slab test at the leaf and its own triangle test,
and a ray that passes a leaf's slab passes every ancestor's (child boxes
lie inside their parents, and ``(b - o) * inv`` is monotone in ``b``), so
the orders give the same hits.

Closest hit (JAX ``closest_hit``, the src/bin/bvh_trace.wgsl demo) cannot
stop at a hit, and its slab tests bound by the best t so far, so its node
visits depend on the visiting order. The port keeps JAX's per-ray stack
walk and its push order (left, right; then the BLAS root; then the BLAS
children left + 1, left + 2) over the row layouts of ``scene_rays``
(``pack_tlas_rows``, ``pack_blas_rows``), so t, the visit counts and the
overflow and exhausted counters are JAX's: the kernel in
``csrc/closest_hit.cu``, reached through ``ops/closest_hit.py
closest_hit``, and its plain version here, ``closest_hit_reference``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import checks, fastmath

MAX_DIST = 1e30
STACK = 48  # closest_hit's per-ray stack entries
MAX_LEAF = 8  # builder leaves are <= 3 except degenerate fallbacks
# The shadow walk expands each node at most once per instance it enters,
# and enters each instance at most once: a ray takes at most n_tlas + the
# sum of the instances' BLAS sizes steps. 2^17 covers that for config 5
# (81 + 20 x 2,676 + 20 x 914 + 2 = 71,883) and every scene the tests
# render; rays that reach it are counted (OcclusionResult.exhausted, aux
# rt_exhausted).
MAX_STEPS = 1 << 17
# the shadow walk's (occluded_reference, csrc/shadow_trace.cu) entries:
# kind << KIND_SHIFT | index, kind BLAS_KIND (the first of a node's two
# child rows, pool row), TLAS_KIND (a TLAS node) or INST_KIND (an
# instance); its stack holds SHADOW_STACK entries, one for each level of
# a TLAS path plus a BLAS path, and both builders stop splitting at depth
# 61, so it does not fill
KIND_SHIFT = 30
BLAS_KIND, TLAS_KIND, INST_KIND = 0, 1, 2
NO_CHILD = -2  # the virtual TLAS root's missing second child
SHADOW_STACK = 128


class OcclusionResult(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    overflow: torch.Tensor  # () i32 pushes dropped on a full stack
    exhausted: torch.Tensor  # () i32, rays still live at max_steps


class ClosestHitResult(NamedTuple):
    t: torch.Tensor  # (R,) f32 hit distance in |direction| units, t_max on
    # a miss
    visits: torch.Tensor  # (R,) i32 stack pops (the demo's heat overlay)
    overflow: torch.Tensor  # () i32 pushes dropped on a full stack
    exhausted: torch.Tensor  # () i32 rays with a stack left at max_steps


class WalkCounts(NamedTuple):
    """What a walk did, summed over its rays (the kernel's bound)."""

    node_visits: int  # slab tests
    instance_entries: int  # ray transforms into a BLAS
    triangle_tests: int  # up to and including a ray's first hit
    missed_pops: int = 0  # closest hit: pops whose slab test fails


def pack_instance_rows(inv_transform, mesh_bvh_index, mesh_base_index,
                       mesh_id):
    """(N, 24) f32: inverse transform (16), the mesh's BLAS root in the
    pool, its first triangle row, 6 zeros."""
    n = inv_transform.shape[0]
    mid = mesh_id.long()
    return torch.cat(
        [
            inv_transform.reshape(n, 16),
            mesh_bvh_index[mid].to(torch.float32)[:, None],
            (mesh_base_index[mid] // 3).to(torch.float32)[:, None],
            torch.zeros(n, 6, dtype=torch.float32,
                        device=inv_transform.device),
        ],
        dim=-1,
    )


def _refuse_big_leaves(max_leaf):
    if max_leaf > MAX_LEAF:
        raise ValueError(
            f"BLAS leaf with {max_leaf} tris exceeds MAX_LEAF={MAX_LEAF}; "
            "traversal would miss intersections (build with "
            "build_bvh=True)")


def pack_blas_rows(bvh_min, bvh_max, left_first, count):
    """(B, 8) f32 BLAS rows [min3, left_first, max3, count] (leaf iff
    count > 0). Leaves above MAX_LEAF (a pool built with build_bvh=False)
    are refused, as the JAX package's pack_blas_rows refuses them."""
    if count.numel():
        _refuse_big_leaves(int(count.max()))
    return torch.cat(
        [bvh_min, left_first.to(torch.float32)[:, None], bvh_max,
         count.to(torch.float32)[:, None]], dim=-1).contiguous()


def pack_tlas_rows(tlas_min, tlas_max, left_right, instance):
    """(B, 8) f32 TLAS rows [min3, a, max3, b]: internal a = left, b =
    right child; leaf a = -1, b = instance."""
    lr = left_right.to(torch.int64) & 0xFFFFFFFF  # u32 bits in int32
    is_leaf = lr == 0
    a = torch.where(is_leaf, -1.0, (lr & 0xFFFF).to(torch.float32))
    b = torch.where(is_leaf, instance.to(torch.float32),
                    (lr >> 16).to(torch.float32))
    return torch.cat([tlas_min, a[:, None], tlas_max, b[:, None]],
                     dim=-1).contiguous()


def scene_rays(scene):
    """(tlas_rows, blas_rows, instance_rows, tri_pos) of a SceneData with a
    TLAS: closest_hit's tables."""
    m, t = scene.meshes, scene.tlas
    if t is None:
        raise ValueError("ray queries need the TLAS: build the scene with "
                         "World.device(with_tlas=True)")
    blas = pack_blas_rows(m.bvh_min, m.bvh_max, m.bvh_left_first,
                          m.bvh_count)
    tlas = pack_tlas_rows(t.tlas_min, t.tlas_max, t.tlas_left_right,
                          t.tlas_instance)
    inst = pack_instance_rows(scene.instances.inv_transform, m.bvh_index,
                              m.base_index, scene.instances.mesh_id)
    return tlas, blas, inst, m.tri_pos


def pack_threaded_table(tlas_min, tlas_max, tlas_left_right, tlas_instance,
                        tlas_exit, blas_min, blas_max, blas_left_first,
                        blas_count, blas_exit, max_leaf):
    """ONE (Bt+Bb, 16) f32 node table of 64 B rows:
    [min3, a, max3, exit, count, pad7]. TLAS rows first (a = left child,
    or -(instance+1) for leaves; exit globally encoded e+1, 0 = done);
    BLAS rows after (a = left_first, mesh-local; leaf iff count > 0; exit
    mesh-local e+1, 0 = subtree done). Returns (table, n_tlas).

    `max_leaf` is the pool's largest leaf (MeshPoolData.bvh_max_leaf):
    leaves above MAX_LEAF (a pool built with build_bvh=False) are refused,
    as the JAX package's pack_blas_rows refuses them."""
    _refuse_big_leaves(max_leaf)
    # left_right carries u32 bits in int32: unpack in int64
    lr = tlas_left_right.to(torch.int64) & 0xFFFFFFFF
    left = (lr & 0xFFFF).to(torch.float32)
    a_t = torch.where(lr == 0, -(tlas_instance.to(torch.float32) + 1.0),
                      left)
    dev = tlas_min.device
    bt, bb = tlas_min.shape[0], blas_min.shape[0]
    trow = torch.cat(
        [tlas_min, a_t[:, None], tlas_max,
         tlas_exit.to(torch.float32)[:, None],
         torch.zeros(bt, 8, dtype=torch.float32, device=dev)],
        dim=-1,
    )
    brow = torch.cat(
        [blas_min, blas_left_first.to(torch.float32)[:, None], blas_max,
         blas_exit.to(torch.float32)[:, None],
         blas_count.to(torch.float32)[:, None],
         torch.zeros(bb, 7, dtype=torch.float32, device=dev)],
        dim=-1,
    )
    return torch.cat([trow, brow], dim=0).contiguous(), bt


def scene_rays_threaded(scene):
    """(table, n_tlas, instance_rows, tri_pos) of a SceneData with a
    TLAS."""
    m, t = scene.meshes, scene.tlas
    if t is None:
        raise ValueError("raytraced shadows need the TLAS: build the scene "
                         "with World.device(with_tlas=True)")
    table, n_tlas = pack_threaded_table(
        t.tlas_min, t.tlas_max, t.tlas_left_right, t.tlas_instance,
        t.tlas_exit, m.bvh_min, m.bvh_max, m.bvh_left_first, m.bvh_count,
        m.bvh_exit, m.bvh_max_leaf)
    inst = pack_instance_rows(scene.instances.inv_transform, m.bvh_index,
                              m.base_index, scene.instances.mesh_id)
    return table, n_tlas, inst, m.tri_pos


def inv_direction(d):
    """1 / d with |d| <= 1e-20 replaced by 1e-20."""
    return 1.0 / torch.where(d.abs() > 1e-20, d, 1e-20)


def _slab(o, inv_d, bmin, bmax, t_max):
    """intersections.wgsl:13-24 — hit iff tmax' >= tmin', tmin' < t,
    tmax' > 0. maximum / minimum / amin / amax let NaN through, as jnp's
    do."""
    return _slab_lo(o, inv_d, bmin, bmax, t_max)[0]


def _slab_lo(o, inv_d, bmin, bmax, t_max):
    """_slab and tmin', the distance at which the ray enters the box."""
    tx1 = (bmin - o) * inv_d
    tx2 = (bmax - o) * inv_d
    hi = torch.amin(torch.maximum(tx1, tx2), dim=-1)
    lo = torch.amax(torch.minimum(tx1, tx2), dim=-1)
    return (hi >= lo) & (lo < t_max) & (hi > 0.0), lo


def _tri_hit_edges(o, d, v0, e1, e2, t_max):
    """Backface-culled Moller-Trumbore (intersections.wgsl:26-45), with
    jnp.cross's rounding (fastmath.cross) and jnp.sum's order, on a
    triangle given by its corner v0 and its edges e1 = v1 - v0 and e2 =
    v2 - v0 (the shadow rows' layout; JAX subtracts the same f32
    corners)."""
    uvec = fastmath.cross(d, e2)
    det = fastmath.sum3(e1 * uvec)
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1e-20)
    orig = o - v0
    u = inv_det * fastmath.sum3(orig * uvec)
    vvec = fastmath.cross(orig, e1)
    v = inv_det * fastmath.sum3(d * vvec)
    t = inv_det * fastmath.sum3(e2 * vvec)
    return ((det >= 1e-10) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
            & (u + v <= 1.0) & (t > 0.0) & (t < t_max))


def _tri_t(o, d, v0, v1, v2):
    """Hit distance, -1 on a miss (JAX traverse.py _tri_t), rounded as the
    JAX closest_hit loop rounds it: XLA fuses each jnp.sum(a * b) of the
    jitted loop body into a chain of fused multiply-adds
    (fastmath.dot_fma), where _tri_hit_edges keeps plain sums."""
    e1 = v1 - v0
    e2 = v2 - v0
    uvec = fastmath.cross(d, e2)
    det = fastmath.dot_fma(e1, uvec)
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1e-20)
    orig = o - v0
    u = inv_det * fastmath.dot_fma(orig, uvec)
    vvec = fastmath.cross(orig, e1)
    v = inv_det * fastmath.dot_fma(d, vvec)
    t = inv_det * fastmath.dot_fma(e2, vvec)
    ok = ((det >= 1e-10) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0))
    return torch.where(ok, t, -1.0)


class ShadowRows(NamedTuple):
    """The shadow kernel's layout of a scene (pack_shadow_rows). Integer
    words are int32 bits in the f32 rows."""

    top: torch.Tensor  # (n_tlas + 1) * 8 TLAS words, then n_inst * 16
    n_tlas: int
    n_inst: int
    blas: torch.Tensor  # (Bb, 8) [min3, ref, max3, count]
    tris: torch.Tensor  # (T, 12) [v0, e1, e2, 0, 0, 0]


def _bits(x):
    """f32 holding small integers -> the same integers as int32 bits in
    f32 words."""
    return x.to(torch.int32).view(torch.float32)


def pack_shadow_rows(table, n_tlas, instance_rows, tri_pos):
    """The threaded tables of scene_rays_threaded in the layout the shadow
    kernel walks (ShadowRows), with every integer as int32 bits:

    - TLAS rows, 32 B: [min3, left, max3, right] for an internal node
      (right = the exit link of the left child, its sibling), [min3,
      -(instance + 1), max3, -1] for a leaf; then a virtual root
      (n_tlas) whose one child is the root (left 0, right NO_CHILD);
    - instance rows, 64 B: the inverse transform's first 12 words, the
      mesh's BLAS root (pool row), its first triangle row, 2 zeros;
    - BLAS rows, 32 B: [min3, left_first, max3, count] (mesh-local
      left_first; leaf iff count > 0; an internal node's children are
      the adjacent rows left_first and left_first + 1);
    - triangle rows, 48 B: [v0, e1, e2, 0, 0, 0] with e1 = v1 - v0 and
      e2 = v2 - v0, the subtractions JAX's _tri_hit makes.

    The tables' exit links are not needed: the walk keeps a stack."""
    dev = table.device
    t, b = table[:n_tlas], table[n_tlas:]
    a = t[:, 3]
    internal = a >= 0.0
    left = checks.check_index(torch.where(internal, a, 0.0).to(torch.int64),
                              n_tlas, "rt.node")
    right = torch.where(internal,
                        t[left.clamp(0, max(n_tlas - 1, 0)), 7] - 1.0, -1.0)
    root = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    root[0, 7] = NO_CHILD  # a fill, not a copy from the host (no sync)
    tl = torch.cat([torch.cat([t[:, 0:3], _bits(a)[:, None], t[:, 4:7],
                               _bits(right)[:, None]], 1),
                    root.view(torch.float32)], 0)
    n_inst = instance_rows.shape[0]
    inst = torch.cat([instance_rows[:, :12], _bits(instance_rows[:, 16:18]),
                      torch.zeros(n_inst, 2, device=dev)], 1)
    blas = torch.cat([b[:, 0:3], _bits(b[:, 3])[:, None], b[:, 4:7],
                      _bits(b[:, 8])[:, None]], 1).contiguous()
    v0 = tri_pos[:, 0:3]
    tris = torch.cat([v0, tri_pos[:, 3:6] - v0, tri_pos[:, 6:9] - v0,
                      torch.zeros(tri_pos.shape[0], 3, device=dev)], 1)
    top = torch.cat([tl.reshape(-1), inst.reshape(-1)]).contiguous()
    return ShadowRows(top, n_tlas, n_inst, blas, tris.contiguous())


def _entry(kind, idx):
    return (kind << KIND_SHIFT) | idx


def occluded_reference(table, n_tlas, instance_rows, tri_pos, origins,
                       directions, t_max=1.0, max_steps=MAX_STEPS,
                       active=None, max_leaf=MAX_LEAF, visits_out=None):
    """Plain PyTorch version of csrc/shadow_trace.cu: every ray's walk over
    pack_shadow_rows's layout, run in lock-step over the live rays (one
    step per ray and step) until no ray is live or `max_steps` steps are
    taken. Rays are (R, 3) origins and (R, 3) directions, not normalized:
    t_max is in units of |direction|. Inactive rays (`active` False) do
    not walk and do not hit. `visits_out`, an optional (R,) int64 tensor,
    gets each ray's slab tests added. Returns (OcclusionResult,
    WalkCounts).

    A step takes the ray's current entry, a node whose box it passed (or
    an instance it enters), and slab-tests that node's children: a TLAS
    node's two children in world space (the virtual root's one child, the
    root, first); for an instance, the ray moved into its object space
    (fastmath.mat4_point / mat3_vec) and its BLAS root; a BLAS node's two
    children in object space. Each child hit in order: an internal node
    or an instance becomes an entry; a BLAS leaf has its triangles tested
    at once (_tri_hit_edges), and the first hit ends the walk. Of two new
    entries the one whose box the ray enters first (the slab's tmin'; the
    first child on a tie) is next and the other is pushed on the ray's
    stack (SHADOW_STACK entries; a push onto a full stack is dropped and
    counted in `overflow`); with none, the next comes off the stack, and
    an empty stack ends the walk. Every node a ray reaches has had every
    ancestor's box test pass, as in JAX's walks, so the hits are theirs."""
    dev = origins.device
    R = origins.shape[0]
    i64 = torch.int64
    rows = pack_shadow_rows(table, n_tlas, instance_rows, tri_pos)
    tl = rows.top[:(n_tlas + 1) * 8].view(n_tlas + 1, 8)
    tl_i = tl.view(torch.int32).to(i64)
    inst = rows.top[(n_tlas + 1) * 8:].view(rows.n_inst, 16)
    inst_i = inst.view(torch.int32).to(i64)
    blas, tris = rows.blas, rows.tris
    blas_i = blas.view(torch.int32).to(i64)
    n_blas = blas.shape[0]
    ids = torch.arange(R, device=dev)
    if active is not None:
        ids = ids[active]
    n = ids.numel()
    o, d = origins[ids], directions[ids]
    inv0 = inv_direction(d)
    tm = torch.full((n,), float(t_max), dtype=torch.float32, device=dev)
    co, cd, cinv = o.clone(), d.clone(), inv0.clone()
    tri_base = torch.zeros(n, dtype=i64, device=dev)
    bvh_base = torch.zeros(n, dtype=i64, device=dev)
    cur = torch.full((n,), _entry(TLAS_KIND, n_tlas), dtype=i64, device=dev)
    stack = torch.zeros(n, 8, dtype=i64, device=dev)
    sp = torch.zeros(n, dtype=i64, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    live = torch.arange(n, device=dev)
    visits = entries = tests = overflow = 0
    steps = 0
    while live.numel() and steps < max_steps:
        steps += 1
        c = cur[live]
        kind, idx = c >> KIND_SHIFT, c & ((1 << KIND_SHIFT) - 1)
        is_t, is_i = kind == TLAS_KIND, kind == INST_KIND

        # instance entries: the ray in the instance's object space
        e = live[is_i]
        if e.numel():
            ir = checks.check_index(idx[is_i], rows.n_inst, "rt.instance")
            m = inst[ir, :12].reshape(-1, 3, 4)
            co[e] = fastmath.mat4_point(m, o[e])
            cd[e] = fastmath.mat3_vec(m[:, :, :3], d[e])
            cinv[e] = inv_direction(cd[e])
            bvh_base[e] = inst_i[ir, 12]
            tri_base[e] = inst_i[ir, 13]
            entries += e.numel()

        # the (up to) two rows a step tests
        node = idx.clamp(0, n_tlas).where(is_t, 0)
        first = torch.where(is_t, tl_i[node, 3], 0)
        second = torch.where(is_t, tl_i[node, 7], NO_CHILD)
        b0 = torch.where(is_i, bvh_base[live], idx)
        rows_t = [tl[checks.check_index(first.where(is_t, 0), n_tlas,
                                        "rt.node")],
                  tl[checks.check_index(second.where(is_t & (second >= 0),
                                                     0), n_tlas, "rt.node")]]
        blas_j = [checks.check_index(b0.where(~is_t, 0), n_blas, "rt.node"),
                  checks.check_index((b0 + 1).where(~is_t & ~is_i, 0),
                                     n_blas, "rt.node")]
        two = torch.where(is_t, second >= 0, ~is_i)
        ray_o = torch.where(is_t[:, None], o[live], co[live])
        ray_inv = torch.where(is_t[:, None], inv0[live], cinv[live])
        cand, hits, los = [], [], []
        done = torch.zeros(live.numel(), dtype=torch.bool, device=dev)
        for j in range(2):
            row = torch.where(is_t[:, None], rows_t[j], blas[blas_j[j]])
            row_i = row.view(torch.int32).to(i64)
            tested = (j == 0) | two
            h, lo = _slab_lo(ray_o, ray_inv, row[:, 0:3], row[:, 4:7],
                             tm[live])
            h = h & tested
            los.append(lo)
            visits += int(tested.sum())
            if visits_out is not None:
                visits_out.index_add_(0, ids[live], tested.to(i64))
            ref, count = row_i[:, 3], row_i[:, 7]
            leaf = h & ~is_t & (count > 0) & ~done
            lr = torch.nonzero(leaf).flatten()
            if lr.numel():
                rr = live[lr]
                first_tri = tri_base[rr] + ref[lr]
                cnt = count[lr]
                lh = torch.zeros(lr.numel(), dtype=torch.bool, device=dev)
                for k in range(max_leaf):
                    mk = k < cnt
                    tests += int((mk & ~lh).sum())
                    tri = tris[torch.where(mk, first_tri + k, 0)]
                    lh |= mk & _tri_hit_edges(co[rr], cd[rr], tri[:, 0:3],
                                              tri[:, 3:6], tri[:, 6:9],
                                              tm[rr])
                done[lr] |= lh
            child = first if j == 0 else second
            entry = torch.where(
                is_t, torch.where(ref >= 0, _entry(TLAS_KIND, child.clamp(0)),
                                  _entry(INST_KIND, (-ref - 1).clamp(0))),
                _entry(BLAS_KIND, bvh_base[live] + ref.clamp(0)))
            cand.append(entry)
            hits.append(h & (is_t | (count <= 0)))
        hit[live[done]] = True
        h0, h1 = hits
        both = h0 & h1 & ~done
        # of two entries, the one whose box the ray enters first is next
        swap = both & (los[1] < los[0])
        cand = [torch.where(swap, cand[1], cand[0]),
                torch.where(swap, cand[0], cand[1])]
        sp_l = sp[live]
        if both.any():
            if int(sp_l.max()) >= stack.shape[1]:
                grow = min(stack.shape[1], SHADOW_STACK - stack.shape[1])
                stack = torch.cat([stack, torch.zeros_like(stack[:, :grow])],
                                  1)
            room = both & (sp_l < SHADOW_STACK)
            overflow += int((both & ~room).sum())
            pr = live[room]
            stack[pr, sp_l[room]] = cand[1][room]
            sp[pr] += 1
        nxt = torch.where(h0, cand[0], cand[1])
        has = (h0 | h1) & ~done
        pop = ~has & ~done & (sp_l > 0)
        if pop.any():
            pr = live[pop]
            sp[pr] -= 1
            nxt[pop] = stack[pr, sp[pr]]
        cur[live] = nxt
        live = live[(has | pop) & ~done]
    out = torch.zeros(R, dtype=torch.bool, device=dev)
    out[ids] = hit
    res = OcclusionResult(
        hit=out,
        overflow=torch.tensor(overflow, dtype=torch.int32, device=dev),
        exhausted=torch.tensor(live.numel(), dtype=torch.int32, device=dev),
    )
    return res, WalkCounts(visits, entries, tests)


def closest_hit_reference(tlas_rows, blas_rows, instance_rows, tri_pos,
                          origins, directions, t_max=MAX_DIST,
                          max_steps=2048, active=None):
    """Plain PyTorch version of csrc/closest_hit.cu: JAX closest_hit's
    per-ray stack walk, run in lock-step over the rays whose stack is not
    empty (one pop per ray and step) until none is left or `max_steps`
    steps are taken. Tables from scene_rays; (R, 3) origins and
    directions, not normalized; `t_max` a float or (R,) f32, in units of
    |direction|; inactive rays (`active` False) walk nothing.

    A pop of TLAS node n runs the world-space slab test against the ray's
    best t so far; a hit on an internal node pushes its left child, then
    its right; on a leaf it moves the ray into the instance's object
    space and pushes the BLAS root. A pop of BLAS node n runs the
    object-space slab test; a hit on a leaf takes each of its triangles
    whose t lies in (0, best t); on an internal node it pushes the
    children left + 1, then left + 2 (mesh-local, offset by the BLAS
    base). A push onto a full stack (STACK entries) is dropped and counted
    in `overflow`. Returns (ClosestHitResult, WalkCounts)."""
    dev = origins.device
    R = origins.shape[0]
    i64 = torch.int64
    t = torch.as_tensor(t_max, dtype=torch.float32,
                        device=dev).expand(R).clone()
    inv0 = inv_direction(directions)
    co, cd, cinv = origins.clone(), directions.clone(), inv0.clone()
    tri_base = torch.zeros(R, dtype=i64, device=dev)
    bvh_base = torch.zeros(R, dtype=i64, device=dev)
    visits = torch.zeros(R, dtype=torch.int32, device=dev)
    stack = torch.zeros(R, STACK, dtype=i64, device=dev)
    stack[:, 0] = 1
    sp = torch.ones(R, dtype=i64, device=dev)
    if active is not None:
        sp = torch.where(active, sp, 0)
    overflow = 0
    n_visits = entries = tests = missed = 0

    def push(rows, value):
        nonlocal overflow
        full = sp[rows] >= STACK
        overflow += int(full.sum())
        rows, value = rows[~full], value[~full]
        stack[rows, sp[rows]] = value
        sp[rows] += 1

    steps = 0
    live = torch.nonzero(sp > 0).flatten()
    while live.numel() and steps < max_steps:
        steps += 1
        sp[live] -= 1
        entry = stack[live, sp[live]]
        visits[live] += 1
        n_visits += live.numel()

        # TLAS pops: slab in world space; internal -> left, right; leaf ->
        # enter the instance
        tl = live[entry > 0]
        trow = tlas_rows[checks.check_index(
            entry[entry > 0] - 1, tlas_rows.shape[0], "rt.tlas_node")]
        hit = _slab(origins[tl], inv0[tl], trow[:, 0:3], trow[:, 4:7],
                    t[tl])
        missed += int((~hit).sum())
        leaf = trow[:, 3] < 0.0
        inner = tl[hit & ~leaf]
        if inner.numel():
            rows = trow[hit & ~leaf]
            push(inner, rows[:, 3].to(i64) + 1)
            push(inner, rows[:, 7].to(i64) + 1)
        e = tl[hit & leaf]
        if e.numel():
            irow = instance_rows[checks.check_index(
                trow[hit & leaf][:, 7].to(i64), instance_rows.shape[0],
                "rt.instance")]
            inv_t = irow[:, :16].reshape(-1, 4, 4)
            co[e] = fastmath.mat4_point_fma(inv_t, origins[e])
            cd[e] = fastmath.mat3_vec_fma(inv_t[:, :3, :3], directions[e])
            cinv[e] = inv_direction(cd[e])
            bvh_base[e] = irow[:, 16].to(i64)
            tri_base[e] = irow[:, 17].to(i64)
            push(e, -(bvh_base[e] + 1))
            entries += e.numel()

        # BLAS pops: slab in object space; leaf -> its triangles; internal
        # -> the children left + 1, left + 2
        bl = live[entry < 0]
        brow = blas_rows[checks.check_index(
            -entry[entry < 0] - 1, blas_rows.shape[0], "rt.blas_node")]
        hit = _slab(co[bl], cinv[bl], brow[:, 0:3], brow[:, 4:7], t[bl])
        missed += int((~hit).sum())
        count = brow[:, 7].to(i64)
        left = brow[:, 3].to(i64)
        inner = hit & (count <= 0)
        ib = bl[inner]
        if ib.numel():
            push(ib, -(bvh_base[ib] + left[inner] + 1))
            push(ib, -(bvh_base[ib] + left[inner] + 2))
        lf = hit & (count > 0)
        lr = bl[lf]
        if lr.numel():
            first = tri_base[lr] + left[lf]
            cnt = count[lf]
            best = t[lr]
            for k in range(int(cnt.max())):
                m = k < cnt
                tests += int(m.sum())
                tri = tri_pos[torch.where(m, first + k, 0)]
                th = _tri_t(co[lr], cd[lr], tri[:, 0:3], tri[:, 3:6],
                            tri[:, 6:9])
                best = torch.where(m & (th > 0.0) & (th < best), th, best)
            t[lr] = best
        live = live[sp[live] > 0]
    res = ClosestHitResult(
        t=t, visits=visits,
        overflow=torch.tensor(overflow, dtype=torch.int32, device=dev),
        exhausted=(sp > 0).sum().to(torch.int32),
    )
    return res, WalkCounts(n_visits, entries, tests, missed)


def check_threaded_table(table, n_tlas, instance_rows, tri_pos):
    """Hold every link column of the shadow kernel's tables
    (scene_rays_threaded) to the table sizes, raising IndexError under the
    twin's names: TLAS children and exit links and the instances' BLAS
    roots ("rt.node"), TLAS leaves ("rt.instance"), BLAS children (the
    first and the second) and exit links ("rt.node", mesh-local, so held
    to the BLAS region), BLAS leaf triangle ranges and the instances'
    first triangles
    ("rt.tri_pos", which the JAX package does not check). What
    ops/shadow_trace.py runs before a launch in the bounds mode: a link
    that stays in its table but leaves its mesh is not caught."""
    n_blas = table.shape[0] - n_tlas
    n_tri = tri_pos.shape[0]
    t, b = table[:n_tlas], table[n_tlas:]
    a_t, a_b, count = t[:, 3], b[:, 3], b[:, 8]
    checks.check_indices([
        (a_t, n_tlas, "rt.node", a_t >= 0),
        (-a_t - 1.0, instance_rows.shape[0], "rt.instance", ~(a_t >= 0)),
        (t[:, 7], n_tlas + 1, "rt.node"),
        (instance_rows[:, 16], n_blas, "rt.node"),
        (a_b, n_blas, "rt.node", ~(count > 0)),
        (a_b + 1.0, n_blas, "rt.node", ~(count > 0)),
        (b[:, 7], n_blas + 1, "rt.node"),
        (count, n_tri + 1, "rt.tri_pos"),
        (instance_rows[:, 17], n_tri, "rt.tri_pos"),
        (a_b, n_tri, "rt.tri_pos", count > 0),
        (a_b + count - 1.0, n_tri, "rt.tri_pos", count > 0),
    ])


def check_stack_tables(tlas_rows, blas_rows, instance_rows, tri_pos):
    """Hold every link column of the closest-hit kernel's tables
    (scene_rays) to the table sizes, raising IndexError under the twin's
    names: TLAS children ("rt.tlas_node"), TLAS leaves ("rt.instance"),
    the instances' BLAS roots and the BLAS children left + 1, left + 2
    ("rt.blas_node", mesh-local, so held to the BLAS table), BLAS leaf
    triangle ranges and the instances' first triangles ("rt.tri_pos",
    which the JAX package does not check). What ops/closest_hit.py runs
    before a launch in the bounds mode."""
    n_tlas, n_blas = tlas_rows.shape[0], blas_rows.shape[0]
    n_tri = tri_pos.shape[0]
    a_t, b_t = tlas_rows[:, 3], tlas_rows[:, 7]
    left, count = blas_rows[:, 3], blas_rows[:, 7]
    checks.check_indices([
        (a_t, n_tlas, "rt.tlas_node", a_t >= 0),
        (b_t, n_tlas, "rt.tlas_node", a_t >= 0),
        (b_t, instance_rows.shape[0], "rt.instance", ~(a_t >= 0)),
        (instance_rows[:, 16], n_blas, "rt.blas_node"),
        (left, n_blas, "rt.blas_node", ~(count > 0)),
        (left + 1.0, n_blas, "rt.blas_node", ~(count > 0)),
        (count, n_tri + 1, "rt.tri_pos"),
        (instance_rows[:, 17], n_tri, "rt.tri_pos"),
        (left, n_tri, "rt.tri_pos", count > 0),
        (left + count - 1.0, n_tri, "rt.tri_pos", count > 0),
    ])
