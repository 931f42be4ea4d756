"""Shadow-ray traversal over TLAS -> BLAS: host packing and the plain
PyTorch walk.

Counterpart of the any-hit (occlusion) traversal of
``voidin_tpu/rt/traverse.py`` (shaders/utils/bvh.wgsl:33-122; rays stop at
the first intersection closer than t_max,
src/bin/raytraced_shadows.wgsl:96-102). The JAX package walks the tree in
lock-step ``lax.while_loop``s: a per-ray stack loop (``occluded``), a
packet stack loop (``occluded_packets``) and a stackless packet walk over
exit links (``occluded_threaded``), all with the same hits. The port walks
each ray on its own over the exit-link table of ``occluded_threaded``
(``pack_threaded_table``): the hand-written kernel in
``csrc/shadow_trace.cu``, reached through ``ops/shadow_trace.py occluded``,
and its plain version here, ``occluded_reference``.

A per-ray walk gives the packet walks' hits: a packet visits the union of
its lanes' paths, but a lane's hit is decided by its own slab test at the
leaf and its own triangle test, and a ray that passes a leaf's slab passes
every ancestor's (child boxes lie inside their parents, and
``(b - o) * inv`` is monotone in ``b``), so the extra visits add no hit.

The walk: ``cur`` encodes TLAS node t as t+1 and pool BLAS node b as
-(b+1), 0 = done. At a node the ray runs the slab test (world space at
TLAS nodes, object space inside a BLAS): an internal node hit goes to its
first child, a miss to its exit link; a TLAS leaf hit transforms the ray
by the instance's inverse, saves the leaf's exit in ``resume`` and enters
the BLAS root; a BLAS leaf hit tests its triangles; a BLAS exit of 0
resumes at the saved TLAS exit. No stack, so nothing overflows.

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
# The walk visits each node at most once per instance it enters, and
# enters each instance at most once: a ray takes at most n_tlas + the sum of
# the instances' BLAS sizes steps. 2^17 covers that for config 5 (81 + 20 x
# 2,676 + 20 x 914 + 2 = 71,883) and every scene the tests render; rays
# that reach it are counted (OcclusionResult.exhausted, aux rt_exhausted).
MAX_STEPS = 1 << 17


class OcclusionResult(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    overflow: torch.Tensor  # () i32, always 0: the walk has no stack
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
    tx1 = (bmin - o) * inv_d
    tx2 = (bmax - o) * inv_d
    hi = torch.amin(torch.maximum(tx1, tx2), dim=-1)
    lo = torch.amax(torch.minimum(tx1, tx2), dim=-1)
    return (hi >= lo) & (lo < t_max) & (hi > 0.0)


def _tri_hit(o, d, v0, v1, v2, t_max):
    """Backface-culled Moller-Trumbore (intersections.wgsl:26-45), with
    jnp.cross's rounding (fastmath.cross) and jnp.sum's order."""
    e1 = v1 - v0
    e2 = v2 - v0
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
    (fastmath.dot_fma), where _tri_hit's twin keeps plain sums."""
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


def occluded_reference(table, n_tlas, instance_rows, tri_pos, origins,
                       directions, t_max=1.0, max_steps=MAX_STEPS,
                       active=None, max_leaf=MAX_LEAF):
    """Plain PyTorch version of csrc/shadow_trace.cu: every ray's stackless
    walk, run in lock-step over the live rays (one node per ray and
    step) until no ray is live or `max_steps` steps are taken. Rays are
    (R, 3) origins and (R, 3) directions, not normalized: t_max is in units
    of |direction|. Inactive rays (`active` False) do not walk and do not
    hit. Returns (OcclusionResult, WalkCounts)."""
    dev = origins.device
    R = origins.shape[0]
    i64 = torch.int64
    tm = torch.as_tensor(t_max, dtype=torch.float32,
                         device=dev).expand(R)
    inv0 = inv_direction(directions)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    cur = torch.ones(R, dtype=i64, device=dev)
    resume = torch.zeros(R, dtype=i64, device=dev)
    tri_base = torch.zeros(R, dtype=i64, device=dev)
    bvh_base = torch.zeros(R, dtype=i64, device=dev)
    co, cd, cinv = origins.clone(), directions.clone(), inv0.clone()
    live = torch.arange(R, device=dev)
    if active is not None:
        live = live[active]
    visits = entries = tests = 0
    steps = 0
    while live.numel() and steps < max_steps:
        steps += 1
        c = cur[live]
        is_blas = c < 0
        row = table[checks.check_index(
            torch.where(is_blas, n_tlas - c - 1, c - 1), table.shape[0],
            "rt.node")]
        a, exit_enc = row[:, 3], row[:, 7].to(i64)
        count = torch.where(is_blas, row[:, 8], 0.0).to(i64)
        blas3 = is_blas[:, None]
        shit = _slab(torch.where(blas3, co[live], origins[live]),
                     torch.where(blas3, cinv[live], inv0[live]),
                     row[:, 0:3], row[:, 4:7], tm[live])
        visits += live.numel()

        # TLAS leaf hit: enter the instance
        enter = shit & ~is_blas & (a < 0.0)
        e = live[enter]
        if e.numel():
            irow = instance_rows[checks.check_index(
                (-a[enter] - 1.0).to(i64), instance_rows.shape[0],
                "rt.instance")]
            inv_t = irow[:, :16].reshape(-1, 4, 4)
            co[e] = fastmath.mat4_point(inv_t, origins[e])
            cd[e] = fastmath.mat3_vec(inv_t[:, :3, :3], directions[e])
            cinv[e] = inv_direction(cd[e])
            bvh_base[e] = irow[:, 16].to(i64)
            tri_base[e] = irow[:, 17].to(i64)
            resume[e] = exit_enc[enter]
            entries += e.numel()

        # BLAS leaf hit: its triangles, up to the first hit
        leaf = shit & is_blas & (count > 0)
        lr = live[leaf]
        if lr.numel():
            first = tri_base[lr] + a[leaf].to(i64)
            cnt = count[leaf]
            lh = torch.zeros(lr.numel(), dtype=torch.bool, device=dev)
            for k in range(max_leaf):
                m = k < cnt
                tests += int((m & ~lh).sum())
                tri = tri_pos[torch.where(m, first + k, 0)]
                lh |= m & _tri_hit(co[lr], cd[lr], tri[:, 0:3], tri[:, 3:6],
                                   tri[:, 6:9], tm[lr])
            hit[lr] = lh

        # next node: internal hit -> first child, TLAS leaf hit -> BLAS
        # root, otherwise the exit link (a BLAS exit of 0 -> resume)
        bb = bvh_base[live]
        ai = a.to(i64)
        exit_b = torch.where(exit_enc > 0, -(bb + exit_enc), resume[live])
        nxt = torch.where(
            shit & ~is_blas & (a >= 0.0), ai + 1,
            torch.where(
                enter, -(bb + 1),
                torch.where(
                    shit & is_blas & (count <= 0), -(bb + ai + 1),
                    torch.where(is_blas, exit_b, exit_enc))))
        cur[live] = nxt
        live = live[(nxt != 0) & ~hit[live]]
    res = OcclusionResult(
        hit=hit,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
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
    n_visits = entries = tests = 0

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
    return res, WalkCounts(n_visits, entries, tests)


def check_threaded_table(table, n_tlas, instance_rows, tri_pos):
    """Hold every link column of the shadow kernel's tables
    (scene_rays_threaded) to the table sizes, raising IndexError under the
    twin's names: TLAS children and exit links and the instances' BLAS
    roots ("rt.node"), TLAS leaves ("rt.instance"), BLAS children and
    exit links ("rt.node", mesh-local, so held to the BLAS region), BLAS
    leaf triangle ranges and the instances' first triangles
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
