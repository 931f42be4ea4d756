"""SAH BVH (BLAS) and TLAS builders + numpy traversal oracle.

The port's own copy of ``voidin_tpu/rt/bvh.py`` (numpy only), so that the
port builds the very trees the JAX package builds: with the same builder
(numpy here, or the C++ one of ``voidin_tpu_torch/native``) the nodes, the
permuted indices, the exit links and the refit plans are bit-identical.

Node layouts are byte-compatible with the reference renderer so device
traversal code shares one contract:

* BLAS node (32 B): {min: vec3, left_first: u32, max: vec3, count: u32};
  leaf iff count > 0; children adjacent at (left_first, left_first+1);
  triangles of a leaf are contiguous in the (permuted) index buffer
  — crates/bvh/src/blas.rs:10-17.
* TLAS node (32 B): {min: vec3, left_right: u32 (lo16=left, hi16=right),
  max: vec3, instance_idx: u32}; leaf iff left_right == 0; root at slot 0
  — crates/bvh/src/tlas.rs:8-14.

The builders are a vectorized, level-synchronous binned-SAH build (numpy;
the C++ fast path in ``native``) and a top-down SAH TLAS. The two builders
are not bit-identical to each other; tests assert structural invariants
and oracle-traversal equality across them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_DIST = np.float32(1e30)
LEAF_SIZE = 3  # blas.rs:106 — subdivide stops at count <= 3
NUM_BINS = 8
MAX_DEPTH = 64

NODE_DTYPE = np.dtype(
    [
        ("min", np.float32, 3),
        ("left_first", np.uint32),
        ("max", np.float32, 3),
        ("count", np.uint32),
    ]
)

TLAS_DTYPE = np.dtype(
    [
        ("min", np.float32, 3),
        ("left_right", np.uint32),
        ("max", np.float32, 3),
        ("instance_idx", np.uint32),
    ]
)


def _surface_area(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    d = mx - mn
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def single_leaf_nodes(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Trivial one-leaf BVH (used when BVH building is disabled)."""
    tris = vertices[indices.reshape(-1, 3)]
    nodes = np.zeros(1, NODE_DTYPE)
    nodes["min"][0] = tris.reshape(-1, 3).min(axis=0) if tris.size else 0
    nodes["max"][0] = tris.reshape(-1, 3).max(axis=0) if tris.size else 0
    nodes["left_first"][0] = 0
    nodes["count"][0] = indices.size // 3
    return nodes


def build_blas(
    vertices: np.ndarray, indices: np.ndarray, native: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a binned-SAH BVH.

    Returns (nodes, permuted_indices): ``nodes`` is a structured NODE_DTYPE
    array; ``permuted_indices`` is the flat (3*T,) index buffer reordered so
    each leaf's triangles are contiguous (matching MeshPool.add semantics,
    pools/src/mesh/mod.rs:320-330).

    Uses the C++ builder (voidin_tpu_torch/native) when available; the
    numpy level-synchronous implementation below is the oracle and
    fallback.
    """
    if native:
        from .. import native as native_mod

        out = native_mod.build_blas_native(vertices, indices)
        if out is not None:
            return out
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(indices, np.int64).reshape(-1, 3)
    T = len(tri_idx)
    if T == 0:
        return single_leaf_nodes(vertices, indices)[:1], np.asarray(indices, np.int32)

    tri_verts = vertices[tri_idx]  # (T, 3, 3)
    tri_min_all = tri_verts.min(axis=1)
    tri_max_all = tri_verts.max(axis=1)
    centroids_all = tri_verts.mean(axis=1)

    # `order` is the global triangle permutation; node segments are
    # contiguous ranges of it throughout the build.
    order = np.arange(T, dtype=np.int64)

    max_nodes = 2 * T + 2
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    node_left_first = np.zeros(max_nodes, np.uint32)
    node_count = np.zeros(max_nodes, np.uint32)

    root_min = tri_min_all.min(axis=0)
    root_max = tri_max_all.max(axis=0)
    node_min[0], node_max[0] = root_min, root_max
    node_count[0] = T

    # Active frontier: per-node (node_id, start) with count in node_count.
    frontier_ids = np.array([0], np.int64)
    frontier_start = np.array([0], np.int64)
    nodes_used = 2  # slot 1 is left empty, as in the reference (blas.rs:90)

    for _depth in range(MAX_DEPTH):
        counts = node_count[frontier_ids].astype(np.int64)
        splittable = counts > LEAF_SIZE
        if _depth == MAX_DEPTH - 1:
            splittable[:] = False
        # Finalize leaves: left_first = segment start.
        leaf_mask = ~splittable
        node_left_first[frontier_ids[leaf_mask]] = frontier_start[leaf_mask].astype(
            np.uint32
        )
        if not splittable.any():
            break

        ids = frontier_ids[splittable]
        starts = frontier_start[splittable]
        counts = counts[splittable]
        A = len(ids)

        # Flattened per-triangle view of all active segments.
        seg_id = np.repeat(np.arange(A), counts)  # (S,) which active node
        tri_order = np.concatenate(
            [order[s : s + c] for s, c in zip(starts, counts)]
        )  # (S,) triangle ids, grouped by segment
        cent = centroids_all[tri_order]  # (S, 3)
        tmin = tri_min_all[tri_order]
        tmax = tri_max_all[tri_order]

        # Per-node centroid bounds.
        cmin = np.full((A, 3), np.inf, np.float32)
        cmax = np.full((A, 3), -np.inf, np.float32)
        np.minimum.at(cmin, seg_id, cent)
        np.maximum.at(cmax, seg_id, cent)
        extent = cmax - cmin

        # Bin triangles along all 3 axes at once.
        safe_extent = np.where(extent > 0, extent, 1.0)
        rel = (cent - cmin[seg_id]) / safe_extent[seg_id]
        bins = np.clip((rel * NUM_BINS).astype(np.int64), 0, NUM_BINS - 1)  # (S,3)

        # Per (node, axis, bin): count + merged full-triangle AABB.
        flat = (seg_id[:, None] * 3 + np.arange(3)[None, :]) * NUM_BINS + bins  # (S,3)
        nbuckets = A * 3 * NUM_BINS
        bcount = np.zeros(nbuckets, np.int64)
        np.add.at(bcount, flat.reshape(-1), 1)
        bmin = np.full((nbuckets, 3), np.inf, np.float32)
        bmax = np.full((nbuckets, 3), -np.inf, np.float32)
        for ax in range(3):
            np.minimum.at(bmin, flat[:, ax], tmin)
            np.maximum.at(bmax, flat[:, ax], tmax)
        bcount = bcount.reshape(A, 3, NUM_BINS)
        bmin = bmin.reshape(A, 3, NUM_BINS, 3)
        bmax = bmax.reshape(A, 3, NUM_BINS, 3)

        # Prefix (left) and suffix (right) merges over bins.
        lcount = np.cumsum(bcount, axis=2)
        rcount = np.cumsum(bcount[:, :, ::-1], axis=2)[:, :, ::-1]
        lmin = np.minimum.accumulate(bmin, axis=2)
        lmax = np.maximum.accumulate(bmax, axis=2)
        rmin = np.minimum.accumulate(bmin[:, :, ::-1], axis=2)[:, :, ::-1]
        rmax = np.maximum.accumulate(bmax[:, :, ::-1], axis=2)[:, :, ::-1]

        # Split after bin b (b in 0..NUM_BINS-1): left = bins[..b], right = bins[b+1..].
        lc = lcount[:, :, :-1].astype(np.float32)
        rc = rcount[:, :, 1:].astype(np.float32)
        la = _surface_area(lmin[:, :, :-1], lmax[:, :, :-1])
        ra = _surface_area(rmin[:, :, 1:], rmax[:, :, 1:])
        with np.errstate(invalid="ignore"):
            cost = np.where(
                (lc > 0) & (rc > 0), la * lc + ra * rc, np.float32(np.inf)
            )  # (A, 3, NUM_BINS-1)

        cost_flat = cost.reshape(A, -1)
        best = np.argmin(cost_flat, axis=1)
        best_axis = best // (NUM_BINS - 1)
        best_bin = best % (NUM_BINS - 1)
        has_split = np.isfinite(cost_flat[np.arange(A), best])

        # Side per triangle: SAH bin threshold, or median fallback when the
        # node has no valid SAH split (e.g. all centroids coincide).
        tri_bin = bins[np.arange(len(seg_id)), best_axis[seg_id]]
        side = (tri_bin > best_bin[seg_id]).astype(np.int8)  # 0 = left, 1 = right

        if not has_split.all():
            # Median-by-position fallback: first half left, second half right.
            seg_pos = np.arange(len(seg_id)) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
            )
            fallback = seg_pos >= (counts[seg_id] // 2)
            bad = ~has_split[seg_id]
            side = np.where(bad, fallback.astype(np.int8), side)

        # Stable partition of each segment by side.
        new_order_flat = tri_order[np.lexsort((side, seg_id))]
        left_counts = np.bincount(seg_id[side == 0], minlength=A).astype(np.int64)

        # Write partitioned order back into the global permutation.
        seg_starts_flat = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for i in range(A):
            s, c = starts[i], counts[i]
            order[s : s + c] = new_order_flat[seg_starts_flat[i] : seg_starts_flat[i] + c]

        # Allocate children (adjacent pairs), compute their bounds.
        child_base = nodes_used + 2 * np.arange(A)
        nodes_used += 2 * A
        node_left_first[ids] = child_base.astype(np.uint32)
        node_count[ids] = 0  # internal

        lstart = starts
        rstart = starts + left_counts
        rcounts = counts - left_counts

        # Child AABBs from their triangle sets (full-triangle bounds).
        child_tris = np.concatenate(
            [order[s : s + c] for s, c in zip(lstart, left_counts)]
            + [order[s : s + c] for s, c in zip(rstart, rcounts)]
        )
        child_seg = np.concatenate(
            [
                np.repeat(2 * np.arange(A), left_counts),
                np.repeat(2 * np.arange(A) + 1, rcounts),
            ]
        )
        cbmin = np.full((2 * A, 3), np.inf, np.float32)
        cbmax = np.full((2 * A, 3), -np.inf, np.float32)
        np.minimum.at(cbmin, child_seg, tri_min_all[child_tris])
        np.maximum.at(cbmax, child_seg, tri_max_all[child_tris])

        left_ids = child_base
        right_ids = child_base + 1
        node_min[left_ids] = cbmin[0::2]
        node_max[left_ids] = cbmax[0::2]
        node_count[left_ids] = left_counts.astype(np.uint32)
        node_min[right_ids] = cbmin[1::2]
        node_max[right_ids] = cbmax[1::2]
        node_count[right_ids] = rcounts.astype(np.uint32)

        frontier_ids = np.concatenate([left_ids, right_ids])
        frontier_start = np.concatenate([lstart, rstart])

    nodes = np.zeros(nodes_used, NODE_DTYPE)
    nodes["min"] = node_min[:nodes_used]
    nodes["max"] = node_max[:nodes_used]
    nodes["left_first"] = node_left_first[:nodes_used]
    nodes["count"] = node_count[:nodes_used]

    permuted = tri_idx[order].reshape(-1).astype(np.int32)
    return nodes, permuted


def instance_world_aabbs(
    mesh_min: np.ndarray,
    mesh_max: np.ndarray,
    transforms: np.ndarray,
    mesh_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """World AABB per instance: transform the 8 AABB corners (tlas.rs:34-54)."""
    mn = mesh_min[mesh_ids]  # (N, 3)
    mx = mesh_max[mesh_ids]
    corners = np.stack(
        [
            np.where(np.array([i & 1, i & 2, i & 4], bool), mx, mn)
            for i in range(8)
        ],
        axis=1,
    )  # (N, 8, 3)
    world = (
        np.einsum("nij,nkj->nki", transforms[:, :3, :3], corners)
        + transforms[:, None, :3, 3]
    )
    return world.min(axis=1).astype(np.float32), world.max(axis=1).astype(np.float32)


def build_tlas(
    inst_min: np.ndarray, inst_max: np.ndarray, native: bool = True
) -> np.ndarray:
    """Top-down SAH TLAS over instance world AABBs (reference node layout).

    Child indices are packed 16+16 into `left_right`, so at most 65535 nodes
    (~32k instances) — the same limit the reference format implies.
    """
    if native and len(inst_min) > 0:
        from .. import native as native_mod

        out = native_mod.build_tlas_native(inst_min, inst_max)
        if out is not None:
            return out
    N = len(inst_min)
    if N == 0:
        return np.zeros(1, TLAS_DTYPE)
    cent = (inst_min + inst_max) * 0.5

    nodes = np.zeros(2 * N, TLAS_DTYPE)
    nodes_used = 1

    # Work stack of (node_idx, member_index_array).
    stack = [(0, np.arange(N, dtype=np.int64))]
    while stack:
        node_idx, members = stack.pop()
        mn = inst_min[members].min(axis=0)
        mx = inst_max[members].max(axis=0)
        nodes["min"][node_idx] = mn
        nodes["max"][node_idx] = mx
        if len(members) == 1:
            nodes["left_right"][node_idx] = 0
            nodes["instance_idx"][node_idx] = members[0]
            continue

        c = cent[members]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 0:
            half = len(members) // 2
            left_m, right_m = members[:half], members[half:]
        else:
            rel = (c[:, axis] - cmin[axis]) / extent[axis]
            bins = np.clip((rel * NUM_BINS).astype(np.int64), 0, NUM_BINS - 1)
            best_cost, best_b = np.inf, -1
            for b in range(NUM_BINS - 1):
                lm = bins <= b
                nl = int(lm.sum())
                if nl == 0 or nl == len(members):
                    continue
                la = _surface_area(
                    inst_min[members[lm]].min(axis=0), inst_max[members[lm]].max(axis=0)
                )
                ra = _surface_area(
                    inst_min[members[~lm]].min(axis=0),
                    inst_max[members[~lm]].max(axis=0),
                )
                cost = la * nl + ra * (len(members) - nl)
                if cost < best_cost:
                    best_cost, best_b = cost, b
            if best_b < 0:
                half = len(members) // 2
                left_m, right_m = members[:half], members[half:]
            else:
                lm = bins <= best_b
                left_m, right_m = members[lm], members[~lm]

        li, ri = nodes_used, nodes_used + 1
        nodes_used += 2
        if ri > 0xFFFF:
            raise ValueError("TLAS node index exceeds 16-bit packing limit")
        nodes["left_right"][node_idx] = np.uint32(li) | (np.uint32(ri) << 16)
        nodes["instance_idx"][node_idx] = 0xFFFFFFFF
        stack.append((li, left_m))
        stack.append((ri, right_m))

    return nodes[:nodes_used]


# ---------------------------------------------------------------------------
# Numpy oracles (test reference; mirrors shaders/utils/intersections.wgsl and
# shaders/utils/bvh.wgsl semantics)
# ---------------------------------------------------------------------------


def intersect_aabb(origin, inv_dir, bmin, bmax, t):
    """Slab test; returns entry distance or MAX_DIST (intersections.wgsl:13-24)."""
    tx1 = (bmin - origin) * inv_dir
    tx2 = (bmax - origin) * inv_dir
    hi = np.maximum(tx1, tx2).min(axis=-1)
    lo = np.minimum(tx1, tx2).max(axis=-1)
    hit = (hi >= lo) & (lo < t) & (hi > 0.0)
    return np.where(hit, lo, MAX_DIST)


def intersect_triangle(origin, direction, v0, v1, v2, t_hit):
    """Backface-culled Moller-Trumbore (intersections.wgsl:26-45).

    Returns hit distance or MAX_DIST. `t_hit` is the current closest.
    """
    e1, e2 = v1 - v0, v2 - v0
    uvec = np.cross(direction, e2)
    det = np.dot(e1, uvec)
    if det < 1e-10:
        return MAX_DIST
    inv_det = 1.0 / det
    orig = origin - v0
    u = inv_det * np.dot(orig, uvec)
    if u < 0.0 or u > 1.0:
        return MAX_DIST
    vvec = np.cross(orig, e1)
    v = inv_det * np.dot(direction, vvec)
    if v < 0.0 or u + v > 1.0:
        return MAX_DIST
    t = inv_det * np.dot(e2, vvec)
    if 0.0 < t < t_hit:
        return t
    return MAX_DIST


def traverse_blas_oracle(
    nodes: np.ndarray,
    vertices: np.ndarray,
    indices: np.ndarray,
    origin: np.ndarray,
    direction: np.ndarray,
    t_max: float = float(MAX_DIST),
    root: int = 0,
) -> float:
    """Closest-hit distance through one BLAS (stack traversal oracle)."""
    inv_dir = 1.0 / direction
    tri = indices.reshape(-1, 3)
    stack = [root]
    t_hit = t_max
    while stack:
        ni = stack.pop()
        node = nodes[ni]
        if (
            intersect_aabb(origin, inv_dir, node["min"], node["max"], t_hit)
            >= MAX_DIST
        ):
            continue
        if node["count"] > 0:
            for i in range(node["count"]):
                idx = tri[int(node["left_first"]) + i]
                t = intersect_triangle(
                    origin,
                    direction,
                    vertices[idx[0]],
                    vertices[idx[1]],
                    vertices[idx[2]],
                    t_hit,
                )
                t_hit = min(t_hit, float(t))
        else:
            stack.append(int(node["left_first"]))
            stack.append(int(node["left_first"]) + 1)
    return t_hit


def brute_force_closest(vertices, indices, origin, direction, t_max=float(MAX_DIST)):
    """O(T) closest hit, for validating BVH traversal."""
    t_hit = t_max
    for idx in indices.reshape(-1, 3):
        t = intersect_triangle(
            origin, direction, vertices[idx[0]], vertices[idx[1]], vertices[idx[2]], t_hit
        )
        t_hit = min(t_hit, float(t))
    return t_hit


# ---------------------------------------------------------------------------
# Exit links (host): stackless "threaded" traversal order over FIXED
# topology. exit(node) = where traversal resumes once this node (and, for
# internal nodes on a miss, its whole subtree) is finished: the right
# sibling if the node is a left child, else the parent's exit. With
# hit->first-child / miss->exit the traversal needs NO stack — each step
# of the device walk is one node fetch + one slab test
# (csrc/shadow_trace.cu). Links are topology-only: AABB refits
# (skinning) never invalidate them.
# ---------------------------------------------------------------------------


def exit_links(left: np.ndarray, right: np.ndarray,
               is_leaf: np.ndarray) -> np.ndarray:
    """Generic DFS exit links for a binary tree rooted at 0.

    Returns (B,) int32, ENCODED as exit+1 with 0 = "done" (root's exit and
    every node on the root's rightmost spine). Unreachable slots (the
    reference BLAS layout leaves slot 1 empty, blas.rs:90) stay 0."""
    B = len(is_leaf)
    out = np.zeros(B, np.int32)
    if B == 0:
        return out
    stack = [(0, 0)]  # (node, encoded exit)
    while stack:
        n, e = stack.pop()
        out[n] = e
        if not is_leaf[n]:
            l, r = int(left[n]), int(right[n])
            stack.append((r, e))
            stack.append((l, r + 1))
    return out


def blas_exit_links(nodes: np.ndarray) -> np.ndarray:
    """Exit links for one NODE_DTYPE BLAS (mesh-LOCAL encoding)."""
    left = nodes["left_first"].astype(np.int64)
    return exit_links(left, left + 1, nodes["count"] > 0)


def tlas_exit_links(nodes: np.ndarray) -> np.ndarray:
    """Exit links for a TLAS_DTYPE array (global encoding)."""
    lr = nodes["left_right"].astype(np.int64)
    return exit_links(lr & 0xFFFF, lr >> 16, lr == 0)


# ---------------------------------------------------------------------------
# Refit plans (host): level-ordered index arrays for a bottom-up AABB refit
# over FIXED topology on the device. Skinned geometry moves every frame; a
# refit is per-level gathers + one scatter, with no rebuild (beyond
# reference parity: the wgpu renderer has no skinning and never refits).
# TlasData carries the TLAS plan for the skinning slice.
# ---------------------------------------------------------------------------


def blas_refit_plan(nodes: np.ndarray) -> dict:
    """Level-ordered refit arrays for one NODE_DTYPE BLAS (deepest first).

    Returns dict(order (B,) local node ids, leaf_tri (B, C) local triangle
    ids (-1 pad; internal rows all -1), child (B,) local left-child id
    (-1 for leaves), levels: tuple of (start, end) slices into order)."""
    B = len(nodes)
    count = nodes["count"].astype(np.int64)
    left = nodes["left_first"].astype(np.int64)
    depth = np.zeros(B, np.int64)
    reachable = np.zeros(B, bool)
    reachable[0] = True
    # BFS from root 0; children of internal node n are (left, left+1).
    # Slot 1 is deliberately empty in the reference layout (blas.rs:90) and
    # other slots can be unused — only REACHABLE nodes enter the plan.
    frontier = [0]
    while frontier:
        nxt = []
        for n in frontier:
            if count[n] == 0:
                for c in (left[n], left[n] + 1):
                    depth[c] = depth[n] + 1
                    reachable[c] = True
                    nxt.append(int(c))
        frontier = nxt
    ids = np.nonzero(reachable)[0]
    order = ids[np.argsort(-depth[ids], kind="stable")].astype(np.int32)
    R = len(order)
    cmax = max(int(count[reachable].max()), 1)
    leaf_tri = np.full((R, cmax), -1, np.int32)
    child = np.full(R, -1, np.int32)
    for row, n in enumerate(order):
        if count[n] > 0:
            leaf_tri[row, : count[n]] = left[n] + np.arange(count[n])
        else:
            child[row] = left[n]
    levels = []
    d_sorted = depth[order]
    start = 0
    for i in range(1, R + 1):
        if i == R or d_sorted[i] != d_sorted[start]:
            levels.append((start, i))
            start = i
    return dict(order=order, leaf_tri=leaf_tri, child=child,
                levels=tuple(levels))


def tlas_refit_plan(nodes: np.ndarray) -> dict:
    """Level-ordered refit arrays for a TLAS_DTYPE array (deepest first).

    Returns dict(order (B,) node ids, child (B, 2) (-1 for leaves),
    instance (B,) instance id (-1 for internal), levels tuple)."""
    B = len(nodes)
    lr = nodes["left_right"].astype(np.int64)
    inst = nodes["instance_idx"].astype(np.int64)
    depth = np.zeros(B, np.int64)
    frontier = [0]
    while frontier:
        nxt = []
        for n in frontier:
            if lr[n] != 0:
                for c in (lr[n] & 0xFFFF, lr[n] >> 16):
                    depth[c] = depth[n] + 1
                    nxt.append(int(c))
        frontier = nxt
    order = np.argsort(-depth, kind="stable").astype(np.int32)
    child = np.full((B, 2), -1, np.int32)
    instance = np.full(B, -1, np.int32)
    for row, n in enumerate(order):
        if lr[n] == 0:
            instance[row] = inst[n]
        else:
            child[row] = (lr[n] & 0xFFFF, lr[n] >> 16)
    levels = []
    d_sorted = depth[order]
    start = 0
    for i in range(1, B + 1):
        if i == B or d_sorted[i] != d_sorted[start]:
            levels.append((start, i))
            start = i
    return dict(order=order, child=child, instance=instance,
                levels=tuple(levels))
