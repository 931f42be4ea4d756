"""The set-up of the skin kernels (voidin_tpu_torch/ops/skin.py skin_batch
and tlas_bounds) on the CPU, where the kernels cannot run: the tables a
frame's three launches read, held against the per-skin SkinData and the
chain (scene/skin.py) they replace.

The scene is the benchmark's walking crowd (portbench's rtshadows_crowd
recipe: 32 skins of 11,536 triangles and 55 joints, 19-level BLAS; the
frame size, 160x90 or 1080p, changes nothing the set-up reads), posed at
frames 0, 17 and 45 of its walk, and the 2-joint strip of
tests/test_torch_skin.py. A model of each kernel's addressing, fed the
set-up tables alone, gives the chain's words: the rows, joint rows and
meshes of the pose (each skin rebuilt from the batch's tables with its
joint indices rebased to the global rows), the BLAS refit's steps (level
k of every skin's plan at step k, each plan read by pointer) and the TLAS
refit's levels. Also: what set-up refuses, that the kernels refuse CPU
tensors, that a CPU scene carries no set-up (scene_from_numpy sets it up
on a CUDA device alone), the counters of the CPU route (skin.kernel_tris 0,
skin.eager_tris every posed triangle), and the chain's min and max
against JAX's on -0.0 / +0.0 ties, with a pose whose boxes tie them.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.scene import skin as j_skin

from voidin_tpu_torch.framework import profiler
from voidin_tpu_torch.ops import skin as ops
from voidin_tpu_torch.scene import skin as t_skin

from tests.test_torch_scene import port_scene
from tests.test_torch_skin import _skinned_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "portbench") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "portbench"))

from pb import animation, configs  # noqa: E402
from pb import scene as pb_scene  # noqa: E402

torch.set_num_threads(2)
SEED = 2 ** 31 + 1234567
FRAMES = (0, 17, 45)
N_CROWD_TRIS = 32 * 11_536


@pytest.fixture(scope="module")
def crowd():
    """(the crowd's scene on the CPU with its TLAS, the recipe's scene)."""
    scene = configs.build_scene(configs.load("rtshadows_crowd"), SEED)
    return pb_scene.to_world(scene).device("cpu", with_tlas=True), scene


@pytest.fixture(scope="module")
def batch(crowd):
    return ops.skin_batch(crowd[0].skins)


def _joints(scene, frame):
    return torch.from_numpy(animation.joint_matrices(scene, frame, 1 / 60))


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_batch_blocks_rows_and_joints_follow_each_skin(crowd, batch):
    data, _ = crowd
    skins = data.skins
    assert (batch.n_skins, batch.n_tri) == (32, N_CROWD_TRIS)
    assert batch.joint_rows == 1760 == skins[-1].joint_offset + 55
    info = batch.skin_info.tolist()
    block_skin = batch.block_skin.tolist()
    first = 0
    for s_i, (s, row) in enumerate(zip(skins, info)):
        n = s.rest_pos.shape[0]
        n_blocks = -(-n // ops.TRIS_PER_BLOCK)
        assert row == [n, s.base_tri, s.joint_offset, s.n_joints, s.mesh_id,
                       first, n_blocks, 0]
        assert block_skin[first:first + n_blocks] == [s_i] * n_blocks
        first += n_blocks
        # the tables the kernel reads are the skin's own, by pointer
        for f, ((name, _), t) in enumerate(
                zip(ops.TABLES, batch.keep[7 * s_i:7 * s_i + 7])):
            assert t.data_ptr() == getattr(s, name).data_ptr()
            assert batch.tables[s_i, f].item() == t.data_ptr()
    assert first == len(block_skin) == batch.partials.shape[0]
    # destination rows: each skin's run of the pool, disjoint, in bounds
    rows = sorted((r[1], r[1] + r[0]) for r in info)
    assert all(a[1] <= b[0] for a, b in zip(rows, rows[1:]))
    assert batch.row_end == rows[-1][1] <= data.meshes.tri_pos.shape[0]
    assert batch.mesh_end == max(s.mesh_id for s in skins) + 1
    assert not batch.skin_done.any()


def _rebuilt_skins(batch):
    """Each skin rebuilt from the batch's tables alone, its joint indices
    rebased to the rows of the whole joint array (joint_offset 0), as the
    pose kernel addresses them."""
    out = []
    for s_i, (n, base, joff, nj, mid, _, _, _) in enumerate(
            batch.skin_info.tolist()):
        t = dict(zip([k for k, _ in ops.TABLES],
                     batch.keep[7 * s_i:7 * s_i + 7]))
        t["joints"] = t["joints"] + joff
        assert t["rest_pos"].shape[0] == n
        out.append(t_skin.SkinData(**t, base_tri=base, mesh_id=mid,
                                   joint_offset=0,
                                   n_joints=batch.joint_rows))
    return out


@pytest.mark.parametrize("frame", FRAMES)
def test_batch_tables_pose_the_chains_rows(crowd, batch, frame):
    data, scene = crowd
    jm = _joints(scene, frame)
    want = t_skin.apply_skins(data.meshes, data.skins, jm)
    got = t_skin.apply_skins_reference(data.meshes, _rebuilt_skins(batch),
                                       jm)
    for k in ("tri_pos", "tri_attr_packed", "mesh_min", "mesh_max"):
        assert torch.equal(_bits(getattr(got, k)), _bits(getattr(want, k))), k
    moved = (want.tri_pos - data.meshes.tri_pos).abs().amax(dim=1)
    assert int((moved > 0).sum()) > 0


def _plan_skins(batch, skins):
    """The skin of each of the batch's plans, found by its pointers."""
    ptr = {s.refit_order.data_ptr(): s for s in skins
           if s.refit_order is not None}
    return [ptr[p] for p in batch.plans[:, 0].tolist()]


def _blas_model(batch, skins, meshes, tri_pos):
    """blas_refit_kernel's steps evaluated from the batch's tables: at step
    k every plan's rows [first, first + count), each a leaf's union of its
    triangles' posed corners or an internal node's union of its children
    left and left + 1, read from the boxes the earlier steps left."""
    bmin, bmax = meshes.bvh_min.clone(), meshes.bvh_max.clone()
    plans = _plan_skins(batch, skins)
    info = batch.plan_info.tolist()
    first, prefix = batch.step_first.tolist(), batch.step_prefix.tolist()
    corners = tri_pos.reshape(-1, 3, 3)
    inf = torch.tensor(float("inf"))
    for k in range(len(first)):
        writes = []
        for r, s in enumerate(plans):
            base, base_tri, cols, _ = info[r]
            rows = slice(first[k][r],
                         first[k][r] + prefix[k][r + 1] - prefix[k][r])
            node = base + s.refit_order[rows].long()
            child = s.refit_child[rows].long()
            lt = s.refit_leaf_tri[rows].long()
            assert lt.shape[1] == cols
            valid = (lt >= 0)[..., None, None]
            c = corners[(base_tri + lt.clamp(min=0))]
            lo = t_skin._amin(torch.where(valid, c, inf).reshape(
                len(lt), -1, 3), 1)
            hi = t_skin._amax(torch.where(valid, c, -inf).reshape(
                len(lt), -1, 3), 1)
            c0 = base + child.clamp(min=0)
            c1 = (c0 + 1).clamp(max=bmin.shape[0] - 1)
            leaf = (child < 0)[:, None]
            writes.append((node,
                           torch.where(leaf, lo, t_skin._minimum(bmin[c0],
                                                                 bmin[c1])),
                           torch.where(leaf, hi, t_skin._maximum(bmax[c0],
                                                                 bmax[c1]))))
        for node, lo, hi in writes:
            bmin[node], bmax[node] = lo, hi
    return bmin, bmax


@pytest.mark.parametrize("frame", FRAMES)
def test_merged_blas_tables_refit_the_chains_nodes(crowd, batch, frame):
    data, scene = crowd
    want = t_skin.apply_skins(data.meshes, data.skins, _joints(scene, frame))
    bmin, bmax = _blas_model(batch, data.skins, data.meshes, want.tri_pos)
    assert torch.equal(_bits(bmin), _bits(want.bvh_min))
    assert torch.equal(_bits(bmax), _bits(want.bvh_max))


def test_merged_blas_tables_hold_each_plan(crowd, batch):
    """Each skin's own refit plan by pointer, no copy; step k holds level
    k of every plan (deepest first), the rows of a step counted in order;
    the node range the refit writes ends where the pool's skinned BLAS
    end."""
    skins = crowd[0].skins
    plans = _plan_skins(batch, skins)
    assert plans == list(skins)
    for r, s in enumerate(plans):
        assert batch.plans[r].tolist() == [getattr(s, k).data_ptr()
                                           for k in ops.PLAN]
        assert batch.plan_info[r].tolist() == [
            s.bvh_base, s.base_tri, s.refit_leaf_tri.shape[1], 0]
    first, prefix = batch.step_first.tolist(), batch.step_prefix.tolist()
    assert len(first) == max(len(s.refit_levels) for s in skins) == 19
    for r, s in enumerate(plans):
        got = [(first[k][r], first[k][r] + prefix[k][r + 1] - prefix[k][r])
               for k in range(len(first))]
        want = list(s.refit_levels) + [(0, 0)] * (len(first)
                                                   - len(s.refit_levels))
        assert got == want
    assert [p[0] for p in prefix] == [0] * len(prefix)
    assert batch.step_rows == max(p[-1] for p in prefix)
    assert batch.refit_nodes == sum(p[-1] for p in prefix) == sum(
        s.refit_order.shape[0] for s in skins)
    assert batch.node_end == max(s.bvh_base + int(s.refit_order.max()) + 1
                                 for s in skins)
    assert batch.node_end <= crowd[0].meshes.bvh_min.shape[0]


def _tlas_model(bounds, tlas, meshes, instances):
    """tlas_refit_kernel's levels from the plan's bounds: each level's
    rows a leaf's instance box or the union of the node's two children."""
    bounds = bounds.tolist()
    mesh_id = instances.mesh_id.long()
    mn, mx = meshes.mesh_min[mesh_id], meshes.mesh_max[mesh_id]
    pick = torch.tensor([[i & 1, i & 2, i & 4] for i in range(8)],
                        dtype=torch.bool)
    t = instances.transform
    world = t_skin._rotate(t[:, None, :3, :3], torch.where(
        pick, mx[:, None], mn[:, None])) + t[:, None, :3, 3]
    imin, imax = t_skin._amin(world, 1), t_skin._amax(world, 1)
    bmin, bmax = tlas.tlas_min.clone(), tlas.tlas_max.clone()
    for a, b in zip(bounds, bounds[1:]):
        node = tlas.refit_order[a:b].long()
        c = tlas.refit_child[a:b].long().clamp(min=0)
        inst = tlas.refit_instance[a:b].long().clamp(min=0)
        leaf = (tlas.refit_child[a:b, :1] < 0)
        lo = torch.where(leaf, imin[inst], t_skin._minimum(bmin[c[:, 0]],
                                                           bmin[c[:, 1]]))
        hi = torch.where(leaf, imax[inst], t_skin._maximum(bmax[c[:, 0]],
                                                           bmax[c[:, 1]]))
        bmin[node], bmax[node] = lo, hi
    return bmin, bmax


@pytest.mark.parametrize("frame", FRAMES)
def test_tlas_plan_refits_the_chains_nodes(crowd, frame):
    data, scene = crowd
    posed = t_skin.apply_skins(data.meshes, data.skins, _joints(scene, frame))
    levels = data.tlas.refit_levels
    bounds = ops.tlas_bounds(levels, data.tlas.refit_order.shape[0], "cpu")
    assert bounds.dtype == torch.int32
    assert bounds.tolist() == [a for a, _ in levels] + [levels[-1][1]]
    with pytest.raises(ValueError, match="levels"):
        ops.tlas_bounds(levels[1:], data.tlas.refit_order.shape[0], "cpu")
    want = t_skin.refit_tlas(data.tlas, posed, data.instances)
    bmin, bmax = _tlas_model(bounds, data.tlas, posed, data.instances)
    assert torch.equal(_bits(bmin), _bits(want.tlas_min))
    assert torch.equal(_bits(bmax), _bits(want.tlas_max))


def test_cpu_route_counts_eager_triangles(crowd):
    """The CPU route poses every skin in the chain: skin.eager_tris counts
    all 369,152 triangles and skin.kernel_tris none."""
    data, scene = crowd
    profiler.disable()
    profiler.collect()
    profiler.enable()
    try:
        with profiler.scope("update.skin"):
            t_skin.apply_skins(data.meshes, data.skins, _joints(scene, 0))
    finally:
        profiler.disable()
    counters = {}
    for d in profiler.collect():
        for k, v in d["counters"].items():
            counters[k] = counters.get(k, 0) + v
    assert counters["skin.tris"] == N_CROWD_TRIS
    assert counters["skin.eager_tris"] == N_CROWD_TRIS
    assert counters.get("skin.kernel_tris", 0) == 0
    assert counters["skin.joints"] == 1760


def test_kernels_refuse_cpu_tensors(crowd, batch):
    data, scene = crowd
    m = data.meshes
    with pytest.raises(ValueError, match="CUDA"):
        ops.pose_skins(batch, _joints(scene, 0), m.tri_pos.clone(),
                       m.tri_attr_packed.clone(), m.mesh_min.clone(),
                       m.mesh_max.clone())
    with pytest.raises(ValueError, match="CUDA"):
        ops.refit_blas(batch, m.tri_pos, m.bvh_min.clone(), m.bvh_max.clone())
    with pytest.raises(ValueError, match="CUDA"):
        ops.refit_tlas(data.tlas, m.mesh_min, m.mesh_max,
                       data.instances.mesh_id, data.instances.transform,
                       data.tlas.tlas_min.clone(), data.tlas.tlas_max.clone())


def _leaf_outside(s):
    leaf_tri = s.refit_leaf_tri.clone()
    leaf_tri[int(torch.nonzero(leaf_tri[:, 0] >= 0)[0, 0]), 0] = \
        s.rest_pos.shape[0]
    return dataclasses.replace(s, refit_leaf_tri=leaf_tri)


REFUSED = {
    "overlapping rows": (lambda a, b: (a, dataclasses.replace(
        b, base_tri=a.base_tri + 1)), "overlapping pool rows"),
    "overlapping nodes": (lambda a, b: (a, dataclasses.replace(
        b, bvh_base=a.bvh_base + 3)), "overlapping BLAS nodes"),
    "one mesh twice": (lambda a, b: (a, dataclasses.replace(
        b, mesh_id=a.mesh_id)), "one mesh"),
    "joint outside the skeleton": (lambda a, b: (a, dataclasses.replace(
        b, n_joints=40)), "joint indices"),
    "levels short of the plan": (lambda a, b: (a, dataclasses.replace(
        b, refit_levels=b.refit_levels[:-1])), "levels"),
    "a leaf outside the skin": (lambda a, b: (a, _leaf_outside(b)),
                                "refit plan outside"),
    "a skeleton over the shared memory": (lambda a, b: (a, dataclasses.replace(
        b, n_joints=ops.MAX_JOINTS + 1)), "the pose kernel takes"),
    "no joints": (lambda a, b: (a, dataclasses.replace(b, n_joints=0)),
                  "the pose kernel takes"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_set_up_refuses_what_the_kernels_cannot_pose(crowd, case):
    skins = crowd[0].skins
    make, match = REFUSED[case]
    a, b = skins[0], skins[1]
    with pytest.raises(ValueError, match=match):
        ops.skin_batch(make(a, b))


def test_skins_without_a_plan_pose_but_are_not_refit(crowd):
    data, scene = crowd
    skins = [s if i % 2 else dataclasses.replace(s, refit_order=None,
                                                 refit_leaf_tri=None,
                                                 refit_child=None,
                                                 refit_levels=())
             for i, s in enumerate(data.skins)]
    b = ops.skin_batch(tuple(skins))
    assert b.n_tri == N_CROWD_TRIS
    assert b.refit_nodes == sum(s.refit_order.shape[0]
                                for s in skins if s.refit_order is not None)
    assert _plan_skins(b, skins) == [s for s in skins
                                     if s.refit_order is not None]
    jm = _joints(scene, 17)
    want = t_skin.apply_skins(data.meshes, tuple(skins), jm)
    bmin, bmax = _blas_model(b, skins, data.meshes, want.tri_pos)
    assert torch.equal(_bits(bmin), _bits(want.bvh_min))
    assert torch.equal(_bits(bmax), _bits(want.bvh_max))


def tie_pose(n_joints):
    """Joint matrices whose posed x is -0.0 or +0.0 by the sign of the
    rest z and x (row 0 = (-0, -0, -1, -0)), so that boxes tie -0.0 with
    +0.0; rows 1 and 2 keep normals and tangents off zero."""
    m = np.array([[-0.0, -0.0, -1.0, -0.0], [1.0, 1.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]], np.float32)
    return np.tile(m, (n_joints, 1, 1))


@pytest.mark.parametrize("seed", range(3))
def test_min_max_take_jax_signed_zeros(seed):
    """The chain's min and max (scene/skin.py _amin, _amax, _minimum,
    _maximum) equal jnp.min, jnp.max, jnp.minimum and jnp.maximum bit for
    bit on rows full of -0.0 / +0.0 ties: JAX's min takes -0.0, its max
    +0.0, in any order (torch's own depend on the order)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-0.0, 0.0, 0.0, -0.0, 1.5, -2.0], np.float32),
                   size=(64, 7))
    y = rng.permutation(x.reshape(-1)).reshape(x.shape)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in (
            (t_skin._amin(tx, 1), jnp.min(x, axis=1)),
            (t_skin._amax(tx, 1), jnp.max(x, axis=1)),
            (t_skin._amin(tx, 0), jnp.min(x, axis=0)),
            (t_skin._amax(tx, 0), jnp.max(x, axis=0)),
            (t_skin._minimum(tx, ty), jnp.minimum(x, y)),
            (t_skin._maximum(tx, ty), jnp.maximum(x, y))):
        np.testing.assert_array_equal(_bits(got).numpy(),
                                      np.asarray(want).view(np.int32))


def test_tie_pose_boxes_take_the_signed_zero_rule():
    """The strip posed by tie_pose: posed x of -0.0 and +0.0 in one mesh,
    whose box takes -0.0 as its min and +0.0 as its max; every BLAS node
    is the rule's union of its triangles; the values equal JAX's (whose
    fused dot makes every zero +0.0, so its words may differ in the
    sign of a zero alone)."""
    jw, _ = _skinned_world(vt, j_skin)
    js = jw.device(with_tlas=True)
    ps = port_scene(js)
    jm = tie_pose(2)
    jm2 = j_skin.apply_skins(js.meshes, js.skins, jm)
    pm2 = t_skin.apply_skins(ps.meshes, ps.skins, torch.from_numpy(jm))
    sk = ps.skins[0]
    x = pm2.tri_pos.reshape(-1, 3, 3)[sk.base_tri:sk.base_tri
                                      + sk.rest_pos.shape[0], :, 0]
    assert bool(((x == 0) & torch.signbit(x)).any())
    assert bool(((x == 0) & ~torch.signbit(x)).any())
    assert torch.signbit(pm2.mesh_min[sk.mesh_id, 0])
    assert not torch.signbit(pm2.mesh_max[sk.mesh_id, 0])
    b = ops.skin_batch(ps.skins)
    bmin, bmax = _blas_model(b, ps.skins, ps.meshes, pm2.tri_pos)
    assert torch.equal(_bits(bmin), _bits(pm2.bvh_min))
    assert torch.equal(_bits(bmax), _bits(pm2.bvh_max))
    for k in ("tri_pos", "mesh_min", "mesh_max", "bvh_min", "bvh_max"):
        np.testing.assert_array_equal(getattr(pm2, k).numpy(),
                                      np.asarray(getattr(jm2, k)), err_msg=k)


def test_batch_is_set_up_once_per_skins(crowd):
    """The batch is the scene's (scene_from_numpy sets it up on a CUDA
    device, the card tests check it there): a CPU scene, which runs the
    chain, carries none, and skin_batch keeps nothing between calls."""
    data, _ = crowd
    assert data.skin_batch is None
    assert data.tlas.refit_bounds is None
    a, b = ops.skin_batch(data.skins), ops.skin_batch(data.skins)
    assert a is not b
    assert a.max_joints == 55
