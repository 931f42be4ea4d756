"""Card-only checks of the skin kernels (voidin_tpu_torch/csrc/skin.cu via
ops/skin.py): scene/skin.py's CUDA route (apply_skins: the pose and BLAS
refit kernels; refit_tlas: the TLAS kernel) against the chain it replaces,
run on the same card tensors (apply_skins_reference, refit_tlas_reference),
word for word on every posed row, mesh box, BLAS node and TLAS node.

Scenes: the benchmark's walking crowd (portbench's rtshadows_crowd recipe,
32 skins) at frames 0, 17 and 45 of its walk, twice in a row (the arrival
counters reset themselves); config 4's clapping arms (no TLAS); the
skinned fixture of portbench/tests (rtshadows' knot a 2-joint skin); the
crowd with every other skin's refit plan taken away; the crowd without a
TLAS; the tie pose of tests/test_torch_skin_batch.py on the strip and
on the crowd, whose boxes choose between -0.0 and +0.0; and a skeleton of
1,100 joints, whose matrices take more than the 48 KB of shared memory a
block gets unasked. Also the launches a frame (one of each kernel), and
the set-up: scene_from_numpy sets it up once on the card, Renderer frames
read it (skinned config 5 at 160x96) and never set up again, and the CUDA
route refuses skins without it. Marked `cuda`; they skip where torch sees
no CUDA device. On the card:

    python -m pytest tests/test_torch_skin_cuda.py --noconftest -q
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework import presets
from voidin_tpu_torch.ops import skin as ops
from voidin_tpu_torch.scene import skin as t_skin
from voidin_tpu_torch.scene.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "portbench"),
           os.path.join(ROOT, "portbench", "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from pb import animation, configs  # noqa: E402
from pb import scene as pb_scene  # noqa: E402

pytestmark = pytest.mark.cuda
SEED = 2 ** 31 + 7654321
FRAMES = (0, 17, 45)
MESH_KEYS = ("tri_pos", "tri_attr_packed", "mesh_min", "mesh_max",
             "bvh_min", "bvh_max")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def crowd(cuda):
    scene = configs.build_scene(configs.load("rtshadows_crowd"), SEED)
    world = pb_scene.to_world(scene)
    return world, scene, world.device(cuda, with_tlas=True)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _hold(data, jm, skins=None, reps=1):
    """The CUDA route against the chain on `data` (a SceneData on the
    card) posed by `jm`, `reps` times: every word equal. Returns the
    kernels' meshes."""
    batch = data.skin_batch if skins is None else ops.skin_batch(skins)
    skins = data.skins if skins is None else skins
    jm = torch.as_tensor(jm).to(data.device)
    want = t_skin.apply_skins_reference(data.meshes, skins, jm)
    want_tlas = (None if data.tlas is None else
                 t_skin.refit_tlas_reference(data.tlas, want, data.instances))
    for _ in range(reps):
        before = (ops.LAUNCHES, ops.LAUNCHES_BLAS, ops.LAUNCHES_TLAS)
        got = t_skin.apply_skins(data.meshes, skins, jm, batch=batch)
        got_tlas = t_skin.refit_tlas(data.tlas, got, data.instances)
        torch.cuda.synchronize()
        refit = any(s.refit_order is not None for s in skins)
        assert (ops.LAUNCHES, ops.LAUNCHES_BLAS, ops.LAUNCHES_TLAS) == (
            before[0] + 1, before[1] + refit,
            before[2] + (data.tlas is not None))
        for k in MESH_KEYS:
            a, b = _bits(getattr(got, k)), _bits(getattr(want, k))
            assert torch.equal(a, b), f"{k}: {int((a != b).sum())} words"
        if data.tlas is None:
            assert got_tlas is None
        else:
            for k in ("tlas_min", "tlas_max"):
                assert torch.equal(_bits(getattr(got_tlas, k)),
                                   _bits(getattr(want_tlas, k))), k
    return got


@pytest.mark.parametrize("frame", FRAMES)
def test_crowd_kernels_equal_the_chain(crowd, frame):
    world, scene, data = crowd
    jm = animation.joint_matrices(scene, frame, 1 / 60)
    got = _hold(data, jm, reps=2)
    assert not torch.equal(got.tri_pos, data.meshes.tri_pos)
    assert not torch.equal(got.bvh_min, data.meshes.bvh_min)


def test_clapper_kernels_equal_the_chain(cuda):
    p = presets.PRESETS[4](16 / 9)
    data = p.world.device(cuda, with_tlas=p.with_tlas)
    assert data.skins
    for t in (0.0, 0.37, 1.3):
        _hold(data, p.animator(t))


def test_skinned_fixture_kernels_equal_the_chain(cuda):
    import skinned_fixture as fx

    cfg = fx.config()
    scene = fx.build(cfg["scene"], SEED)
    data = pb_scene.to_world(scene).device(cuda, with_tlas=True)
    for frame in (0, 5, 11):
        _hold(data, animation.joint_matrices(scene, frame, 1 / 60))


def test_skins_without_a_refit_plan(crowd):
    _, scene, data = crowd
    skins = tuple(s if i % 2 else dataclasses.replace(
        s, refit_order=None, refit_leaf_tri=None, refit_child=None,
        refit_levels=()) for i, s in enumerate(data.skins))
    _hold(data, animation.joint_matrices(scene, 17, 1 / 60), skins)
    none = tuple(dataclasses.replace(s, refit_order=None,
                                     refit_leaf_tri=None, refit_child=None,
                                     refit_levels=()) for s in data.skins[:4])
    got = _hold(data, animation.joint_matrices(scene, 17, 1 / 60), none)
    assert torch.equal(got.bvh_min, data.meshes.bvh_min)


def test_scene_without_tlas(crowd, cuda):
    world, scene, _ = crowd
    data = world.device(cuda, with_tlas=False)
    assert data.tlas is None
    _hold(data, animation.joint_matrices(scene, 45, 1 / 60))


def _strip_world():
    """tests/test_skin.py's 2-joint strip on the port's World."""
    w = pt.World()
    verts = np.array([[-0.5, y, 0.0] for y in (0.0, 1.0, 2.0)
                      for _ in (0, 1)], np.float32)
    verts[1::2, 0] = 0.5
    tris = [[0, 1, 2], [1, 3, 2], [2, 3, 4], [3, 5, 4]]
    n = np.tile(np.array([[0, 0, 1]], np.float32), (6, 1))
    t = np.tile(np.array([[1, 0, 0, 1]], np.float32), (6, 1))
    mesh = Mesh(verts, n, t, verts[:, :2].copy(),
                np.array(tris, np.int32).reshape(-1))
    joints = np.zeros((6, 4), np.int32)
    weights = np.zeros((6, 4), np.float32)
    weights[:, 0] = 1.0
    joints[2:4, 1] = 1
    weights[2:4] = [0.5, 0.5, 0, 0]
    joints[4:6, 0] = 1
    mid = w.meshes.add(mesh)
    info = w.meshes.mesh_info[mid]
    w.skins.append(t_skin.build_skin_data(
        mesh, w.meshes.indices[mid], joints, weights,
        base_tri=info["base_index"] // 3, mesh_id=mid,
        joint_offset=w.allocate_joints(2), n_joints=2,
        nodes=w.meshes.bvh_nodes[mid], bvh_base=info["bvh_index"]))
    w.instances.add(np.eye(4, dtype=np.float32), mid, 0)
    w.lights.add_point_light([0, 1, 4], 20.0, [1, 1, 1])
    return w


def tie_pose(n_joints):
    """tests/test_torch_skin_batch.py tie_pose: posed x of -0.0 or +0.0."""
    m = np.array([[-0.0, -0.0, -1.0, -0.0], [1.0, 1.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]], np.float32)
    return np.tile(m, (n_joints, 1, 1))


def test_signed_zero_ties(crowd, cuda):
    data = _strip_world().device(cuda, with_tlas=True)
    got = _hold(data, tie_pose(2))
    sk = data.skins[0]
    x = got.tri_pos.reshape(-1, 3, 3)[sk.base_tri:sk.base_tri + 4, :, 0]
    assert bool(((x == 0) & torch.signbit(x)).any())
    assert bool(((x == 0) & ~torch.signbit(x)).any())
    assert bool(torch.signbit(got.mesh_min[sk.mesh_id, 0]))
    assert not bool(torch.signbit(got.mesh_max[sk.mesh_id, 0]))
    _, _, crowd_data = crowd
    _hold(crowd_data, tie_pose(1760))


def test_skeleton_beyond_48_kb_of_shared_memory(crowd):
    """The first skin's joints spread over 1,100 rows (70,400 B of
    matrices, the pose kernel's shared memory asked for beyond 48 KB),
    the other skins as they are."""
    _, scene, data = crowd
    n = 1100
    first = data.skins[0]
    big = dataclasses.replace(first, n_joints=n,
                              joints=(first.joints * 20 + 7) % n)
    skins = (big,) + tuple(data.skins[1:])
    assert ops.skin_batch(skins).max_joints == n
    _hold(data, animation.joint_matrices(scene, 17, 1 / 60), skins)


def test_scene_sets_up_the_kernels_once(cuda, monkeypatch):
    """scene_from_numpy sets the kernels up on the card (SceneData.skin_batch,
    TlasData.refit_bounds); Renderer frames read that and set up nothing
    (skin_batch and tlas_bounds would raise), one launch of each kernel a
    frame; without the set-up the CUDA route raises."""
    from chip_smoke import config5_preset, knot_joint_mats, preset_renderer

    p = dataclasses.replace(config5_preset(pt, True, 160 / 96),
                            pair_capacity=1 << 17)
    data = p.world.device(cuda, with_tlas=True)
    assert data.skin_batch.n_skins == len(data.skins) == 1
    assert data.skin_batch.device == data.device
    assert data.tlas.refit_bounds.device == data.device
    assert data.tlas.refit_bounds.tolist()[-1] == data.tlas.refit_order.shape[0]
    r = preset_renderer(p, data, 160, 96)

    def no_set_up(*_a, **_k):
        raise AssertionError("set up inside a frame")

    monkeypatch.setattr(ops, "skin_batch", no_set_up)
    monkeypatch.setattr(ops, "tlas_bounds", no_set_up)
    before = (ops.LAUNCHES, ops.LAUNCHES_BLAS, ops.LAUNCHES_TLAS)
    for i in range(2):
        r.render(p.camera, joint_mats=knot_joint_mats(i))
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.LAUNCHES_BLAS, ops.LAUNCHES_TLAS) == tuple(
        b + 2 for b in before)
    jm = torch.from_numpy(knot_joint_mats(0)).to(cuda)
    with pytest.raises(ValueError, match="batch"):
        t_skin.apply_skins(data.meshes, data.skins, jm)
    with pytest.raises(ValueError, match="level bounds"):
        t_skin.refit_tlas(dataclasses.replace(data.tlas, refit_bounds=None),
                          data.meshes, data.instances)
