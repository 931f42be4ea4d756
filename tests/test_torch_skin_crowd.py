"""Port parity of skinning at a crowd's shape: three skins on three distinct
meshes, each with its own 55-row skeleton (joint offsets 0, 55 and 110,
as a crowd of humanoids of 55 joints allocates them), posed by one joint
array of 165 rows with blended 4-influence weights and refit (BLAS and
TLAS), against the JAX package (voidin_tpu_torch.scene.skin against
voidin_tpu.scene.skin), within tests/test_torch_skin.py's 1e-6; and the
skin layer's counters (skin.tris, skin.joints, refit.nodes) in the
profiler's scopes, a frame rendered alike with the switch on and off.
"""

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.scene import skin as j_skin
from voidin_tpu.scene.mesh import Mesh as JaxMesh

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework import profiler
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.passes.raster import RasterConfig
from voidin_tpu_torch.scene import skin as t_skin
from voidin_tpu_torch.scene.mesh import Mesh as PtMesh

from tests.test_torch_scene import jax_leaves, port_scene

torch.set_num_threads(2)
TOL = 1e-6
N_JOINTS = 55
# (sides, rings, height) of each skin's tube: three distinct meshes
TUBES = [(6, 12, 1.8), (8, 9, 1.5), (5, 14, 2.1)]


def _tube(sides, rings, height):
    """A vertical tube of `rings` + 1 rings and its 4-influence weights
    over a 55-joint chain up its axis: each vertex takes the four joints
    nearest its height, weighted by a smooth falloff and normalised."""
    y = np.linspace(0.0, height, rings + 1)
    a = 2 * np.pi * np.arange(sides) / sides
    r = 0.2 + 0.05 * np.sin(3 * y / height)
    v = np.stack([r[:, None] * np.cos(a), np.broadcast_to(y[:, None],
                  (rings + 1, sides)), r[:, None] * np.sin(a)], -1)
    v = v.reshape(-1, 3).astype(np.float32)
    n = v * np.array([1.0, 0.0, 1.0], np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = np.tile(np.array([[0, 1, 0, -1]], np.float32), (len(v), 1))
    uv = np.stack([np.tile(a / (2 * np.pi), rings + 1),
                   np.repeat(y / height, sides)], 1).astype(np.float32)
    i = np.arange(rings)[:, None]
    j = np.arange(sides)[None, :]
    a0, a1 = i * sides + j, i * sides + (j + 1) % sides
    idx = np.stack([a0, a0 + sides, a1, a1, a0 + sides, a1 + sides],
                   -1).reshape(-1).astype(np.int32)
    joint_y = np.linspace(0.0, height, N_JOINTS)
    d = np.abs(v[:, 1, None] - joint_y[None])
    near = np.argsort(d, axis=1, kind="stable")[:, :4]
    w = np.exp(-(np.take_along_axis(d, near, 1) / (height / 40)) ** 2)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    return (v, n, t, uv, idx), near.astype(np.int32), w


def _world(pkg, skin_mod):
    w = pkg.World()
    for k, tube in enumerate(TUBES):
        arrays, jv, wv = _tube(*tube)
        mesh = (PtMesh if pkg is pt else JaxMesh)(*arrays)
        mid = w.meshes.add(mesh)
        info = w.meshes.mesh_info[mid]
        off = w.allocate_joints(N_JOINTS)
        assert off == k * N_JOINTS
        w.skins.append(skin_mod.build_skin_data(
            mesh, w.meshes.indices[mid], jv, wv,
            base_tri=info["base_index"] // 3, mesh_id=mid, joint_offset=off,
            n_joints=N_JOINTS, nodes=w.meshes.bvh_nodes[mid],
            bvh_base=info["bvh_index"]))
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [1.2 * k - 1.2, 0.0, -0.5 * k]
        w.instances.add(t, mid, 0)
    w.lights.add_point_light([2, 4, 4], 30.0, [1, 1, 1])
    return w


def _pose(seed=5):
    """(165, 4, 4) joint matrices: each row a turn of up to 0.6 rad about
    a random axis through its joint's rest height, and a small shift."""
    rng = np.random.default_rng(seed)
    rows = []
    for k, (_, _, height) in enumerate(TUBES):
        for y in np.linspace(0.0, height, N_JOINTS):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            ang = rng.uniform(-0.6, 0.6)
            kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                           [-axis[1], axis[0], 0]])
            rot = np.eye(3) + np.sin(ang) * kx \
                + (1 - np.cos(ang)) * kx @ kx
            m = np.eye(4)
            m[:3, :3] = rot
            pivot = np.array([0.0, y, 0.0])
            m[:3, 3] = pivot - rot @ pivot + rng.uniform(-0.05, 0.05, 3)
            rows.append(m)
    return np.stack(rows).astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, the port's scene from its leaves, the port World's own
    scene) of the three skinned tubes, with a TLAS."""
    js = _world(vt, j_skin).device(with_tlas=True)
    own = _world(pt, t_skin).device("cpu", with_tlas=True)
    return js, port_scene(js), own


def test_three_skins_of_55_rows_bind_as_jax(scenes):
    js, bridged, own = scenes
    assert [s.joint_offset for s in js.skins] == [0, 55, 110]
    for ps in (bridged, own):
        assert len(ps.skins) == 3
        for got, want in zip(ps.skins, js.skins):
            assert t_skin.skin_statics(got) == t_skin.skin_statics(want)
            leaves = jax_leaves(want)
            for k, v in t_skin.skin_leaves(got).items():
                np.testing.assert_array_equal(v, leaves[k], err_msg=k)
            assert (got.weights > 0).sum(-1).min() >= 2


def test_crowd_pose_and_refits_match_jax(scenes):
    js, bridged, own = scenes
    jm = _pose()
    jm2 = j_skin.apply_skins(js.meshes, js.skins, jm)
    jt = j_skin.refit_tlas(js.tlas, jm2, js.instances)
    for ps in (bridged, own):
        pm2 = t_skin.apply_skins(ps.meshes, ps.skins, torch.from_numpy(jm))
        for k in ("tri_pos", "mesh_min", "mesh_max", "bvh_min", "bvh_max"):
            np.testing.assert_allclose(getattr(pm2, k).numpy(),
                                       np.asarray(getattr(jm2, k)), rtol=0,
                                       atol=TOL, err_msg=k)
        np.testing.assert_array_equal(pm2.tri_attr_packed.numpy(),
                                      np.asarray(jm2.tri_attr_packed)
                                      .view(np.int32))
        pt2 = t_skin.refit_tlas(ps.tlas, pm2, ps.instances)
        np.testing.assert_allclose(pt2.tlas_min.numpy(),
                                   np.asarray(jt.tlas_min), rtol=0, atol=TOL)
        np.testing.assert_allclose(pt2.tlas_max.numpy(),
                                   np.asarray(jt.tlas_max), rtol=0, atol=TOL)
    # the pose moved every skin
    moved = np.abs(np.asarray(jm2.tri_pos) - np.asarray(js.meshes.tri_pos))
    for s in js.skins:
        n = s.rest_pos.shape[0]
        assert moved[s.base_tri:s.base_tri + n].max() > 0.05


def _frame(scene, jm):
    r = Renderer(scene, RasterConfig(width=64, height=32,
                                     tri_capacity=1 << 11,
                                     pair_capacity=1 << 12),
                 enable_taa=False, enable_rt_shadows=True)
    cam = pt.Camera(position=[0.0, 1.0, 4.0], pitch=-5.0, aspect=2.0)
    img = r.render(cam, joint_mats=jm)
    return img, r.aux


def test_skin_counters_and_the_frame_alike_on_and_off(scenes):
    """One frame with the scopes on counts, inside update.skin and
    update.refit, each skin's triangles, the 165 joint rows and the
    nodes of the three BLAS refit plans and of the TLAS; its image and
    aux equal, word for word, the frame with the switch off."""
    _, _, own = scenes
    jm = torch.from_numpy(_pose())
    off_img, off_aux = _frame(own, jm)
    profiler.disable()
    profiler.collect()
    profiler.enable()
    try:
        on_img, on_aux = _frame(own, jm)
    finally:
        profiler.disable()
    recs = profiler.collect()
    where = {}
    for d in recs:
        for k, v in d["counters"].items():
            if k in ("skin.tris", "skin.joints", "refit.nodes"):
                where.setdefault(k, {}).setdefault(d["name"], 0)
                where[k][d["name"]] += v
    skins = own.skins
    assert where["skin.tris"] == {
        "update.skin": sum(s.rest_pos.shape[0] for s in skins)}
    assert where["skin.joints"] == {"update.skin": 3 * N_JOINTS}
    assert where["refit.nodes"] == {
        "update.skin": sum(s.refit_order.shape[0] for s in skins),
        "update.refit": own.tlas.refit_order.shape[0]}
    assert torch.equal(on_img, off_img)
    assert sorted(on_aux) == sorted(off_aux)
    for k in off_aux:
        assert torch.equal(torch.as_tensor(on_aux[k]),
                           torch.as_tensor(off_aux[k])), k
