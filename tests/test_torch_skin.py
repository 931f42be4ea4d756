"""Port parity: vertex skinning with BLAS and TLAS refits
(voidin_tpu_torch.scene.skin, the Renderer's joint_mats) against the JAX
package, on the cases of tests/test_skin.py that build their meshes in the
test (:61, :79, :189, :277, :348; the glTF-driven ones wait for the port's
io/gltf.py).

Both packages skin the same pool: the port's scene comes from the JAX
SceneData through scene_from_numpy (tests/test_torch_scene.py port_scene),
skins included, and the port's own World is held to the same leaves.
Tolerances: identity joints reproduce the pool tables bit for bit; bent
poses match JAX's op-by-op apply_skins to 1e-6 in tri_pos and in the refit
AABBs (the port rounds each einsum as XLA's dot does; measured 0 on these
poses); the frame within the frame tests' 5e-3 sRGB mean of JAX's jitted
frame; the traced-shadow probe's three answers equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.framework.renderer import Renderer as JaxRenderer
from voidin_tpu.passes.raster import RasterConfig as JaxRasterConfig
from voidin_tpu.rt import traverse as j_trav
from voidin_tpu.scene import skin as j_skin

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import mathx
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.ops import shadow_trace as t_st
from voidin_tpu_torch.passes.raster import RasterConfig
from voidin_tpu_torch.rt import traverse as t_trav
from voidin_tpu_torch.scene import skin as t_skin
from voidin_tpu_torch.scene.mesh import Mesh as PtMesh

from chip_smoke import refit_violations
from tests.test_skin import _strip_mesh
from tests.test_torch_scene import jax_leaves, port_scene

torch.set_num_threads(2)
TOL = 1e-6
FRAME_BUDGET = 5e-3


def _skinned_world(pkg, skin_mod, build_bvh=True):
    """tests/test_skin.py _skinned_world on `pkg`'s World: the 2-joint
    strip, one instance at the origin, a point light."""
    w = pkg.World(build_bvh=build_bvh)
    mesh, jv, wv = _strip_mesh()
    if pkg is pt:
        mesh = PtMesh(mesh.vertices, mesh.normals, mesh.tangents, mesh.uvs,
                      mesh.indices)
    mid = w.meshes.add(mesh)
    info = w.meshes.mesh_info[mid]
    off = w.allocate_joints(2)
    w.skins.append(skin_mod.build_skin_data(
        mesh, w.meshes.indices[mid], jv, wv,
        base_tri=info["base_index"] // 3, mesh_id=mid, joint_offset=off,
        n_joints=2, nodes=w.meshes.bvh_nodes[mid],
        bvh_base=info["bvh_index"]))
    w.instances.add(np.eye(4, dtype=np.float32), mid, 0)
    w.lights.add_point_light([0, 1, 4], 20.0, [1, 1, 1])
    return w, mid


def _bend(angle):
    """Joint 0 at rest, joint 1 rotated `angle` about z around (0, 1, 0)."""
    rot = np.asarray(mathx.from_translation([0, 1, 0])
                     @ mathx.from_rotation_z(np.float32(angle))
                     @ mathx.from_translation([0, -1, 0]))
    return np.stack([np.eye(4, dtype=np.float32), rot]).astype(np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["flat", "bvh"])
def scenes(request):
    """(JAX scene, the port's scene from its leaves, the port World's own
    scene) of the strip, without and with a BVH to refit."""
    jw, _ = _skinned_world(vt, j_skin, build_bvh=request.param)
    pw, _ = _skinned_world(pt, t_skin, build_bvh=request.param)
    js = jw.device(with_tlas=True)
    return js, port_scene(js), pw.device("cpu", with_tlas=True)


def test_world_skins_match_jax(scenes):
    js, bridged, own = scenes
    assert len(own.skins) == len(js.skins) == 1
    want = jax_leaves(js.skins[0])
    for ps in (bridged, own):
        got = t_skin.skin_leaves(ps.skins[0])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert t_skin.skin_statics(ps.skins[0]) == \
            t_skin.skin_statics(js.skins[0])
    np.testing.assert_array_equal(own.meshes.tri_pos.numpy(),
                                  np.asarray(js.meshes.tri_pos))


def test_identity_skin_reproduces_pool_tables(scenes):
    """tests/test_skin.py:61 on the port: identity joints give back the
    pool's own tables bit for bit."""
    _, ps, own = scenes
    for s in (ps, own):
        m2 = t_skin.apply_skins(s.meshes, s.skins,
                                torch.from_numpy(_bend(0.0)[[0, 0]]))
        np.testing.assert_array_equal(m2.tri_pos.numpy(),
                                      s.meshes.tri_pos.numpy())
        np.testing.assert_array_equal(m2.tri_attr_packed.numpy(),
                                      s.meshes.tri_attr_packed.numpy())


@pytest.mark.parametrize("angle", [np.pi / 2, 1.2, -np.pi / 2])
def test_bent_pose_matches_jax(scenes, angle):
    """tests/test_skin.py:79 and :277 on the port: the bent tri_pos, the
    packed attributes and, with a BVH, the refit node AABBs against JAX's
    apply_skins; the joint-1 corners follow the rotation, the blended ones
    move halfway."""
    js, ps, _ = scenes
    jm = _bend(angle)
    jm2 = j_skin.apply_skins(js.meshes, js.skins, jm)
    pm2 = t_skin.apply_skins(ps.meshes, ps.skins, torch.from_numpy(jm))
    for k in ("tri_pos", "mesh_min", "mesh_max", "bvh_min", "bvh_max"):
        np.testing.assert_allclose(getattr(pm2, k).numpy(),
                                   np.asarray(getattr(jm2, k)), rtol=0,
                                   atol=TOL, err_msg=k)
    np.testing.assert_array_equal(pm2.tri_attr_packed.numpy(),
                                  np.asarray(jm2.tri_attr_packed)
                                  .view(np.int32))
    sd = ps.skins[0]
    pos = pm2.tri_pos.numpy().reshape(-1, 3, 3)[
        sd.base_tri:sd.base_tri + sd.rest_pos.shape[0]]
    rest, jts, wts = (sd.rest_pos.numpy(), sd.joints.numpy(),
                      sd.weights.numpy())
    m1 = (jts[..., 0] == 1) & (wts[..., 0] == 1.0)
    np.testing.assert_allclose(pos[m1], rest[m1] @ jm[1, :3, :3].T
                               + jm[1, :3, 3], atol=1e-5)
    mb = np.isclose(wts[..., 0], 0.5) & np.isclose(wts[..., 1], 0.5)
    rotated = rest[mb] @ jm[1, :3, :3].T + jm[1, :3, 3]
    np.testing.assert_allclose(pos[mb], 0.5 * rest[mb] + 0.5 * rotated,
                               atol=1e-5)


def test_refits_are_valid_and_tight():
    """tests/test_skin.py:277's invariants on the port, and the TLAS's
    (chip_smoke.refit_violations, which the card's smoke run checks too):
    every reachable node contains its triangles or children, each root is
    tight."""
    pw, mid = _skinned_world(pt, t_skin)
    ps = pw.device("cpu", with_tlas=True)
    assert ps.skins[0].refit_order is not None
    m2 = t_skin.apply_skins(ps.meshes, ps.skins, torch.from_numpy(_bend(1.2)))
    tlas = t_skin.refit_tlas(ps.tlas, m2, ps.instances)
    assert refit_violations(pw, mid, m2, tlas, ps.instances) == dict(
        blas=0, blas_root=0, tlas=0, tlas_root=0)
    # the rest pose's bounds no longer hold the bent strip
    assert refit_violations(pw, mid, dataclasses.replace(
        m2, bvh_min=ps.meshes.bvh_min, bvh_max=ps.meshes.bvh_max), ps.tlas,
        ps.instances)["blas_root"] == 1


def test_skinned_render_matches_jax():
    """tests/test_skin.py:189 on the port: no joint_mats raises; the bind
    pose renders; a bent pose changes the image; both frames within the
    frame budget of JAX's."""
    jw, _ = _skinned_world(vt, j_skin, build_bvh=False)
    js = jw.device()
    jr = JaxRenderer(js, JaxRasterConfig(
        width=96, height=64, tri_capacity=1 << 10, pair_capacity=1 << 12,
        tile_tri_capacity=64, interpret=True), enable_taa=False)
    r = Renderer(port_scene(js), RasterConfig(
        width=96, height=64, tri_capacity=1 << 10, pair_capacity=1 << 12,
        tile_tri_capacity=64), enable_taa=False)
    cam = pt.Camera(position=[0, 1, 3.0], yaw=0.0, aspect=96 / 64)
    jcam = vt.Camera(position=[0, 1, 3.0], yaw=0.0, aspect=96 / 64)
    with pytest.raises(ValueError):
        r.render(cam)
    imgs = []
    for jm in (_bend(0.0)[[0, 0]], _bend(1.0)):
        got = r.render(cam, joint_mats=jm).numpy()
        want = np.asarray(jr.render(jcam, joint_mats=jm))
        assert int(r.aux["overflow"]) == 0
        assert np.isfinite(got).all() and got.var() > 0
        diff = np.abs(got - want).mean()
        print(f"skinned frame: mean abs diff vs JAX {diff:.3e}")
        assert diff < FRAME_BUDGET
        imgs.append(got)
    assert np.abs(imgs[1] - imgs[0]).max() > 0.05
    # the Renderer's scene keeps the rest pose
    np.testing.assert_array_equal(r.scene.meshes.tri_pos.numpy(),
                                  np.asarray(js.meshes.tri_pos))


def test_renderer_needs_joint_mats_for_a_skinned_scene():
    pw, _ = _skinned_world(pt, t_skin)
    r = Renderer(pw.device("cpu"), RasterConfig(width=32, height=16,
                                                tri_capacity=1 << 8,
                                                pair_capacity=1 << 10))
    with pytest.raises(ValueError, match="joint_mats"):
        r.render(pt.Camera(position=[0, 1, 3.0], aspect=2.0))


def test_skinned_traced_shadow_tracks_pose():
    """tests/test_skin.py:348 on the port: after a 90 degree bend and the
    BLAS + TLAS refits, a probe under the bent tip is occluded; the rest
    pose occludes under the strip and not beside it. The port's three
    answers equal JAX's."""
    jw, _ = _skinned_world(vt, j_skin)
    js = jw.device(with_tlas=True)
    ps = port_scene(js)
    jm = _bend(-np.pi / 2)
    jm2 = j_skin.apply_skins(js.meshes, js.skins, jm)
    js2 = js.replace(meshes=jm2, tlas=j_skin.refit_tlas(js.tlas, jm2,
                                                        js.instances))
    pm2 = t_skin.apply_skins(ps.meshes, ps.skins, torch.from_numpy(jm))
    ps2 = dataclasses.replace(ps, meshes=pm2, tlas=t_skin.refit_tlas(
        ps.tlas, pm2, ps.instances))
    np.testing.assert_allclose(ps2.tlas.tlas_min.numpy(),
                               np.asarray(js2.tlas.tlas_min), atol=TOL)
    np.testing.assert_allclose(ps2.tlas.tlas_max.numpy(),
                               np.asarray(js2.tlas.tlas_max), atol=TOL)

    def jax_probe(s, x):
        tlas, blas, inst, tri_pos = j_trav.scene_rays(s)
        o = np.asarray([[x, 0.97, 1.0]], np.float32)
        d = np.asarray([[0.0, 0.0, -2.0]], np.float32)
        return bool(np.asarray(j_trav.occluded(
            tlas, blas, inst, tri_pos, o, d, t_max=1.0).hit)[0])

    def port_probe(s, x):
        o = torch.tensor([[x, 0.97, 1.0]])
        d = torch.tensor([[0.0, 0.0, -2.0]])
        return bool(t_st.occluded(*t_trav.scene_rays_threaded(s), o, d,
                                  t_max=1.0,
                                  max_leaf=s.meshes.bvh_max_leaf).hit[0])

    got = [port_probe(ps, 0.0), port_probe(ps, 0.9), port_probe(ps2, 0.9)]
    want = [jax_probe(js, 0.0), jax_probe(js, 0.9), jax_probe(js2, 0.9)]
    assert got == want == [True, False, True]


def test_skinned_frame_traces_shadows_against_the_pose(monkeypatch):
    """The frame packs its shadow-ray tables from the skinned scene: the
    table the shadow kernel gets holds the refit BLAS and TLAS, not the
    rest pose's."""
    pw, _ = _skinned_world(pt, t_skin)
    scene = pw.device("cpu", with_tlas=True)
    seen, real = [], t_st.occluded
    monkeypatch.setattr(t_st, "occluded",
                        lambda *a, **k: seen.append(a) or real(*a, **k))
    r = Renderer(scene, RasterConfig(width=64, height=32,
                                     tri_capacity=1 << 10,
                                     pair_capacity=1 << 12),
                 enable_taa=False, enable_rt_shadows=True)
    jm = _bend(-np.pi / 2)
    r.render(pt.Camera(position=[0, 1, 3.0], aspect=2.0), joint_mats=jm)
    assert int(r.aux["rt_exhausted"]) == 0 and len(seen) == 1
    m2 = t_skin.apply_skins(scene.meshes, scene.skins, torch.from_numpy(jm))
    posed = dataclasses.replace(scene, meshes=m2, tlas=t_skin.refit_tlas(
        scene.tlas, m2, scene.instances))
    assert torch.equal(seen[0][0], t_trav.scene_rays_threaded(posed)[0])
    assert not torch.equal(seen[0][0], t_trav.scene_rays_threaded(scene)[0])
