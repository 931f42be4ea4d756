"""Bounds validation on the port (RasterConfig.debug_bounds,
voidin_tpu_torch/core/checks.py): the counterparts of tests/test_checks.py
(a clean frame passes and stays word for word the unchecked frame; a
corrupt scene trips a named check), on tests/test_resolve_quad.py's
textured scene carried over from the JAX package, plus the texture and
traversal checks and the table checks that run before the walk kernels'
launches, on the CPU here (tests/test_torch_cuda.py runs them on the card).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.core import mathx as j_mathx

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import checks
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.ops import closest_hit as t_ch
from voidin_tpu_torch.ops import shadow_trace as t_st
from voidin_tpu_torch.passes import cull, raster, resolve
from voidin_tpu_torch.passes.raster import RasterConfig
from voidin_tpu_torch.rt import traverse
from voidin_tpu_torch.scene.texture import sample_trilinear

from tests.test_resolve_quad import CFG as J_CFG
from tests.test_resolve_quad import _textured_scene
from tests.test_torch_scene import port_scene

torch.set_num_threads(2)
CFG = RasterConfig(width=J_CFG.width, height=J_CFG.height,
                   tri_capacity=J_CFG.tri_capacity,
                   pair_capacity=J_CFG.pair_capacity)


@pytest.fixture(scope="module")
def textured():
    """(scene, camera uniform, VisBuffer) of the textured scene."""
    scene = port_scene(_textured_scene().device())
    cam = pt.Camera(position=[0.0, 0.5, 2.0], yaw=0.0, pitch=-10.0,
                    aspect=CFG.width / CFG.height).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, CFG)
    return scene, cam, vis


def _checked_resolve(scene, vis):
    with checks.bounds(True):
        return resolve.resolve_gbuffer(scene, vis, CFG)


def test_clean_frame_passes_and_matches_unchecked(textured):
    scene, _, vis = textured
    gb, aux = _checked_resolve(scene, vis)
    gb0, aux0 = resolve.resolve_gbuffer(scene, vis, CFG)
    for a, b in ((gb.normal_uv, gb0.normal_uv), (gb.depth, gb0.depth),
                 (aux.albedo, aux0.albedo), (aux.mr, aux0.mr)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not checks.bounds_enabled()


def test_corrupt_tri_id_trips_resolve_check(textured):
    scene, _, vis = textured
    bad = dataclasses.replace(vis, tri_id=torch.where(
        vis.tri_id >= 0, vis.tri_id + 10_000_000, vis.tri_id))
    with pytest.raises(IndexError, match="resolve.rec"):
        _checked_resolve(scene, bad)


def test_corrupt_instance_id_trips_instance_check(textured):
    scene, _, vis = textured
    rec = vis.resolve_rec.clone()
    rec[:, 9] = 1.0e7  # instance column
    with pytest.raises(IndexError, match="resolve.instance"):
        _checked_resolve(scene, dataclasses.replace(vis, resolve_rec=rec))


def test_corrupt_index_start_trips_tri_attr_check(textured):
    scene, _, vis = textured
    rec = vis.resolve_rec.clone()
    rec[:, 10] = 3.0e7  # idx_start column
    with pytest.raises(IndexError, match="resolve.tri_attr"):
        _checked_resolve(scene, dataclasses.replace(vis, resolve_rec=rec))


def test_texture_quads_check(textured):
    """A texture id past the pool trips texture.quads; off, the check
    is a passthrough (and the bad gather fails unnamed)."""
    scene = textured[0]
    uv = torch.full((4, 2), 0.5)
    lod = torch.zeros(4)
    wh = (torch.full((4,), 64.0), torch.full((4,), 64.0))
    bad = torch.full((4,), 100_000, dtype=torch.int64)
    with checks.bounds(True):
        with pytest.raises(IndexError, match="texture.quads"):
            sample_trilinear(scene.textures, bad, uv, lod, wh=wh)
        sample_trilinear(scene.textures, torch.zeros(4, dtype=torch.int64),
                         uv, lod, wh=wh)
    idx = torch.tensor([5, 10_000_000])
    assert checks.check_index(idx, 3, "unused") is idx


def test_renderer_debug_bounds_end_to_end():
    """The Renderer sets the bounds mode for its frame alone: a clean
    scene renders word for word as unchecked, TAA on; the mode is off
    after the frame; the option is no longer refused."""
    world = port_scene(_textured_scene().device())
    cam = pt.Camera(position=[0.0, 0.5, 2.0], yaw=0.0, pitch=-10.0,
                    aspect=CFG.width / CFG.height)
    r0 = Renderer(world, CFG)
    r1 = Renderer(world, dataclasses.replace(CFG, debug_bounds=True))
    for _ in range(2):
        img0 = r0.render(cam).numpy()
        img1 = r1.render(cam).numpy()
    np.testing.assert_array_equal(img0, img1)
    assert not checks.bounds_enabled()


def test_bounds_mode_is_thread_local():
    seen = []
    with checks.bounds(True):
        t = threading.Thread(target=lambda: seen.append(
            checks.bounds_enabled()))
        t.start()
        t.join()
        assert checks.bounds_enabled()
    assert seen == [False] and not checks.bounds_enabled()


def _rt_scene():
    """tests/test_checks.py's traversal scene (4 spheres) with its TLAS."""
    w = vt.World()
    w.lights.add_point_light([0.0, 6.0, 4.0], 30.0, [1.0, 1.0, 1.0])
    rng = np.random.default_rng(0)
    for _ in range(4):
        t = j_mathx.from_translation(rng.uniform(-3, 3, 3))
        w.instances.add(np.asarray(t), vt.mesh.SPHERE_1_MESH, 0)
    return port_scene(w.device(with_tlas=True)), rng


def _rays(rng, n=64):
    return (torch.as_tensor(rng.uniform(-5, 5, (n, 3)), dtype=torch.float32),
            torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32))


def test_traversal_node_check():
    """A corrupt TLAS child pointer (the root's left child far past the
    node table) trips an rt. check inside the shadow walk: the wrapper
    on CPU tensors runs the twin, which checks each gather."""
    scene, rng = _rt_scene()
    table, n_tlas, inst, tri_pos = traverse.scene_rays_threaded(scene)
    bad = table.clone()
    bad[0, 3] = 1.0e7
    o, d = _rays(rng)
    t_st.occluded(table, n_tlas, inst, tri_pos, o, d, t_max=10.0)
    with checks.bounds(True):
        t_st.occluded(table, n_tlas, inst, tri_pos, o, d, t_max=10.0)
        with pytest.raises(IndexError, match="rt\\.node"):
            t_st.occluded(bad, n_tlas, inst, tri_pos, o, d, t_max=10.0)


def test_closest_hit_node_check():
    """The closest-hit walk's counterpart: a corrupt TLAS child trips
    rt.tlas_node, a corrupt leaf instance rt.instance."""
    scene, rng = _rt_scene()
    tlas, blas, inst, tri_pos = traverse.scene_rays(scene)
    o, d = _rays(rng)
    leaf = int(torch.nonzero(tlas[:, 3] < 0)[0])
    with checks.bounds(True):
        t_ch.closest_hit(tlas, blas, inst, tri_pos, o, d)
        bad = tlas.clone()
        bad[0, 3] = 1.0e7
        with pytest.raises(IndexError, match="rt\\.tlas_node"):
            t_ch.closest_hit(bad, blas, inst, tri_pos, o, d)
        bad = tlas.clone()
        bad[leaf, 7] = 1.0e7
        bad[:, 0:3] = -1e9  # every node's box holds every ray
        bad[:, 4:7] = 1e9
        with pytest.raises(IndexError, match="rt\\.instance"):
            t_ch.closest_hit(bad, blas, inst, tri_pos, o, d)


THREADED_CORRUPTIONS = {
    "tlas child": (lambda t, n: (0, 3, 1.0e7), "rt.node"),
    "tlas exit": (lambda t, n: (1, 7, float(n + 5)), "rt.node"),
    "tlas leaf": (lambda t, n: (int(torch.nonzero(t[:n, 3] < 0)[0]), 3,
                                -1.0e7), "rt.instance"),
    "blas exit": (lambda t, n: (n, 7, 1.0e7), "rt.node"),
    "blas child": (lambda t, n: (n + int(torch.nonzero(t[n:, 8] <= 0)[0]),
                                 3, 1.0e7), "rt.node"),
    "blas leaf": (lambda t, n: (n + int(torch.nonzero(t[n:, 8] > 0)[0]), 3,
                                1.0e7), "rt.tri_pos"),
    "nan exit": (lambda t, n: (0, 7, float("nan")), "rt.node"),
    "nan count": (lambda t, n: (n, 8, float("nan")), "rt.tri_pos"),
}


@pytest.mark.parametrize("kind", sorted(THREADED_CORRUPTIONS))
def test_threaded_table_check(kind):
    """The shadow kernel's pre-launch check (check_threaded_table, run
    here on CPU tensors): the clean tables pass, each corrupt link column
    raises its name."""
    scene, _ = _rt_scene()
    table, n_tlas, inst, tri_pos = traverse.scene_rays_threaded(scene)
    traverse.check_threaded_table(table, n_tlas, inst, tri_pos)
    where, name = THREADED_CORRUPTIONS[kind]
    row, col, value = where(table, n_tlas)
    bad = table.clone()
    bad[row, col] = value
    with pytest.raises(IndexError, match=name.replace(".", "\\.")):
        traverse.check_threaded_table(bad, n_tlas, inst, tri_pos)


STACK_CORRUPTIONS = {
    "tlas left": ("tlas", lambda t: (0, 3, 1.0e7), "rt.tlas_node"),
    "tlas right": ("tlas", lambda t: (0, 7, -5.0), "rt.tlas_node"),
    "tlas leaf": ("tlas", lambda t: (int(torch.nonzero(t[:, 3] < 0)[0]), 7,
                                     1.0e7), "rt.instance"),
    "blas child": ("blas", lambda t: (int(torch.nonzero(t[:, 7] <= 0)[0]),
                                      3, 1.0e7), "rt.blas_node"),
    "blas leaf": ("blas", lambda t: (int(torch.nonzero(t[:, 7] > 0)[0]), 3,
                                     1.0e7), "rt.tri_pos"),
    "instance root": ("inst", lambda t: (0, 16, 1.0e7), "rt.blas_node"),
}


@pytest.mark.parametrize("kind", sorted(STACK_CORRUPTIONS))
def test_stack_table_check(kind):
    """The closest-hit kernel's pre-launch check (check_stack_tables)."""
    scene, _ = _rt_scene()
    tabs = dict(zip(("tlas", "blas", "inst", "tri"),
                    traverse.scene_rays(scene)))
    traverse.check_stack_tables(*tabs.values())
    which, where, name = STACK_CORRUPTIONS[kind]
    row, col, value = where(tabs[which])
    tabs[which] = tabs[which].clone()
    tabs[which][row, col] = value
    with pytest.raises(IndexError, match=name.replace(".", "\\.")):
        traverse.check_stack_tables(*tabs.values())


def test_renderer_rt_frame_with_corrupt_tlas_raises():
    """A raytraced frame with debug_bounds on a scene whose TLAS points
    past its table raises an rt. error naming the walk's gather."""
    scene, _ = _rt_scene()
    cfg = RasterConfig(width=64, height=32, tri_capacity=1 << 10,
                       pair_capacity=1 << 12, debug_bounds=True)
    cam = pt.Camera(position=[0.0, 0.0, 8.0], yaw=0.0, aspect=2.0)
    r = Renderer(scene, cfg, enable_taa=False, enable_rt_shadows=True)
    assert r.render(cam).shape == (32, 64, 3)
    scene.tlas.tlas_left_right[0] = 0x7FFF7FFF  # children 32767
    with pytest.raises(IndexError, match="rt\\."):
        r.render(cam)


def test_checked_sharded_frame_matches_unchecked():
    """debug_bounds holds on the sharded frame too: a clean sharded frame
    with the mode on equals the unchecked unsharded one."""
    from voidin_tpu_torch.parallel.sharding import make_mesh

    world = port_scene(_textured_scene().device())
    c = pt.Camera(position=[0.0, 0.5, 2.0], yaw=0.0, pitch=-10.0,
                  aspect=CFG.width / CFG.height)
    want = Renderer(world, CFG, enable_taa=False).render(c).numpy()
    got = Renderer(world, dataclasses.replace(CFG, debug_bounds=True),
                   enable_taa=False,
                   mesh=make_mesh(devices=["cpu"] * 2)).render(c).numpy()
    np.testing.assert_array_equal(got, want)
