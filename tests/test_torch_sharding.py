"""The port's row-sharded frame (voidin_tpu_torch/parallel/sharding.py,
framework/renderer.py with a mesh) on meshes of the CPU named n times
(n = 2, 4, 8), the counterparts of tests/test_sharding.py's eleven tests
at its 256x128 (16 rows a slab on 8 slabs).

The sharded frame must equal the port's unsharded frame word for word
(pair and block paths, track2, raytraced shadows, skinning, TAA,
area_light_scale); the port's frame must stay within the frame budget of
the JAX package's (tests/test_torch_frame.py: mean 5e-3). The JAX side
runs unsharded: tests/test_sharding.py already holds its sharded frame
bit-identical to it.

Torch runs one thread here: the CPU's vectorized transcendental
functions and its scalar ones (the tail of each thread's chunk) may round
apart, and a slab's chunks fall elsewhere than the whole image's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.core import mathx as j_mathx
from voidin_tpu.framework import renderer as j_renderer
from voidin_tpu.parallel import sharding as j_sharding
from voidin_tpu.passes.raster import RasterConfig as JaxRasterConfig

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.parallel import sharding as sh
from voidin_tpu_torch.passes import cull, raster
from voidin_tpu_torch.core import mathx as t_mathx
from voidin_tpu_torch.passes.raster import RasterConfig
from voidin_tpu_torch.scene import mesh as t_mesh
from voidin_tpu_torch.scene import skin as t_skin

from voidin_tpu_torch.framework.renderer import build_world as \
    port_build_world

from tests.test_torch_alpha import foliage_world
from tests.test_torch_scene import port_scene
from tests.test_torch_skin import _bend, _skinned_world

WIDTH, HEIGHT = 256, 128  # 128 rows = 16 rows a slab on 8 slabs
FRAME_BUDGET = 5e-3
MESHES = (2, 4, 8)
CFG = dict(width=WIDTH, height=HEIGHT, tri_capacity=1 << 12,
           pair_capacity=1 << 13, tile_tri_capacity=64)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(n):
    return sh.make_mesh(devices=["cpu"] * n)


def _world(pkg):
    """tests/test_sharding.py _scene's World on `pkg`: six moving
    spheres in a ring over a ground plane, a point and an area light.
    Returns (world, moving ids)."""
    mathx, mesh = (j_mathx, vt.mesh) if pkg is vt else (t_mathx, t_mesh)
    w = pkg.World()
    w.lights.add_point_light([0, 2.0, 0], 15.0, [1, 1, 1])
    w.add_area_light([1, 1, 1], 7.0, (5.0, 8.0), np.asarray(
        mathx.from_translation([0, 10, 15])
        @ mathx.from_rotation_x(np.float32(-np.pi / 4))))
    moving = []
    for i in range(6):
        a = 2 * np.pi * i / 6
        t = mathx.from_translation([3.5 * np.cos(a), 1 + 3.5 * np.sin(a),
                                    -10.0])
        moving.append(w.instances.add(np.asarray(t), mesh.SPHERE_1_MESH,
                                      0))
    w.instances.add(np.asarray(mathx.from_translation([0, -3, -10])
                               @ mathx.from_scale(50.0)),
                    mesh.HORIZONTAL_PLANE_MESH, 0)
    return w, np.asarray(moving, np.int32)


def _camera(pkg=pt):
    return pkg.Camera(position=[0.0, 2.0, 2.0], yaw=0.0, pitch=-10.0,
                      aspect=WIDTH / HEIGHT)


def _frames(mesh=None, n_frames=3, cfg=None, **kw):
    """The sRGB of n_frames frames (TAA on by default) of the ring scene
    through the port's Renderer, on `mesh` or unsharded; the Renderer."""
    world, moving = _world(pt)
    r = Renderer(world.device("cpu"), cfg or RasterConfig(**CFG),
                 moving_ids=moving, mesh=mesh, **kw)
    for _ in range(n_frames):
        img = r.render(_camera())
        assert int(r.aux["overflow"]) == 0
    return img.numpy(), r


def _vis_parts(cfg, alpha_mask=False):
    """(scene, uniform, draws, cfg) of the ring scene's first frame."""
    cfg = dataclasses.replace(cfg, alpha_mask=alpha_mask)
    scene = _world(pt)[0].device("cpu")
    uniform = _camera().uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, uniform)
    return scene, uniform, draws, cfg


def test_make_mesh_repeats_only_named_devices():
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.distinct == (torch.device("cpu"),)
    assert sh.ROW_AXIS in mesh.axis_names
    assert sh.make_mesh(2, devices=["cpu", "meta"]).distinct == (
        torch.device("cpu"), torch.device("meta"))
    with pytest.raises(ValueError):
        sh.make_mesh(3, devices=["cpu"] * 2)


def test_make_mesh_needs_the_devices():
    """make_mesh(n) without n visible cards raises, as the JAX package's
    does beyond its 8 virtual devices, and names the repeat that runs n
    slabs on one card."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError,
                       match=r'devices=\[torch.device\("cuda:0"\)\] \* '
                             f"{have + 1}"):
        sh.make_mesh(have + 1)
    with pytest.raises(RuntimeError):
        j_sharding.make_mesh(len(__import__("jax").devices()) + 1)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_block_frame_matches_unsharded(n):
    """The block path (backend "xla": K2's twin whole, the images split),
    3 TAA frames with moving instances: word for word."""
    cfg = RasterConfig(**CFG, backend="xla")
    want, _ = _frames(cfg=cfg)
    got, r = _frames(cpu_mesh(n), cfg=cfg)
    assert got.shape == (HEIGHT, WIDTH, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_pair_frame_matches_unsharded(n):
    """The pair path (one K1 twin run per slab), 3 TAA frames: word for
    word, overflow 0, and the same counts in aux."""
    want, r0 = _frames()
    got, r = _frames(cpu_mesh(n))
    np.testing.assert_array_equal(got, want)
    assert int(r.aux["vis_coverage"]) == int(r0.aux["vis_coverage"]) > 0
    np.testing.assert_array_equal(r.aux["depth"].numpy(),
                                  r0.aux["depth"].numpy())
    np.testing.assert_array_equal(r.state.history.numpy(),
                                  r0.state.history.numpy())


@pytest.mark.parametrize("n", MESHES)
def test_sharded_area_light_scale_matches_unsharded(n):
    """area_light_scale=2 (each slab subsamples its window, one subsampled
    row of halo each side) and 3 (slabs not aligned to the scale's
    grid): word for word."""
    for s in (2, 3):
        want, _ = _frames(n_frames=1, area_light_scale=s)
        got, _ = _frames(cpu_mesh(n), n_frames=1, area_light_scale=s)
        np.testing.assert_array_equal(got, want)


def test_sharded_frame_within_budget_of_jax():
    """The port's sharded frame (8 slabs) against the JAX package's
    jitted unsharded frame on the same scene state (block path, TAA off):
    within the frame budget."""
    jw, _ = _world(vt)
    js = jw.device()
    jcfg = JaxRasterConfig(**CFG, backend="xla")
    jr = j_renderer.Renderer(js, jcfg, enable_taa=False)
    want = np.asarray(jr.render(_camera(vt)))
    r = Renderer(port_scene(js), RasterConfig(**CFG, backend="xla"),
                 enable_taa=False, mesh=cpu_mesh(8))
    got = r.render(_camera()).numpy()
    diff = np.abs(got - want).mean()
    print(f"sharded port frame vs JAX: mean abs diff {diff:.3e}")
    assert diff < FRAME_BUDGET


@pytest.mark.parametrize("n", MESHES)
def test_sharded_raster_slabs(n):
    """rasterize_sharded returns one VisBuffer per slab, H / N rows each
    (the JAX frame's depth comes back row-sharded the same way), equal to
    those rows of the unsharded raster."""
    scene, uniform, draws, cfg = _vis_parts(RasterConfig(**CFG))
    whole = raster.rasterize(scene.meshes, scene.instances, draws, uniform,
                             cfg, materials=scene.materials)
    vis = sh.rasterize_sharded(scene.meshes, scene.instances, draws,
                               uniform, cfg, cpu_mesh(n),
                               materials=scene.materials)
    assert len(vis) == n
    for d, v in enumerate(vis):
        rows = slice(d * HEIGHT // n, (d + 1) * HEIGHT // n)
        assert v.depth.shape == (HEIGHT // n, WIDTH)
        np.testing.assert_array_equal(v.depth.numpy(),
                                      whole.depth[rows].numpy())
        np.testing.assert_array_equal(v.tri_id.numpy(),
                                      whole.tri_id[rows].numpy())
        assert int(v.overflow) == 0


@pytest.mark.parametrize("n", MESHES)
def test_sharded_raster_work_is_partitioned(n):
    """Each slab bins only its own pairs: per-slab pair counts equal the
    pairs of the global binning whose tiles lie in the slab, and they sum
    to the global count; the scene spans several slabs."""
    scene, uniform, draws, cfg = _vis_parts(RasterConfig(**CFG))
    setup = raster.triangle_setup(scene.meshes, scene.instances, draws,
                                  uniform, cfg, materials=scene.materials)
    _, _, counts_g, ov_g = raster.bin_triangles_pairs(setup, cfg)
    assert int(ov_g) == 0
    rows_per = cfg.tiles_y // n
    local = dataclasses.replace(cfg, pair_capacity=sh.local_pair_capacity(
        cfg.pair_capacity, n))
    per = []
    for d in range(n):
        _, starts, counts, ov = raster.bin_triangles_pairs(
            setup, local, ty_range=(d * rows_per, rows_per))
        assert int(ov) == 0
        assert starts.shape[0] % cfg.tile_pad == 0
        per.append(int(counts.sum()))
    tiles = counts_g[:cfg.n_tiles].reshape(cfg.tiles_y, cfg.tiles_x)
    want = tiles.reshape(n, rows_per, -1).sum(dim=(1, 2)).tolist()
    assert per == want
    assert sum(per) == int(tiles.sum())
    assert sum(p > 0 for p in per) >= min(n, 3), per


def test_slab_records_through_k1_match_the_whole_frame():
    """K1 does not change for a slab: one slab's records (clamped, local
    tile ids, baked to global pixel rows) through its twin give the rows
    of the unsharded K1 output for the slab's tiles, depth and id."""
    scene, uniform, draws, cfg = _vis_parts(RasterConfig(**CFG))
    setup = raster.triangle_setup(scene.meshes, scene.instances, draws,
                                  uniform, cfg, materials=scene.materials)
    whole = t_fr.fine_raster_pairs(*raster.bin_triangles_pairs(setup,
                                                               cfg)[:3])
    n, TX = 4, cfg.tiles_x
    rows_per = cfg.tiles_y // n
    for d in range(n):
        rec, starts, counts, _ = raster.bin_triangles_pairs(
            setup, cfg, ty_range=(d * rows_per, rows_per))
        got = t_fr.fine_raster_pairs_reference(rec, starts, counts)
        tiles = slice(d * rows_per * TX, (d + 1) * rows_per * TX)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g[:rows_per * TX].numpy(),
                                          w[tiles].numpy())


@pytest.mark.parametrize("n", MESHES)
def test_sharded_raster_track2_matches_unsharded(n):
    """The alpha-mask variant (K1 track2 per slab): depth, id and the
    runner-up's depth and id equal the unsharded raster's."""
    scene, uniform, draws, cfg = _vis_parts(RasterConfig(**CFG),
                                            alpha_mask=True)
    whole = raster.rasterize(scene.meshes, scene.instances, draws, uniform,
                             cfg, materials=scene.materials)
    vis = sh.rasterize_sharded(scene.meshes, scene.instances, draws,
                               uniform, cfg, cpu_mesh(n),
                               materials=scene.materials)
    assert vis[0].tri_id2 is not None and vis[0].depth2 is not None
    for field in ("depth", "tri_id", "depth2", "tri_id2"):
        got = sh.gather_rows([getattr(v, field) for v in vis])
        np.testing.assert_array_equal(got.numpy(),
                                      getattr(whole, field).numpy())


@pytest.mark.parametrize("n", MESHES)
def test_sharded_setup_is_slot_partitioned(monkeypatch, n):
    """Setup does not run replicated: rasterize_sharded calls
    setup_work_slice once per slab with num = tri_capacity / N at the
    slab's slot offset, and launches the fine raster once per slab."""
    scene, uniform, draws, cfg = _vis_parts(RasterConfig(**CFG))
    calls, raster_calls = [], []
    orig = raster.setup_work_slice
    orig_fr = t_fr.fine_raster_pairs

    def spy(*a, **kw):
        calls.append((kw.get("lo"), kw.get("num")))
        return orig(*a, **kw)

    def spy_fr(rec, starts, counts, **kw):
        raster_calls.append(starts.shape[0])
        return orig_fr(rec, starts, counts, **kw)

    monkeypatch.setattr(raster, "setup_work_slice", spy)
    monkeypatch.setattr(t_fr, "fine_raster_pairs", spy_fr)
    sh.rasterize_sharded(scene.meshes, scene.instances, draws, uniform, cfg,
                         cpu_mesh(n), materials=scene.materials)
    per = cfg.tri_capacity // n
    assert calls == [(d * per, per) for d in range(n)]
    local_tiles = -(-(cfg.tiles_y // n * cfg.tiles_x) // 8) * 8
    assert raster_calls == [local_tiles] * n


@pytest.mark.parametrize("cap,n", [(1 << 20, 1), (1 << 20, 2), (1 << 20, 4),
                                   (1 << 20, 8), (1 << 13, 8), (1 << 19, 4),
                                   (64, 8), (1 << 13, 3)])
def test_local_pair_capacity_matches_jax(cap, n):
    assert sh.local_pair_capacity(cap, n) == \
        j_sharding.local_pair_capacity(cap, n)


def test_extras_capacity_scales_inverse_n():
    vals = [sh.local_pair_capacity(1 << 20, n) for n in (1, 2, 4, 8)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    assert vals[3] <= vals[0] // 8 + 4 * 512
    assert sh.local_pair_capacity(64, 8) == 4 * t_fr.CHUNK


def test_shard_rows_roundtrip():
    mesh = cpu_mesh(8)
    x = torch.arange(8 * 16 * 4, dtype=torch.float32).reshape(8 * 16, 4)
    slabs = sh.shard_rows(mesh, x)
    assert [tuple(s.shape) for s in slabs] == [(16, 4)] * 8
    np.testing.assert_array_equal(sh.gather_rows(slabs).numpy(), x.numpy())
    a, b = sh.shard_rows(mesh, x, x * 2.0)
    np.testing.assert_array_equal(sh.gather_rows(b).numpy(),
                                  x.numpy() * 2.0)
    bounds = [(d * 16, (d + 1) * 16) for d in range(8)]
    np.testing.assert_array_equal(
        sh.take_rows(slabs, bounds, 15, 33, "cpu").numpy(),
        x[15:33].numpy())
    with pytest.raises(ValueError):
        sh.shard_rows(cpu_mesh(3), x)


def test_uneven_slabs_raise():
    """The JAX package's rules: tile rows and triangle capacity divide
    evenly across the slabs."""
    scene, uniform, draws, cfg = _vis_parts(RasterConfig(**CFG))
    with pytest.raises(ValueError, match="tiles_y"):
        sh.rasterize_sharded(scene.meshes, scene.instances, draws, uniform,
                             cfg, cpu_mesh(3))
    odd = dataclasses.replace(cfg, tri_capacity=(1 << 12) + 2)
    with pytest.raises(ValueError, match="tri_capacity"):
        sh.rasterize_sharded(scene.meshes, scene.instances, draws, uniform,
                             odd, cpu_mesh(4))
    with pytest.raises(ValueError, match="tiles_y"):
        Renderer(scene, cfg, mesh=cpu_mesh(3))


def _rt_world():
    """tests/test_sharding.py's raytraced-shadow scene on the port."""
    w = pt.World()
    w.lights.add_point_light([3, 6, -6], 25.0, [1, 1, 1])
    w.instances.add(np.asarray(t_mathx.from_translation([0, 1.2, -8.0])),
                    t_mesh.SPHERE_1_MESH, 0)
    w.instances.add(np.asarray(t_mathx.from_translation([0, -1, -8])
                               @ t_mathx.from_scale(30.0)),
                    t_mesh.HORIZONTAL_PLANE_MESH, 0)
    return w


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("scale", [1, 2])
def test_sharded_rt_shadows_match_unsharded(n, scale):
    """Raytraced shadows on the sharded frame (one shadow walk per slab
    and point light over the slab's rays, the TLAS replicated): word for
    word, the same rays traced."""
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 10,
                       pair_capacity=1 << 14)
    cam = pt.Camera(position=[0.0, 2.0, -2.0], yaw=0.0, pitch=-15.0,
                    aspect=WIDTH / HEIGHT)
    imgs, rays = [], []
    for mesh in (None, cpu_mesh(n)):
        r = Renderer(_rt_world().device("cpu", with_tlas=True), cfg,
                     enable_taa=False, enable_rt_shadows=True,
                     rt_shadow_scale=scale, mesh=mesh)
        imgs.append(r.render(cam).numpy())
        rays.append(int(r.aux["rt_rays"]))
        assert int(r.aux["rt_exhausted"]) == int(r.aux["overflow"]) == 0
    assert imgs[0].std() > 0.01
    np.testing.assert_array_equal(imgs[1], imgs[0])
    assert rays[1] == rays[0] > 0


@pytest.mark.parametrize("n", MESHES)
def test_sharded_skinned_frame_matches_unsharded(n):
    """Skinning and the BLAS / TLAS refits run replicated, the per-pixel
    stages per slab: the bent strip's frame, with raytraced shadows, is
    word for word the unsharded frame."""
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 10,
                       pair_capacity=1 << 14)
    cam = pt.Camera(position=[0.0, 1.0, 4.0], yaw=0.0, pitch=0.0,
                    aspect=WIDTH / HEIGHT)
    imgs = []
    for mesh in (None, cpu_mesh(n)):
        w, _ = _skinned_world(pt, t_skin)
        r = Renderer(w.device("cpu", with_tlas=True), cfg, enable_taa=False,
                     enable_rt_shadows=True, mesh=mesh)
        imgs.append(r.render(cam, joint_mats=_bend(np.pi / 3)).numpy())
        assert int(r.aux["overflow"]) == 0
    assert imgs[0].std() > 0.001
    np.testing.assert_array_equal(imgs[1], imgs[0])


@pytest.fixture(scope="module")
def foliage_scene():
    """tests/test_torch_alpha.py's foliage scene (alpha-masked cut-out
    cards with normal, metallic-roughness and emissive maps) on the CPU."""
    world, moving = foliage_world(port_build_world)
    return world.device("cpu"), moving


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "dense"])
def test_sharded_masked_frame_matches_unsharded(foliage_scene, n, lazy):
    """The alpha-masked frame (K1 track2 per slab, the alpha fallback per
    slab window, lazy compaction or the dense two-pass twin), 2 TAA
    frames: word for word, and the cut and fallback counts of the own
    rows summing to the unsharded frame's."""
    scene, moving = foliage_scene
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 15,
                       pair_capacity=1 << 16, lazy_alpha_resolve=lazy)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                    aspect=WIDTH / HEIGHT)
    imgs, counts = [], []
    for mesh in (None, cpu_mesh(n)):
        r = Renderer(scene, cfg, mesh=mesh)
        assert r.config.alpha_mask
        for _ in range(2):
            img = r.render(cam)
            assert int(r.aux["overflow"]) == 0
        imgs.append(img.numpy())
        counts.append((int(r.aux["alpha_cut"]),
                       int(r.aux["alpha_fallback"])))
    assert counts[0][0] > 0
    assert counts[1] == counts[0]
    np.testing.assert_array_equal(imgs[1], imgs[0])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("opts", [
    dict(fused_resolve_rec=True, inst_rec_f16=True),
    dict(sort_payload=True),
    dict(planar_resolve=True),
], ids=["fused_f16", "sort_payload", "planar"])
def test_sharded_record_options_match_unsharded(n, opts):
    """The record layouts, sort_payload and the planar resolve on the
    sharded frame (fused records through each slab's setup slice, slab
    binning, planar resolve on each slab's window), 2 TAA frames: word
    for word the unsharded frame of the same options."""
    cfg = RasterConfig(**CFG, **opts)
    want, _ = _frames(n_frames=2, cfg=cfg)
    got, r = _frames(cpu_mesh(n), n_frames=2, cfg=cfg)
    np.testing.assert_array_equal(got, want)
    for k, v in opts.items():
        assert getattr(r.config, k) == v


# the options whose compactions are the whole image's, which the sharded
# frame turns off: resolve's (in its config) and TAA's (its fetch options)
RESOLVE_PATHS = ("quad_rate_resolve", "slot_resolve")
TAA_FETCHES = dict(taa_quad_history="quad_history", taa_inwindow="inwindow")


@pytest.mark.parametrize("opts", [dict(quad_rate_resolve=True),
                                  dict(slot_resolve=True),
                                  dict(taa_quad_history=True),
                                  dict(taa_inwindow=True)],
                         ids=["quad", "slot", "taa_quad_history",
                              "taa_inwindow"])
def test_sharded_frame_turns_coherent_paths_off(monkeypatch, opts):
    """Under a mesh the frame resolves without the quad or slot fetch,
    and TAA fetches its history per pixel, as the JAX package's sharded
    frame does (renderer.py:163-175, :217-220): every slab's resolve and TAA see them off, no edge overflow is
    tracked, and the frame is word for word the unsharded one, which
    takes them."""
    from voidin_tpu_torch.passes import resolve as t_resolve
    from voidin_tpu_torch.passes import taa as t_taa

    seen, fetches = [], []
    real, real_taa = t_resolve.resolve_gbuffer, t_taa.taa_resolve

    def spy(scene, vis, config, **kw):
        seen.append((config, kw.get("rows") is not None))
        return real(scene, vis, config, **kw)

    def taa_spy(*args, **kw):
        fetches.append({k: kw.get(k, False) for k in TAA_FETCHES.values()})
        return real_taa(*args, **kw)

    monkeypatch.setattr(t_resolve, "resolve_gbuffer", spy)
    monkeypatch.setattr(t_taa, "taa_resolve", taa_spy)
    cfg = RasterConfig(**CFG, **opts)
    want, r0 = _frames(n_frames=2, cfg=cfg)
    assert seen and all(getattr(c, k) == getattr(cfg, k) for c, _ in seen
                        for k in RESOLVE_PATHS)
    assert fetches == [{v: getattr(cfg, k) for k, v in TAA_FETCHES.items()}]
    seen.clear()
    fetches.clear()
    got, r = _frames(cpu_mesh(4), n_frames=2, cfg=cfg)
    assert len(seen) == 8 and all(slab for _, slab in seen)
    assert not any(getattr(c, k) for c, _ in seen for k in RESOLVE_PATHS)
    assert len(fetches) == 4 and not any(any(f.values()) for f in fetches)
    assert all(getattr(r.config, k) == v for k, v in opts.items())
    np.testing.assert_array_equal(got, want)
    plain, _ = _frames(n_frames=2)
    np.testing.assert_array_equal(want, plain)
