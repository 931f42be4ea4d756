"""Port parity for alpha-masked, textured scenes: kernel K1's track2 twin,
the runner-up raster, resolve's alpha fallback (dense two-pass and lazy
compacted) and the JAX package's alpha semantics on the port. The whole
frame of the foliage scene is held in tests/test_torch_foliage.py.

Scenes: tests/test_raster.py's `_alpha_scene` (a cut-out quad with a
hole, a solid backdrop, a base_color.w = 0.2 ghost; 128x64), and the
foliage scene of chip_smoke.py at 160x96 (`build_world(300)` plus 60
`add_foliage` cards: cut-out albedo, normal map, metallic-roughness and
emissive textures, so every texture tap of resolve is live).

Tolerances are those of tests/test_torch_raster.py, test_torch_shade.py
and test_torch_frame.py: K1 ids agree with the Pallas kernel (interpret) on
>= 99.9% of pixels, depths within 1e-6 where they agree; resolve run op by
op gives a bit-identical GBuffer and material fields within 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import voidin_tpu as vt
from voidin_tpu.ops import fine_raster as j_fr
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster
from voidin_tpu.passes import resolve as j_resolve

import voidin_tpu_torch as pt
from voidin_tpu_torch.core.encoding import as_u32_np
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import raster as t_raster
from voidin_tpu_torch.passes import resolve as t_resolve
from voidin_tpu_torch.passes.gbuffer import VisBuffer

from tests import test_raster
from tests.test_torch_raster import DEPTH_ATOL, MIN_ID_AGREEMENT
from tests.test_torch_scene import port_scene, unpermuted_worlds

torch.set_num_threads(2)
FW, FH = 160, 96  # the foliage scene's frame
N_FIELD, N_CARDS = 300, 60


def _port_cfg(jcfg, **kw):
    return t_raster.RasterConfig(
        width=jcfg.width, height=jcfg.height,
        tri_capacity=jcfg.tri_capacity, pair_capacity=jcfg.pair_capacity,
        **kw)


J_ALPHA = dataclasses.replace(test_raster.CFG, alpha_mask=True)
J_FOLIAGE = j_raster.RasterConfig(width=FW, height=FH, tri_capacity=1 << 15,
                                  pair_capacity=1 << 16, interpret=True)


def _foliage_camera(pkg):
    return pkg.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                      aspect=FW / FH)


def foliage_world(build, opaque=False):
    """The foliage scene on `build`'s World (bench.build_world or the
    port's); `opaque` fills the cut-out's alpha (no alpha mask)."""
    world, moving = build(N_FIELD, seed=0)
    albedo = chip_smoke.add_foliage(world, N_CARDS, seed=1)
    if opaque:
        world.textures.images[albedo][..., 3] = 255
    return world, moving


def _all_draws(n):
    return j_cull.DrawList(instance=jnp.arange(n, dtype=jnp.int32),
                           count=jnp.int32(n))


def _jax_case(name):
    """JAX scene, camera, draws and config of one test scene, rasterized
    with the runner-up (jitted) and binned."""
    with unpermuted_worlds():
        if name == "alpha":
            w, _, _ = test_raster._alpha_scene()
            cfg = J_ALPHA
            js = w.device(tap_blocks=False)
            cam = test_raster._alpha_camera(cfg.width / cfg.height)
            draws = _all_draws(js.instances.count)
        else:
            w, _ = foliage_world(bench.build_world)
            cfg = dataclasses.replace(J_FOLIAGE, alpha_mask=True)
            js = w.device(tap_blocks=False)
            cam = _foliage_camera(vt).uniform()
            draws = j_cull.emit_draws(js.meshes, js.instances, cam)
    assert js.alpha_masked
    vis = jax.jit(functools.partial(j_raster.rasterize, config=cfg))(
        js.meshes, js.instances, draws, cam, materials=js.materials)

    @jax.jit
    def bins(meshes, instances, draws, cam, materials):
        setup = j_raster.triangle_setup(meshes, instances, draws, cam, cfg,
                                        materials=materials)
        return j_raster.bin_triangles_pairs(setup, cfg)

    rec, starts, counts, ovf = bins(js.meshes, js.instances, draws, cam,
                                    js.materials)
    assert int(ovf) == 0 and int(vis.overflow) == 0
    return dict(js=js, ts=port_scene(js), cam=cam, draws=draws, cfg=cfg,
                vis=vis, bins=(np.asarray(rec), np.asarray(starts),
                               np.asarray(counts)))


@pytest.fixture(scope="module")
def cases():
    return {name: _jax_case(name) for name in ("alpha", "foliage")}


def _port_vis(jvis):
    return VisBuffer(
        tri_id=torch.from_numpy(np.array(jvis.tri_id)),
        depth=torch.from_numpy(np.array(jvis.depth)),
        resolve_rec=torch.from_numpy(np.array(jvis.resolve_rec)),
        overflow=torch.tensor(int(jvis.overflow)),
        tri_id2=torch.from_numpy(np.array(jvis.tri_id2)),
        depth2=torch.from_numpy(np.array(jvis.depth2)),
    )


# ---------------------------------------------------------------------------
# K1 track2 and the runner-up raster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["alpha", "foliage"])
def test_track2_twin_vs_pallas(cases, name):
    rec, starts, counts = cases[name]["bins"]
    jouts = j_fr.fine_raster_pairs(
        rec, starts, counts, tiles_x=cases[name]["cfg"].tiles_x,
        tiles_per_step=8, interpret=True, track2=True)
    touts = t_fr.fine_raster_pairs(torch.from_numpy(rec),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(counts), track2=True)
    jd, ji, jd2, ji2 = (np.asarray(a) for a in jouts)
    td, ti, td2, ti2 = (a.numpy() for a in touts)
    agree, agree2 = ji == ti, ji2 == ti2
    print(f"K1 track2 twin vs Pallas (interpret), {name}: flipped id "
          f"{(~agree).sum()} of {agree.size}, id2 {(~agree2).sum()} of "
          f"{agree2.size}")
    assert agree.mean() >= MIN_ID_AGREEMENT
    assert agree2.mean() >= MIN_ID_AGREEMENT
    np.testing.assert_allclose(td[agree], jd[agree], rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(td2[agree2], jd2[agree2], rtol=0,
                               atol=DEPTH_ATOL)
    assert (ti2 >= 0).any()  # runners-up exist
    # the winner is the base variant's, bit for bit
    bd, bi = t_fr.fine_raster_pairs(torch.from_numpy(rec),
                                    torch.from_numpy(starts),
                                    torch.from_numpy(counts))
    np.testing.assert_array_equal(bd.numpy(), td)
    np.testing.assert_array_equal(bi.numpy(), ti)


def test_track2_twin_synthetic_vs_pallas():
    """The grouping cases of tests/test_torch_raster.py's synthetic
    stream (mid-chunk ranges, boundary neighbours, a quad's diagonal tie,
    coplanar duplicates, dead records, an empty tile) plus a NaN-poisoned
    record, through both track2 kernels."""
    from tests.test_torch_raster import _synthetic_records

    rec, starts, counts = _synthetic_records()
    rec = rec.copy()
    rec[starts[2] + 7, 11] = np.nan  # poisons one chunk of tile 2
    jouts = j_fr.fine_raster_pairs(rec, starts, counts, tiles_x=1,
                                   tiles_per_step=8, interpret=True,
                                   track2=True)
    touts = t_fr.fine_raster_pairs(torch.from_numpy(rec),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(counts), track2=True)
    j = [np.asarray(a) for a in jouts]
    t = [a.numpy() for a in touts]
    for d, i in ((0, 1), (2, 3)):
        agree = j[i] == t[i]
        assert agree.mean() >= MIN_ID_AGREEMENT
        np.testing.assert_allclose(t[d][agree], j[d][agree], rtol=0,
                                   atol=DEPTH_ATOL)
    assert np.isnan(rec[:, 11]).sum() == 1
    # the quad tile: its diagonal pixels tie at one depth and collapse,
    # so the runner-up there is never the quad's twin
    quad = 1
    qi, qi2 = touts[1][quad].numpy(), touts[3][quad].numpy()
    assert not np.isin(qi2[qi >= 0], qi[qi >= 0]).any()


@pytest.mark.parametrize("name", ["alpha", "foliage"])
def test_rasterize_track2_matches_jax(cases, name):
    c = cases[name]
    ts, cam = c["ts"], c["cam"]
    cfg = _port_cfg(c["cfg"], alpha_mask=True)
    if name == "alpha":
        n = ts.instances.count
        draws = t_cull.DrawList(instance=torch.arange(n, dtype=torch.int32),
                                count=torch.tensor(n))
    else:
        draws = t_cull.emit_draws(ts.meshes, ts.instances, cam)
    vis = t_raster.rasterize(ts.meshes, ts.instances, draws, cam, cfg,
                             materials=ts.materials)
    jvis = c["vis"]
    assert vis.tri_id2.shape == vis.depth2.shape == vis.tri_id.shape
    assert vis.tri_id2.dtype == torch.int32
    for a, b in ((vis.tri_id, jvis.tri_id), (vis.tri_id2, jvis.tri_id2)):
        assert (a.numpy() == np.asarray(b)).mean() >= MIN_ID_AGREEMENT
    assert int(vis.overflow) == int(jvis.overflow) == 0


# ---------------------------------------------------------------------------
# Resolve: dense two-pass and lazy fallback against JAX, op by op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,lazy,capacity", [
    ("alpha", False, 0), ("alpha", True, 0), ("alpha", True, 8),
    ("foliage", False, 0), ("foliage", True, 0), ("foliage", True, 8),
])
def test_resolve_fallback_matches_jax(cases, name, lazy, capacity):
    c = cases[name]
    jcfg = dataclasses.replace(c["cfg"], lazy_alpha_resolve=lazy,
                               alpha_fallback_capacity=capacity)
    tcfg = _port_cfg(jcfg, alpha_mask=True, lazy_alpha_resolve=lazy,
                     alpha_fallback_capacity=capacity)
    jg, ja = j_resolve.resolve_gbuffer(c["js"], c["vis"], c["cam"], jcfg)
    tg, ta = t_resolve.resolve_gbuffer(c["ts"], _port_vis(c["vis"]), tcfg)
    np.testing.assert_array_equal(np.asarray(jg.normal_uv),
                                  as_u32_np(tg.normal_uv))
    np.testing.assert_array_equal(np.asarray(jg.material),
                                  tg.material.numpy())
    np.testing.assert_array_equal(np.asarray(jg.depth), tg.depth.numpy())
    for field in ("albedo", "emissive", "mr"):
        np.testing.assert_allclose(getattr(ta, field).numpy(),
                                   np.asarray(getattr(ja, field)), rtol=0,
                                   atol=1e-6, err_msg=field)
    if ja.overflow is None:
        assert ta.overflow is None
    else:
        assert int(ta.overflow) == int(ja.overflow)
        assert (int(ta.overflow) > 0) == (capacity == 8)


# ---------------------------------------------------------------------------
# The JAX package's alpha semantics (tests/test_raster.py:295-436), on the
# port's own World and passes
# ---------------------------------------------------------------------------


@pytest.fixture
def port_alpha():
    """_alpha_scene built with the port's World."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vt, "World", functools.partial(pt.World,
                                                  build_bvh=False))
        w, mat_mask, mat_solid = test_raster._alpha_scene()
    scene = w.device("cpu")
    assert scene.alpha_masked
    cfg = _port_cfg(J_ALPHA, alpha_mask=True)
    cam = test_raster._alpha_camera(cfg.width / cfg.height)
    n = scene.instances.count
    draws = t_cull.DrawList(instance=torch.arange(n, dtype=torch.int32),
                            count=torch.tensor(n))

    def run(**kw):
        c = dataclasses.replace(cfg, **kw)
        vis = t_raster.rasterize(scene.meshes, scene.instances, draws, cam,
                                 c, materials=scene.materials)
        return vis, t_resolve.resolve_gbuffer(scene, vis, c)

    return run, mat_mask, mat_solid, cfg


def test_port_cutout_reveals_occluded_geometry(port_alpha):
    run, mat_mask, mat_solid, cfg = port_alpha
    _, (gb, _aux) = run()
    mat, depth = gb.material.numpy(), gb.depth.numpy()
    cy, cx = cfg.height // 2, cfg.width // 2
    assert mat[cy, cx] == mat_solid and depth[cy, cx] > 0.0
    probe = next((cy, cx + dx) for dx in range(cfg.width // 2)
                 if mat[cy, cx + dx] == mat_mask)
    assert depth[probe] > depth[cy, cx]
    assert not (mat == mat_solid + 1).any()  # the ghost never shows


def test_port_quad_diagonal_tie_reveals_backdrop(port_alpha):
    run, _mat_mask, mat_solid, cfg = port_alpha
    vis, (gb, _aux) = run()
    cy, cx = cfg.height // 2, cfg.width // 2
    d1, d2 = float(vis.depth[cy, cx]), float(vis.depth2[cy, cx])
    assert d1 > 0.0 and d2 < d1  # the tie collapsed to the backdrop
    assert int(gb.material[cy, cx]) == mat_solid


def test_port_lazy_fallback_matches_dense(port_alpha):
    run, _mat_mask, _mat_solid, _cfg = port_alpha
    _, (gb_d, aux_d) = run(lazy_alpha_resolve=False)
    _, (gb_l, aux_l) = run(lazy_alpha_resolve=True)
    assert aux_d.overflow is None and int(aux_l.overflow) == 0
    assert int(aux_d.cut) == int(aux_l.cut) == int(aux_l.fallback) > 0
    md, ml = gb_d.material.numpy(), gb_l.material.numpy()
    assert (md == ml).mean() > 0.995
    assert (gb_d.depth.numpy() == gb_l.depth.numpy()).mean() > 0.995
    assert ((md == ml) & (md > 0)).sum() > 100
    close = (np.abs(aux_d.albedo.numpy() - aux_l.albedo.numpy())
             < 1e-6).all(axis=-1)
    assert close.mean() > 0.99


def test_port_fallback_overflow_counter(port_alpha):
    run, _mat_mask, _mat_solid, _cfg = port_alpha
    _, (_gb, aux) = run(alpha_fallback_capacity=8)
    assert int(aux.overflow) > 0
    assert int(aux.fallback) == 8
    assert int(aux.cut) == 8 + int(aux.overflow)
