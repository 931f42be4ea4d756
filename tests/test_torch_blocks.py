"""Port parity for the block-binned raster path (RasterConfig.backend =
"xla"): block binning, kernel K2's twin (fine_raster_blocks_reference) and
its track2 variant, rasterize and the whole frame on that path, against
the JAX package.

Edge cases: chip_smoke.block_edge_set's adversarial block sets (K 8 to
768, counts around every group, round and slice boundary and above K, 1 to
2,309 tiles, depth ties across those boundaries, NaN depths, ids -1 inside
the count, a winner in the last valid slot); the card tests and
chip_smoke.py hold the CUDA kernel to the twin on the same sets.

Scenes: tests/test_raster.py's `_scene` (three spheres on a plane, 128x64,
K = 64, the JAX block-path tests' scene; and at K = 16, where tiles
overflow), test_raster.py's `_alpha_scene` (a cut-out quad with a hole
before a backdrop), the golden 160x96 scene and synthetic blocks.

Tolerances: binning bit-identical to the JAX stages run op by op
(blocks, counts, overflow). The twin is exact against fine_raster_xla run
op by op (jax.disable_jit), every output. Against the Pallas kernel
(interpret) the ids are exact and depths within 1e-6 (the K1 tolerance
of tests/test_torch_raster.py; measured: a few ulp): interpret mode
compiles the kernel body, and XLA contracts the depth plane's
multiply-adds into FMAs, which the twin (and the CUDA kernel, built with
-fmad=false) round separately. Frames: sRGB mean abs diff < 5e-3 against
the jitted JAX frame (tests/test_torch_frame.py's budget).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.framework.renderer import Renderer as JaxRenderer
from voidin_tpu.ops import fine_raster as j_fr
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import raster as t_raster
from voidin_tpu_torch.passes import resolve as t_resolve

from chip_smoke import BLOCK_EDGE_SETS, block_edge_set
from tests import test_raster
from tests.test_golden import CFG as GOLDEN_CFG
from tests.test_golden import H, W
from tests.test_torch_raster import DEPTH_ATOL, _synthetic_records, \
    _ulp_diff
from tests.test_torch_scene import (deferred_scene, port_scene,
                                    unpermuted_worlds)

torch.set_num_threads(2)
BUDGET = 5e-3
# the golden scene's fullest tile holds 3,047 records (pair capacity 2^17)
GOLDEN_K = 3072


def _port_cfg(jcfg, **kw):
    return t_raster.RasterConfig(
        width=jcfg.width, height=jcfg.height,
        tri_capacity=jcfg.tri_capacity, pair_capacity=jcfg.pair_capacity,
        tile_tri_capacity=jcfg.tile_tri_capacity, backend=jcfg.backend,
        alpha_mask=jcfg.alpha_mask, **kw)


def _all_draws(pkg_cull, n, tensor):
    return pkg_cull.DrawList(instance=tensor(np.arange(n, dtype=np.int32)),
                             count=tensor(np.int32(n)))


@pytest.fixture(scope="module")
def cases():
    """JAX and port block binning of the block-path scene at its K = 64
    and at K = 16, where tiles overflow; setup and binning run op by op."""
    with unpermuted_worlds():
        js = test_raster._scene().device(tap_blocks=False)
    ts = port_scene(js)
    jcfg = test_raster.CFG
    cam = test_raster._camera(jcfg.width / jcfg.height)
    jd = j_cull.emit_draws(js.meshes, js.instances, cam)
    td = t_cull.emit_draws(ts.meshes, ts.instances, cam)
    jsetup = j_raster.triangle_setup(js.meshes, js.instances, jd, cam, jcfg)
    tsetup = t_raster.triangle_setup(ts.meshes, ts.instances, td, cam,
                                     _port_cfg(jcfg))
    out = {}
    for name, k in (("spheres", jcfg.tile_tri_capacity), ("spheres_k16", 16)):
        c = dataclasses.replace(jcfg, tile_tri_capacity=k)
        out[name] = dict(jcfg=c,
                         jbin=j_raster.bin_triangles(jsetup, c),
                         tbin=t_raster.bin_triangles(tsetup, _port_cfg(c)))
    return out


@pytest.mark.parametrize("name", ["spheres", "spheres_k16"])
def test_bin_triangles_matches_jax(cases, name):
    (jb, jc, jo), (tb, tc, to) = cases[name]["jbin"], cases[name]["tbin"]
    jb, tb = np.asarray(jb), tb.numpy()
    assert jb.shape == tb.shape
    np.testing.assert_array_equal(jb.view(np.int32), tb.view(np.int32))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc.dtype == torch.int32
    assert int(jo) == int(to)
    k = cases[name]["jcfg"].tile_tri_capacity
    print(f"bin_triangles {name}: K {k}, max count {int(tc.max())}, "
          f"overflow {int(to)}")
    if name == "spheres_k16":
        assert int(to) > 0 and int(tc.max()) == k
    else:
        assert int(to) == 0 and int(tc.max()) > 0


@pytest.mark.parametrize("track2", [False, True])
@pytest.mark.parametrize("name", ["spheres", "spheres_k16"])
def test_blocks_twin_matches_xla_op_by_op(cases, name, track2):
    blocks, counts, _ = cases[name]["jbin"]
    with jax.disable_jit():
        want = j_raster.fine_raster_xla(blocks, counts, cases[name]["jcfg"],
                                        track2=track2)
    got = t_fr.fine_raster_blocks(torch.from_numpy(np.array(blocks)),
                                  torch.from_numpy(np.array(counts)),
                                  track2=track2)
    assert len(got) == (4 if track2 else 2)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("name", ["spheres", "spheres_k16"])
def test_blocks_twin_vs_pallas(cases, name):
    blocks, counts, _ = cases[name]["jbin"]
    jd, ji = j_fr.fine_raster_pallas(
        blocks, counts, tiles_x=cases[name]["jcfg"].tiles_x,
        tiles_per_step=8, interpret=True)
    td, ti = t_fr.fine_raster_blocks(torch.from_numpy(np.array(blocks)),
                                     torch.from_numpy(np.array(counts)))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    ulps = _ulp_diff(np.asarray(jd), td.numpy())
    print(f"K2 twin vs Pallas (interpret), {name}: ids identical, depths "
          f"differ at {(ulps > 0).sum()} of {ulps.size} pixels, by at most "
          f"{ulps.max()} ulp")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=DEPTH_ATOL)


def _diagonal_quad(tid):
    """Records of an 8x8 quad split along its diagonal (0,0)-(8,8), at one
    constant depth: the pixel centres (k + 0.5, k + 0.5) lie on the shared
    edge, where both triangles' edge value is exactly 0 (a depth tie)."""
    def tri(pts, tid):
        p = np.asarray(pts, np.float32)
        nxt = [1, 2, 0]
        dx, dy = p[nxt, 0] - p[:, 0], p[nxt, 1] - p[:, 1]
        ax, ay, b = dy, -dx, p[:, 1] * dx - p[:, 0] * dy
        if (dy[0] * dx[1] - dx[0] * dy[1]) < 0:  # keep e >= 0 inside
            ax, ay, b = -ax, -ay, -b
        r = np.zeros(16, np.float32)
        r[0:9] = np.stack([ax, ay, b], -1).reshape(9)
        r[11], r[12], r[15] = 0.5, tid, 1.0
        return r

    return np.stack([tri([(0, 0), (8, 8), (8, 0)], tid),
                     tri([(0, 0), (0, 8), (8, 8)], tid + 1)])


def _synthetic_blocks(k_cap=256):
    """Per-tile blocks from tests/test_torch_raster.py's synthetic stream
    (tiles 0-7: a 300-record tile capped at K, coplanar duplicates, an
    empty tile, dead records) with tile 1 replaced by a diagonal quad (a
    tie inside one group), plus three tiles: 8, the quad's halves in
    groups 0 and 1 behind seven dead records (a tie across groups); 9, the
    quad and a nearer copy of it with id -1 (must never win); 10, a
    record with a NaN depth coefficient (poisons its group). Returns
    (blocks, uncapped counts, the quad's two ids)."""
    rec, starts, counts = _synthetic_records()
    tiles = [rec[s: s + c] for s, c in zip(starts, counts)]
    quad = _diagonal_quad(1000)
    tiles[1] = quad
    across = np.concatenate([np.repeat(tiles[6][:1], 7, axis=0), quad])
    ghost = quad.copy()
    ghost[:, 12] = -1.0
    ghost[:, 11] += 0.25
    ghost[:, 15] += 0.25
    nan = tiles[0][:20].copy()
    nan[9, 11] = np.nan
    tiles = tiles[:8] + [across, np.concatenate([quad, ghost]), nan]
    nt = -(-len(tiles) // 8) * 8
    blocks = np.zeros((nt, k_cap, 16), np.float32)
    blocks[:, :, 12] = -1.0
    cnt = np.zeros(nt, np.int32)
    for t, r in enumerate(tiles):
        n = min(len(r), k_cap)
        blocks[t, :n] = r[:n]
        cnt[t] = len(r)
    return blocks, cnt, quad[:, 12]


@pytest.mark.parametrize("track2", [False, True])
def test_blocks_twin_synthetic(track2):
    blocks, counts, (qa, qb) = _synthetic_blocks()
    assert counts.max() > blocks.shape[1]  # one tile overflows K
    with jax.disable_jit():
        want = j_raster.fine_raster_xla(
            jnp.asarray(blocks), jnp.asarray(np.minimum(counts, 256)),
            test_raster.CFG, track2=track2)
    got = t_fr.fine_raster_blocks(torch.from_numpy(blocks),
                                  torch.from_numpy(counts), track2=track2)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    d, ids = got[0].numpy(), got[1].numpy()
    assert (ids[0] >= 0).any() and (ids[4] == -1).all()  # the empty tile
    # the diagonal: inside one group the higher id wins the tie, across
    # groups the earlier group's half keeps it
    differ = ids[1] != ids[8]
    assert differ.sum() == 8 and (ids[1][differ] == qb).all() \
        and (ids[8][differ] == qa).all()
    # the id -1 copy in front never wins
    np.testing.assert_array_equal(ids[9], ids[1])
    np.testing.assert_array_equal(d[9], d[1])
    if track2:
        # the quad's ties collapse: its runner-up is never its own twin
        for t in (1, 8):
            r2 = got[3][t].numpy()
            assert not np.isin(r2[ids[t] >= 0], [qa, qb]).any()


def _alpha_case(backend, alpha_mask):
    """tests/test_raster.py's alpha scene through both packages' rasterize
    (JAX op by op) on `backend`."""
    with unpermuted_worlds():
        w, mat_mask, mat_solid = test_raster._alpha_scene()
        js = w.device(tap_blocks=False)
    ts = port_scene(js)
    jcfg = dataclasses.replace(test_raster.CFG, backend=backend,
                               alpha_mask=alpha_mask)
    cam = test_raster._alpha_camera(jcfg.width / jcfg.height)
    n = js.instances.count
    with jax.disable_jit():
        jvis = j_raster.rasterize(js.meshes, js.instances,
                                  _all_draws(j_cull, n, jnp.asarray), cam,
                                  jcfg, materials=js.materials)
    tvis = t_raster.rasterize(ts.meshes, ts.instances,
                              _all_draws(t_cull, n, torch.as_tensor), cam,
                              _port_cfg(jcfg), materials=ts.materials)
    return jvis, tvis, ts, mat_solid, _port_cfg(jcfg)


@pytest.mark.parametrize("alpha_mask", [False, True])
def test_rasterize_block_path_matches_jax(alpha_mask):
    jvis, tvis, _, _, _ = _alpha_case("xla", alpha_mask)
    pairs = [(jvis.tri_id, tvis.tri_id), (jvis.depth, tvis.depth)]
    if alpha_mask:
        pairs += [(jvis.tri_id2, tvis.tri_id2), (jvis.depth2, tvis.depth2)]
    else:
        assert tvis.tri_id2 is None
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tvis.tri_id.dtype == torch.int32
    assert int(jvis.overflow) == int(tvis.overflow) == 0
    assert (tvis.tri_id >= 0).float().mean() > 0.3


def test_block_path_diagonal_tie_reveals_backdrop():
    """tests/test_raster.py:403-436 on the port's block path: at the
    quad's diagonal the winner and its twin tie, the runner-up collapses
    to the backdrop behind the quad, and resolve shows the backdrop."""
    _, vis, ts, mat_solid, cfg = _alpha_case("xla", True)
    cy, cx = cfg.height // 2, cfg.width // 2
    d1, d2 = float(vis.depth[cy, cx]), float(vis.depth2[cy, cx])
    assert d1 > 0.0 and d2 < d1
    gb, _aux = t_resolve.resolve_gbuffer(ts, vis, cfg)
    assert int(gb.material[cy, cx]) == mat_solid


def test_block_path_depth_equals_pair_path():
    """Both paths take the max of the same baked planes: the VisBuffer
    depth is bit-identical; ids differ only where depths tie, on a few
    pixels (the quad diagonals)."""
    scene = deferred_scene(pt).device("cpu")
    cam = pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H).uniform()
    draws = t_cull.emit_draws(scene.meshes, scene.instances, cam)
    base = t_raster.RasterConfig(width=W, height=H, tri_capacity=1 << 16,
                                 pair_capacity=1 << 17,
                                 tile_tri_capacity=GOLDEN_K)
    vis = {b: t_raster.rasterize(scene.meshes, scene.instances, draws, cam,
                                 dataclasses.replace(base, backend=b),
                                 materials=scene.materials)
           for b in ("pallas", "xla")}
    np.testing.assert_array_equal(vis["pallas"].depth.numpy(),
                                  vis["xla"].depth.numpy())
    assert int(vis["pallas"].overflow) == int(vis["xla"].overflow) == 0
    differ = vis["pallas"].tri_id != vis["xla"].tri_id
    print(f"pair vs block path: ids differ at {int(differ.sum())} of "
          f"{differ.numel()} pixels")
    assert float(differ.float().mean()) < 0.01
    assert (vis["xla"].depth[differ] > 0).all()


def test_block_path_frame_matches_jax():
    """The golden deferred scene through both Renderers on the block path
    (the JAX frame jitted, Pallas-free), one frame without TAA."""
    with unpermuted_worlds():
        js = deferred_scene(vt).device(tap_blocks=False)
    jcfg = dataclasses.replace(GOLDEN_CFG, backend="xla",
                               tile_tri_capacity=GOLDEN_K)
    want = np.asarray(JaxRenderer(js, jcfg, enable_taa=False).render(
        vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)))
    r = Renderer(port_scene(js), _port_cfg(jcfg), enable_taa=False)
    got = r.render(pt.Camera(position=[0, 2, 0], pitch=-18.0,
                             aspect=W / H)).numpy()
    assert int(r.aux["overflow"]) == 0
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    diff = np.abs(got - want).mean()
    print(f"block-path golden frame: mean abs diff vs JAX {diff:.3e}")
    assert diff < BUDGET


def _edge_outputs(name, track2):
    blocks, counts = block_edge_set(name)
    outs = t_fr.fine_raster_blocks(torch.from_numpy(blocks),
                                   torch.from_numpy(counts), track2=track2)
    return blocks, counts, [o.numpy() for o in outs]


@pytest.mark.parametrize("track2", [False, True])
@pytest.mark.parametrize("name", BLOCK_EDGE_SETS)
def test_blocks_twin_edge_sets_match_xla(name, track2):
    """The twin on the adversarial block sets against fine_raster_xla run
    op by op: every output word equal."""
    blocks, counts, got = _edge_outputs(name, track2)
    with jax.disable_jit():
        want = j_raster.fine_raster_xla(
            jnp.asarray(blocks),
            jnp.asarray(np.minimum(counts, blocks.shape[1])),
            test_raster.CFG, track2=track2)
    assert len(got) == len(want) == (4 if track2 else 2)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.view(np.int32))


@pytest.mark.parametrize("name", [n for n in BLOCK_EDGE_SETS
                                  if n[0] == "k" or n == "nt8_k16"])
def test_blocks_twin_edge_sets_vs_pallas(name):
    """The sets whose tile count the Pallas kernel takes (a multiple of its
    8 tiles a step), in interpret mode: ids exact, depths within
    DEPTH_ATOL (every plane of these sets is exact in f32, fused or
    not)."""
    blocks, counts, (td, ti) = _edge_outputs(name, False)
    assert blocks.shape[0] % 8 == 0
    jd, ji = j_fr.fine_raster_pallas(jnp.asarray(blocks), jnp.asarray(counts),
                                     tiles_x=8, tiles_per_step=8,
                                     interpret=True)
    np.testing.assert_array_equal(np.asarray(ji), ti)
    np.testing.assert_allclose(td, np.asarray(jd), rtol=0, atol=DEPTH_ATOL)


def test_block_edge_sets_hold_their_cases():
    """What the adversarial sets are built to show, read off the twin's
    outputs on the K = 136 set: the slots past the count never win, a tie
    across a group, round or slice boundary keeps the earlier record, a
    NaN poisons its own group and no other, and a last valid slot can win."""
    blocks, counts, (d, ids, d2, ids2) = _edge_outputs("k136", True)
    k = blocks.shape[1]
    assert counts.max() > k and (counts == 0).any()
    short = np.minimum(counts, k) < k
    assert (d[short] < 0.999).all() and (d2[short] < 0.999).all()
    # tile 8 (135 records, ties at slots (7, 8), (31, 32), (127, 128)): the
    # earliest of the equal records keeps every pixel, and the runner-up
    # is none of the tied ones
    tied = blocks[8, [7, 8, 31, 32, 127, 128], 12]
    assert blocks[8, 8, 12] > blocks[8, 7, 12]
    assert (ids[8] == tied[0]).all() and (d[8] == np.float32(0.985)).all()
    assert not np.isin(ids2[8], tied).any() and (d2[8] < d[8]).all()
    # tile 2 (7 records) and tile 4 (9 records): only tile 4 holds slot 8
    assert (ids[4] == blocks[4, 7, 12]).all()
    # tile 9 (136 records): NaN depths at slots 3, 121 and 130 take groups
    # 0, 15 and 16 out, the winning last slot in group 16 with them
    poisoned = np.r_[0:8, 120:136]
    assert np.isnan(blocks[9, [3, 121, 130], 11]).all()
    assert blocks[9, k - 1, 11] == np.float32(0.99)
    assert not np.isin(ids[9][ids[9] >= 0], blocks[9, poisoned, 12]).any()
    assert (ids[9] >= 0).any() and (d[9] < 0.95).all()
    # tile 7 (129 records): its last valid slot wins every pixel
    assert (ids[7] == blocks[7, 128, 12]).all()
    assert (d[7] == np.float32(0.99)).all()
    # tile 0 has no record
    assert (ids[0] == -1).all() and (d[0] == 0).all()
