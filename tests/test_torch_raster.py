"""Port parity: cull, triangle setup, binning and the fine raster
(voidin_tpu_torch.passes.cull / raster, kernel K1's twin) against the JAX
package on the golden 160x96 scene (tests/test_golden.py) and a small
bench.build_world.

The JAX stages run op by op (not jitted): XLA then rounds every multiply
and add separately, as PyTorch does, and the setup/binning streams come out
bit-identical (the tests allow the stated 1 ulp on coefficients). The JAX
fine raster runs its Pallas kernel in interpret mode, which forms the
plane equations as dot products; the twin forms them as separately rounded
((ax*px) + (ay*py)) + b, so pixels whose edge value is ~0 may flip — the
agreement is measured and held to >= 99.9%.
"""

import numpy as np
import pytest
import torch

import bench
import voidin_tpu as vt
from voidin_tpu.ops import fine_raster as j_fr
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import build_world as port_build_world
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import raster as t_raster

from tests.test_golden import CFG, H, W
from tests.test_torch_scene import (deferred_scene,  # noqa: F401
                                    jax_world_unpermuted, port_scene,
                                    unpermuted_worlds)

torch.set_num_threads(2)

T_CFG = t_raster.RasterConfig(width=W, height=H,
                              tri_capacity=CFG.tri_capacity,
                              pair_capacity=CFG.pair_capacity)
MIN_ID_AGREEMENT = 0.999
DEPTH_ATOL = 1e-6


def _ulp_diff(a, b):
    """|a - b| in units of f32 ordering (0 = bit-identical)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def _golden_setup(jax_cfg, port_cfg):
    """Run cull + setup + binning of the golden scene in both packages."""
    with unpermuted_worlds():
        js = deferred_scene(vt).device(tap_blocks=False)
    ts = port_scene(js)
    cam = vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H).uniform()
    out = dict(js=js, ts=ts, cam=cam)
    out["jd"] = j_cull.emit_draws(js.meshes, js.instances, cam)
    out["td"] = t_cull.emit_draws(ts.meshes, ts.instances, cam)
    out["jsetup"] = j_raster.triangle_setup(
        js.meshes, js.instances, out["jd"], cam, jax_cfg,
        materials=js.materials)
    out["tsetup"] = t_raster.triangle_setup(
        ts.meshes, ts.instances, out["td"], cam, port_cfg,
        materials=ts.materials)
    out["jbin"] = j_raster.bin_triangles_pairs(out["jsetup"], jax_cfg)
    out["tbin"] = t_raster.bin_triangles_pairs(out["tsetup"], port_cfg)
    return out


@pytest.fixture(scope="module")
def golden():
    return _golden_setup(CFG, T_CFG)


def test_draw_list_golden_exact(golden):
    jd, td = golden["jd"], golden["td"]
    assert int(jd.count) == int(td.count) == 6
    np.testing.assert_array_equal(np.asarray(jd.instance), td.instance)
    assert jd.mesh is None and td.mesh is None


def test_draw_list_build_world_exact(jax_world_unpermuted):
    jw, _ = bench.build_world(300, seed=0)
    pw, _ = port_build_world(300, seed=0)
    js = jw.device(tap_blocks=False)
    ps = pw.device("cpu")
    cam = pt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                    aspect=320 / 184).uniform()
    jd = j_cull.emit_draws(js.meshes, js.instances, cam)
    td = t_cull.emit_draws(ps.meshes, ps.instances, cam)
    assert int(jd.count) == int(td.count) > 0
    np.testing.assert_array_equal(np.asarray(jd.instance), td.instance)
    np.testing.assert_array_equal(np.asarray(jd.mesh), td.mesh)
    # LOD selection engaged on some draws
    assert (td.mesh[: int(td.count)] != ps.instances.mesh_id[
        td.instance[: int(td.count)].long()]).any()


def test_setup_streams_match(golden):
    js_, ts_ = golden["jsetup"], golden["tsetup"]
    for k in ("raster_rec", "resolve_rec", "sx", "sy", "sz"):
        a, b = np.asarray(js_[k]), ts_[k].numpy()
        assert a.shape == b.shape, k
        assert _ulp_diff(a, b).max() <= 1, k
    np.testing.assert_array_equal(np.asarray(js_["raster_rec"])[:, 12],
                                  ts_["raster_rec"][:, 12].numpy())
    np.testing.assert_array_equal(np.asarray(js_["alive"]),
                                  ts_["alive"].numpy())
    assert int(js_["setup_overflow"]) == int(ts_["setup_overflow"]) == 0


def test_bin_streams_match(golden):
    (jr, js_, jc, jo), (tr, ts_, tc, to) = golden["jbin"], golden["tbin"]
    jr, tr = np.asarray(jr), tr.numpy()
    assert jr.shape == tr.shape
    np.testing.assert_array_equal(jr[:, t_fr.F_ID], tr[:, t_fr.F_ID])
    assert _ulp_diff(jr, tr).max() <= 1
    np.testing.assert_array_equal(np.asarray(js_), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert int(jo) == int(to) == 0
    assert ts_.dtype == tc.dtype == torch.int32


def _compare_k1(rec, starts, counts, nt_step=8):
    jd, ji = j_fr.fine_raster_pairs(rec, starts, counts, tiles_x=1,
                                    tiles_per_step=nt_step, interpret=True)
    td, ti = t_fr.fine_raster_pairs(torch.from_numpy(np.array(rec)),
                                    torch.from_numpy(np.array(starts)),
                                    torch.from_numpy(np.array(counts)))
    jd, ji, td, ti = map(np.asarray, (jd, ji, td, ti))
    agree = ji == ti
    return agree, jd, td


def test_fine_raster_twin_vs_pallas_golden(golden):
    rec, starts, counts, _ = golden["jbin"]
    agree, jd, td = _compare_k1(rec, starts, counts)
    flipped = 1.0 - agree.mean()
    print(f"K1 twin vs Pallas (interpret), golden scene: flipped id "
          f"fraction {flipped:.2e} ({(~agree).sum()} of {agree.size})")
    assert agree.mean() >= MIN_ID_AGREEMENT
    np.testing.assert_allclose(td[agree], jd[agree], rtol=0,
                               atol=DEPTH_ATOL)


def _synthetic_records():
    """Tile-sorted records that exercise the grouping rules: a tile range
    that starts mid-chunk and spans three chunks, neighbours' records in
    the boundary chunks, a quad whose two triangles tie bit-exactly on the
    diagonal, coplanar duplicates (equal depth, different ids), dead
    records and an empty tile."""
    rng = np.random.default_rng(7)
    recs, starts, counts = [], [], []

    def tri(p0, p1, p2, z, tid):
        pts = np.array([p0, p1, p2], np.float32)
        rx, ry = pts[:, 0], pts[:, 1]
        nxt = [1, 2, 0]
        dx, dy = rx[nxt] - rx, ry[nxt] - ry
        ax, ay, b = dy, -dx, ry * dx - rx * dy
        if (dy[0] * dx[1] - dx[0] * dy[1]) < 0:  # keep e >= 0 inside
            ax, ay, b = -ax, -ay, -b
        r = np.zeros(16, np.float32)
        r[0:9] = np.stack([ax, ay, b], -1).reshape(9)
        r[9:12] = [z[0], z[1], z[2]]
        r[12] = tid
        r[15] = max(z[0] * 16 + z[2], z[2]) + 1.0
        return r

    def dead():
        r = np.zeros(16, np.float32)
        r[11] = -1.0
        r[12] = -1.0
        return r

    layout = [("rand", 40), ("quad", 2), ("rand", 300), ("dup", 6),
              ("empty", 0), ("rand", 5), ("dead", 3), ("rand", 130)]
    tid = 0
    for kind, n in layout:
        starts.append(len(recs))
        for k in range(n):
            if kind == "quad":
                # two triangles of one quad share the diagonal at equal depth
                z = (0.0, 0.0, 0.5)
                recs.append(tri((0, 0), (16, 8), (16, 0), z, tid))
                recs.append(tri((0, 0), (0, 8), (16, 8), z, tid + 1))
                tid += 2
                break
            if kind == "dup":
                recs.append(tri((1, 1), (15, 7), (15, 1), (0.0, 0.0, 0.3),
                                tid))
            elif kind == "dead":
                recs.append(dead())
            else:
                p = rng.uniform(-4, 20, (3, 2))
                z = (rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01),
                     rng.uniform(0.05, 0.9))
                recs.append(tri(p[0], p[1], p[2], z, tid))
            tid += 1
        counts.append(len(recs) - starts[-1])
    nt = len(starts)
    nt_pad = -(-nt // 8) * 8
    starts += [len(recs)] * (nt_pad - nt)
    counts += [0] * (nt_pad - nt)
    e = len(recs)
    pad = 2 * 128 - (e % 128 if e % 128 else 128) + 128
    rec = np.concatenate([np.stack(recs), np.zeros((pad, 16), np.float32)])
    return rec, np.asarray(starts, np.int32), np.asarray(counts, np.int32)


def test_fine_raster_twin_vs_pallas_synthetic():
    rec, starts, counts = _synthetic_records()
    agree, jd, td = _compare_k1(rec, starts, counts)
    assert agree.mean() >= MIN_ID_AGREEMENT
    np.testing.assert_allclose(td[agree], jd[agree], rtol=0,
                               atol=DEPTH_ATOL)
    # the coplanar duplicates resolve to the highest id, the empty tile
    # stays clear
    ti = t_fr.fine_raster_pairs(torch.from_numpy(rec),
                                torch.from_numpy(starts),
                                torch.from_numpy(counts))[1].numpy()
    dup_tile = 3
    ids = ti[dup_tile][ti[dup_tile] >= 0]
    last_dup = rec[starts[dup_tile] + counts[dup_tile] - 1, 12]
    assert ids.size and (ids == last_dup).all()
    assert (ti[4] == -1).all()


def test_visbuffer_golden(golden):
    rec, starts, counts, ovf = golden["jbin"]
    jd, ji = j_fr.fine_raster_pairs(
        rec, starts, counts, tiles_x=CFG.tiles_x,
        tiles_per_step=CFG.tiles_per_step, interpret=True)
    jdepth, jtri = j_raster._untile(jd, ji, CFG)
    jtri, jdepth = np.asarray(jtri)[:H, :W], np.asarray(jdepth)[:H, :W]
    ts, cam = golden["ts"], golden["cam"]
    vis = t_raster.rasterize(ts.meshes, ts.instances, golden["td"], cam,
                             T_CFG, materials=ts.materials)
    assert vis.tri_id.shape == (H, W) and vis.tri_id.dtype == torch.int32
    agree = jtri == vis.tri_id.numpy()
    print(f"VisBuffer golden 160x96: flipped id fraction "
          f"{1.0 - agree.mean():.2e}")
    assert agree.mean() >= MIN_ID_AGREEMENT
    np.testing.assert_allclose(vis.depth.numpy()[agree], jdepth[agree],
                               rtol=0, atol=DEPTH_ATOL)
    assert int(vis.overflow) == int(ovf) + int(
        golden["jsetup"]["setup_overflow"]) == 0
    assert (vis.tri_id >= 0).sum() > W * H // 2
