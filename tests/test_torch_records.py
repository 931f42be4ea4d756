"""Port parity for the JAX package's record layouts: the f16 instance
record (RasterConfig.inst_rec_f16), the fused resolve records
(fused_resolve_rec, fused_inst_rec), their threading through the
Renderer, and the binning options sort_payload and two_stream_bin=False.

Scenes (tests/test_resolve_quad.py, tests/test_raster.py, 128x64): the
textured spheres on a ground plane, the same with a normal-mapped sphere,
the alpha-masked cut-out scene, and test_raster.py's three spheres; each
built in input order by both packages (unpermuted_worlds), the port's a
copy of the JAX scene (port_scene).

Both packages resolve the same VisBuffer, the port's raster of the scene,
the JAX side op by op. Tolerances: G-buffer words (normal_uv, material,
depth) equal, the material fields within 1e-6
(tests/test_torch_payload.py), ResolveAux.overflow equal. Records: the
u32 and f16 words equal, the clip columns within the 1 ulp of
tests/test_torch_raster.py's setup streams. Each option is also held
against the port's default path as the JAX package's own test holds it
(tests/test_raster.py:207-254, :461-568).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.core import mathx
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster
from voidin_tpu.passes import resolve as j_resolve
from voidin_tpu.passes.gbuffer import VisBuffer as JaxVisBuffer

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import encoding
from voidin_tpu_torch.core.encoding import as_u32_np
from voidin_tpu_torch.framework import renderer as t_renderer
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import raster as t_raster
from voidin_tpu_torch.passes import resolve as t_resolve

from tests import test_raster, test_resolve_quad
from tests.test_torch_raster import _ulp_diff
from tests.test_torch_scene import port_scene, unpermuted_worlds

torch.set_num_threads(2)
J_CFG = test_resolve_quad.CFG  # 128x64, 2^13 / 2^14, interpret
AUX_ATOL = 1e-6
F16_ALBEDO = 1e-2  # tests/test_raster.py:560-562
F16_NORMAL = 2e-2  # tests/test_raster.py:563-569


def port_cfg(jcfg=J_CFG, **kw):
    """The port's RasterConfig of a JAX one (its sizes) plus `kw`."""
    sizes = dict(width=jcfg.width, height=jcfg.height,
                 tri_capacity=jcfg.tri_capacity,
                 pair_capacity=jcfg.pair_capacity,
                 tile_tri_capacity=jcfg.tile_tri_capacity)
    return t_raster.RasterConfig(**{**sizes, **kw})


def normal_mapped_world():
    """tests/test_resolve_slot.py:112-128: the textured scene plus a
    sphere with a normal map."""
    w = test_resolve_quad._textured_scene()
    rng = np.random.default_rng(3)
    nrm = rng.integers(100, 156, (32, 32, 3)).astype(np.uint8)
    nrm[..., 2] = 255
    tn = w.textures.add(nrm, srgb=False)
    m = w.materials.add(albedo=1, normal=tn)
    w.instances.add(np.asarray(mathx.from_translation([0.0, 0.3, -3.0])),
                    vt.mesh.SPHERE_1_MESH, m)
    return w


def _all_draws(pkg, n):
    if pkg == "jax":
        return j_cull.DrawList(instance=jnp.arange(n, dtype=jnp.int32),
                               count=jnp.int32(n))
    return t_cull.DrawList(instance=torch.arange(n, dtype=torch.int32),
                           count=torch.tensor(n))


def make_case(name):
    """JAX and port scenes, uniform camera and both packages' draws of one
    test scene: "textured", "nmap", "alpha" or "spheres"."""
    with unpermuted_worlds():
        if name == "alpha":
            w = test_raster._alpha_scene()[0]
        elif name == "nmap":
            w = normal_mapped_world()
        elif name == "spheres":
            w = test_raster._scene()
        else:
            w = test_resolve_quad._textured_scene()
        js = w.device(tap_blocks=False)
    ts = port_scene(js)
    aspect = J_CFG.width / J_CFG.height
    if name == "alpha":
        cam = test_raster._alpha_camera(aspect)
        jd = _all_draws("jax", js.instances.count)
        td = _all_draws("port", ts.instances.count)
    else:
        cam = test_resolve_quad._camera(aspect)
        jd = j_cull.emit_draws(js.meshes, js.instances, cam)
        td = t_cull.emit_draws(ts.meshes, ts.instances, cam)
    return dict(name=name, js=js, ts=ts, cam=cam, jd=jd, td=td,
                alpha=js.alpha_masked, vis={})


@pytest.fixture(scope="module")
def cases():
    return {}


def case_of(cases, name):
    if name not in cases:
        cases[name] = make_case(name)
    return cases[name]


def layout(opts):
    """The record options of `opts` (those that change the VisBuffer)."""
    keys = ("fused_resolve_rec", "inst_rec_f16", "fused_inst_rec",
            "slim_rec")
    return {k: v for k, v in opts.items() if k in keys and v}


def port_vis(c, **opts):
    """The port's VisBuffer of case `c` under the record options of
    `opts` (cached per layout), the f16 instance record threaded as the
    Renderer threads it."""
    lay = layout(opts)
    key = tuple(sorted(lay))
    if key not in c["vis"]:
        ts = c["ts"]
        cfg = port_cfg(alpha_mask=c["alpha"], **lay)
        c["vis"][key] = t_raster.rasterize(
            ts.meshes, ts.instances, c["td"], c["cam"], cfg,
            materials=ts.materials,
            inst_rec=t_renderer.frame_inst_rec(ts, cfg))
    return c["vis"][key]


def jax_vis(vis):
    """The JAX package's VisBuffer holding the port's."""
    def a(t):
        return None if t is None else jnp.asarray(t.numpy())

    return JaxVisBuffer(tri_id=a(vis.tri_id), depth=a(vis.depth),
                        resolve_rec=a(vis.resolve_rec),
                        overflow=jnp.int32(int(vis.overflow)),
                        tri_id2=a(vis.tri_id2), depth2=a(vis.depth2))


def resolve_both(c, **opts):
    """Both packages' resolve of case `c`'s VisBuffer under `opts`: ((JAX
    GBuffer, aux), (port GBuffer, aux)); JAX op by op."""
    vis = port_vis(c, **opts)
    jcfg = dataclasses.replace(J_CFG, alpha_mask=c["alpha"], **opts)
    tcfg = port_cfg(alpha_mask=c["alpha"], **opts)
    j = j_resolve.resolve_gbuffer(c["js"], jax_vis(vis), c["cam"], jcfg)
    t = t_resolve.resolve_gbuffer(c["ts"], vis, tcfg)
    return j, t


def resolve_port(c, **opts):
    """The port's resolve of case `c` under `opts`."""
    return t_resolve.resolve_gbuffer(
        c["ts"], port_vis(c, **opts), port_cfg(alpha_mask=c["alpha"],
                                               **opts))


def _words(x):
    return np.asarray(x).view(np.int32)


def assert_gbuffer_words(jg, tg):
    np.testing.assert_array_equal(np.asarray(jg.normal_uv),
                                  as_u32_np(tg.normal_uv))
    np.testing.assert_array_equal(np.asarray(jg.material),
                                  tg.material.numpy())
    np.testing.assert_array_equal(_words(jg.depth), _words(tg.depth))


def assert_matches_jax(j, t, aux_atol=AUX_ATOL):
    """G-buffer words equal, aux within `aux_atol`, overflow equal."""
    (jg, ja), (tg, ta) = j, t
    assert_gbuffer_words(jg, tg)
    for field in ("albedo", "emissive", "mr"):
        np.testing.assert_allclose(getattr(ta, field).numpy(),
                                   np.asarray(getattr(ja, field)), rtol=0,
                                   atol=aux_atol, err_msg=field)
    if ja.overflow is None:
        assert ta.overflow is None
    else:
        assert int(ta.overflow) == int(ja.overflow)
    assert (tg.material.numpy() > 0).any() or (tg.depth > 0).any()


def assert_same_words(a, b, fields=("albedo", "emissive", "mr")):
    """Two port resolves: G-buffer and the named aux fields word for
    word."""
    (ga, aa), (gb, ab) = a, b
    for name in ("normal_uv", "material", "depth"):
        np.testing.assert_array_equal(_words(getattr(ga, name).numpy()),
                                      _words(getattr(gb, name).numpy()),
                                      err_msg=name)
    for name in fields:
        np.testing.assert_array_equal(_words(getattr(aa, name).numpy()),
                                      _words(getattr(ab, name).numpy()),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# The f16 instance record
# ---------------------------------------------------------------------------


def test_inst_rec_f16_refuses_ids_beyond_f16(cases):
    """More than 2,048 materials or textures: the JAX package's
    ValueError, message and all."""
    for n_mats, n_tex in ((2049, 4), (8, 2049)):
        fake = types.SimpleNamespace(
            materials=types.SimpleNamespace(albedo=np.zeros(n_mats)),
            textures=types.SimpleNamespace(size=np.zeros((n_tex, 2))))
        with pytest.raises(ValueError) as want:
            j_resolve._inst_rec_f16(fake)
        with pytest.raises(ValueError) as got:
            t_resolve._inst_rec_f16(fake)
        assert str(got.value) == str(want.value)
        assert "disable RasterConfig.inst_rec_f16" in str(got.value)


@pytest.mark.parametrize("name", ["textured", "nmap", "alpha"])
def test_inst_rec_f16_resolve_matches_jax(cases, name):
    assert_matches_jax(*resolve_both(case_of(cases, name),
                                     inst_rec_f16=True))


@pytest.mark.parametrize("name", ["textured", "nmap"])
def test_inst_rec_f16_close_to_f32(cases, name):
    """tests/test_raster.py:533-569 on the port: material and depth exact,
    albedo within 1e-2, decoded normals within 2e-2, packed uv exact."""
    c = case_of(cases, name)
    gb_d, aux_d = resolve_port(c)
    gb_h, aux_h = resolve_port(c, inst_rec_f16=True)
    np.testing.assert_array_equal(gb_d.material.numpy(),
                                  gb_h.material.numpy())
    np.testing.assert_array_equal(gb_d.depth.numpy(), gb_h.depth.numpy())
    da = (aux_d.albedo - aux_h.albedo).abs().max().item()
    assert da < F16_ALBEDO, da
    n_d = encoding.decode_octahedral_32(gb_d.normal_uv[..., 0])
    n_h = encoding.decode_octahedral_32(gb_h.normal_uv[..., 0])
    assert (n_d - n_h).abs().max().item() < F16_NORMAL
    np.testing.assert_array_equal(gb_d.normal_uv[..., 1].numpy(),
                                  gb_h.normal_uv[..., 1].numpy())


# ---------------------------------------------------------------------------
# Fused resolve records: setup and resolve
# ---------------------------------------------------------------------------


FUSED = dict(fused_resolve_rec=True)
FUSED_F16 = dict(fused_resolve_rec=True, inst_rec_f16=True)
FUSED_INST = dict(fused_resolve_rec=True, inst_rec_f16=True,
                  fused_inst_rec=True)


def _setups(c, opts):
    """Both packages' triangle_setup of case `c` under `opts` (JAX op by
    op), the f16 instance record threaded where fused_inst_rec asks."""
    js, ts = c["js"], c["ts"]
    fused_inst = opts.get("fused_inst_rec", False)
    jcfg = dataclasses.replace(J_CFG, **opts)
    tcfg = port_cfg(**opts)
    jsetup = j_raster.triangle_setup(
        js.meshes, js.instances, c["jd"], c["cam"], jcfg,
        materials=js.materials,
        inst_rec=j_resolve._inst_rec_f16(js) if fused_inst else None)
    tsetup = t_raster.triangle_setup(
        ts.meshes, ts.instances, c["td"], c["cam"], tcfg,
        materials=ts.materials,
        inst_rec=t_resolve._inst_rec_f16(ts) if fused_inst else None)
    return jsetup, tsetup


@pytest.mark.parametrize("opts,cols", [(FUSED, 24), (FUSED_INST, 36)],
                         ids=["fused", "fused_inst"])
def test_fused_records_match_jax(cases, opts, cols):
    """The resolve record of fused_resolve_rec (24 columns) and
    fused_inst_rec (36): the ids and every carried u32 / f16 word equal
    to the JAX package's, the clip columns within 1 ulp; the raster
    records as without the option."""
    c = case_of(cases, "nmap")
    jsetup, tsetup = _setups(c, opts)
    jrec, trec = np.asarray(jsetup["resolve_rec"]), tsetup["resolve_rec"]
    assert trec.shape == jrec.shape and trec.shape[1] == cols
    np.testing.assert_array_equal(_words(jrec[:, 9:]), _words(trec[:, 9:]))
    assert _ulp_diff(jrec[:, :9], trec[:, :9].numpy()).max() <= 1
    plain = t_raster.triangle_setup(
        c["ts"].meshes, c["ts"].instances, c["td"], c["cam"], port_cfg(),
        materials=c["ts"].materials)
    np.testing.assert_array_equal(_words(plain["raster_rec"]),
                                  _words(tsetup["raster_rec"]))
    np.testing.assert_array_equal(_words(plain["resolve_rec"]),
                                  _words(trec[:, :12]))


def test_fused_records_copy_every_word(cases):
    """Columns that carry u32 / f16 words as f32 come through setup, the
    extras' compaction and concatenation unchanged, NaN and infinity
    bit patterns included: held on a pool whose corner-attribute rows and
    instance record hold such words."""
    c = case_of(cases, "textured")
    ts = c["ts"]
    nan_words = torch.tensor([0x7FA00001, 0x7FC00000, -0x400000,
                              0x7F800000, -0x800000, 0x7F800001],
                             dtype=torch.int32)  # sNaN, qNaN, -qNaN, +-inf
    attr = ts.meshes.tri_attr_packed.clone()
    attr[:, 6:12] = nan_words
    meshes = dataclasses.replace(ts.meshes, tri_attr_packed=attr)
    inst_rec = t_resolve._inst_rec_f16(ts).clone()
    inst_rec[:, 2:8] = nan_words
    cfg = port_cfg(**FUSED_INST)
    setup = t_raster.triangle_setup(meshes, ts.instances, c["td"], c["cam"],
                                    cfg, materials=ts.materials,
                                    inst_rec=inst_rec)
    rec = setup["resolve_rec"].view(torch.int32)
    live = setup["alive"]
    assert live.sum() > 50
    tri_pool = (setup["resolve_rec"][:, 10] / 3.0).to(torch.int64)
    inst = setup["resolve_rec"][:, 9].to(torch.int64)
    np.testing.assert_array_equal(rec[live, 12:24].numpy(),
                                  attr[tri_pool[live]].numpy())
    np.testing.assert_array_equal(rec[live, 24:36].numpy(),
                                  inst_rec[inst[live]].numpy())


@pytest.mark.parametrize("opts", [FUSED, FUSED_F16, FUSED_INST],
                         ids=["fused", "fused_f16", "fused_inst"])
@pytest.mark.parametrize("name", ["textured", "nmap"])
def test_fused_resolve_matches_jax(cases, name, opts):
    assert_matches_jax(*resolve_both(case_of(cases, name), **opts))


def test_fused_resolve_matches_jax_alpha(cases):
    """The alpha-masked scene through the lazy fallback with the fused
    f16 records."""
    assert_matches_jax(*resolve_both(case_of(cases, "alpha"), **FUSED_INST))


@pytest.mark.parametrize("name", ["textured", "nmap"])
def test_fused_resolve_rec_matches_default(cases, name):
    """tests/test_raster.py:461: fused_resolve_rec gives the default
    path's words (it moves only where the corner row is fetched)."""
    c = case_of(cases, name)
    assert_same_words(resolve_port(c), resolve_port(c, **FUSED))


@pytest.mark.parametrize("name", ["textured", "nmap", "alpha"])
def test_fused_inst_rec_matches_inst_f16(cases, name):
    """tests/test_raster.py:489: fused_inst_rec gives inst_rec_f16's words
    (the same record words, carried by the resolve record)."""
    c = case_of(cases, name)
    assert port_vis(c, **FUSED_INST).resolve_rec.shape[-1] == 36
    assert_same_words(resolve_port(c, inst_rec_f16=True),
                      resolve_port(c, **FUSED_INST))


def test_fused_inst_rec_needs_fused_record_and_f16(cases):
    """The Renderer's frame refuses fused_inst_rec without
    fused_resolve_rec + inst_rec_f16 with the JAX package's ValueError."""
    c = case_of(cases, "textured")
    for opts in (dict(fused_inst_rec=True),
                 dict(fused_inst_rec=True, inst_rec_f16=True),
                 dict(fused_inst_rec=True, fused_resolve_rec=True)):
        r = t_renderer.Renderer(c["ts"], port_cfg(**opts), enable_taa=False)
        with pytest.raises(ValueError,
                           match="fused_inst_rec requires fused_resolve_rec "
                                 r"\+ inst_rec_f16"):
            r.render(pt.Camera(position=[0.0, 0.5, 2.0], pitch=-10.0,
                               aspect=2.0))


# ---------------------------------------------------------------------------
# Binning: sort_payload and the single stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spheres(cases):
    """test_raster.py's three spheres: both packages' setups (JAX op by
    op) and the port's default bins."""
    c = case_of(cases, "spheres")
    c["setups"] = _setups(c, {})
    c["default_bins"] = t_raster.bin_triangles_pairs(c["setups"][1],
                                                    port_cfg())
    return c


BIN_OPTIONS = {
    "sort_payload": dict(sort_payload=True),
    "single": dict(two_stream_bin=False),
}


@pytest.mark.parametrize("opt", sorted(BIN_OPTIONS))
def test_bin_options_match_jax(spheres, opt):
    """The JAX package's binning under the same option (op by op): the
    records in the same order (ids equal, coefficients within the 1 ulp
    of tests/test_torch_raster.py), the same tile ranges and overflow."""
    opts = BIN_OPTIONS[opt]
    jsetup, tsetup = spheres["setups"]
    jr, js_, jc, jo = j_raster.bin_triangles_pairs(
        jsetup, dataclasses.replace(J_CFG, **opts))
    tr, ts_, tc, to = t_raster.bin_triangles_pairs(tsetup,
                                                   port_cfg(**opts))
    jr, tr = np.asarray(jr), tr.numpy()
    assert jr.shape == tr.shape
    np.testing.assert_array_equal(jr[:, t_fr.F_ID], tr[:, t_fr.F_ID])
    assert _ulp_diff(jr, tr).max() <= 1
    np.testing.assert_array_equal(np.asarray(js_), ts_.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert int(jo) == int(to) == 0


def test_sort_payload_gives_the_default_records(spheres):
    """sort_payload: every record word of the bins without it, in the
    same order, on either binning (F_ZMAX included: the JAX package's
    sort that drops it blanks the frame)."""
    setup = spheres["setups"][1]
    for two_stream in (True, False):
        want = t_raster.bin_triangles_pairs(
            setup, port_cfg(two_stream_bin=two_stream))
        got = t_raster.bin_triangles_pairs(
            setup, port_cfg(two_stream_bin=two_stream, sort_payload=True))
        for a, b in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(_words(a.numpy()),
                                          _words(b.numpy()))
        assert int(want[3]) == int(got[3]) == 0


def _vis_of(c, cfg):
    ts = c["ts"]
    return t_raster.rasterize(ts.meshes, ts.instances, c["td"], c["cam"],
                              cfg)


@pytest.mark.parametrize("opt", sorted(BIN_OPTIONS))
def test_bin_options_match_default_path(spheres, opt):
    """tests/test_raster.py:207 and :230 on the port: the frame's
    VisBuffer equals the default path's and is not blank."""
    vis_d = _vis_of(spheres, port_cfg())
    vis_o = _vis_of(spheres, port_cfg(**BIN_OPTIONS[opt]))
    assert (vis_o.tri_id >= 0).sum() > 500
    np.testing.assert_array_equal(_words(vis_o.depth.numpy()),
                                  _words(vis_d.depth.numpy()))
    np.testing.assert_array_equal(vis_o.tri_id.numpy(), vis_d.tri_id.numpy())
    assert int(vis_o.overflow) == 0


def test_single_stream_orders_a_tile_by_triangle(spheres):
    """The single stream keeps each tile's records in triangle order; two
    streams put the records of the triangles whose first tile it is
    first. The same records either way, in another order in some tiles:
    that order decides K1's ties between chunks (ROADMAP.md §3)."""
    rec_d, st_d, cnt_d, _ = spheres["default_bins"]
    rec_s, st_s, cnt_s, _ = t_raster.bin_triangles_pairs(
        spheres["setups"][1], port_cfg(two_stream_bin=False))
    np.testing.assert_array_equal(cnt_d.numpy(), cnt_s.numpy())
    reordered = 0
    for t in torch.nonzero(cnt_s > 1).flatten().tolist():
        ids_s = rec_s[st_s[t]:st_s[t] + cnt_s[t], t_fr.F_ID]
        ids_d = rec_d[st_d[t]:st_d[t] + cnt_d[t], t_fr.F_ID]
        assert (torch.diff(ids_s) > 0).all()
        np.testing.assert_array_equal(np.sort(ids_d.numpy()),
                                      ids_s.numpy())
        reordered += int(not torch.equal(ids_s, ids_d))
    assert reordered > 0


@pytest.mark.parametrize("two_stream", [True, False])
def test_bin_overflow_matches_jax(spheres, two_stream):
    """A pair capacity below the frame's pairs: the overflow of each
    binning counted as the JAX package counts it."""
    jsetup, tsetup = spheres["setups"]
    opts = dict(pair_capacity=128, two_stream_bin=two_stream)
    *_, jo = j_raster.bin_triangles_pairs(
        jsetup, dataclasses.replace(J_CFG, **opts))
    *_, to = t_raster.bin_triangles_pairs(tsetup, port_cfg(**opts))
    assert int(to) == int(jo) > 0
