"""Port parity for the JAX package's quad-block samplers: the TAA history
fetch by quad blocks (taa_quad_history, its two selects by
taa_quad_where) and from each pixel's window (taa_inwindow), and whole
frames under them; and the JAX package's quad-rate albedo tap
(RasterConfig.tap_block over its pool's 4x4 tap-block tables), whose
words the port's one tap (texture.sample_trilinear over the quad table)
gives: the port holds no block tables.

The JAX functions run as the JAX package's own tests run them on the CPU
(op by op). Tolerances: every word equal (NaN at the same places, whose
payload is the hardware's), with two exceptions that predate this file:
the sRGB decode of the albedo tap (the JAX package's pow rounds apart
from torch's; ResolveAux fields within 1e-6, tests/test_torch_records.py)
and whole frames (mean 5e-3 of the JAX frame, tests/test_torch_frame.py).
Against the port's own default path, as the JAX package's tests hold
theirs (tests/test_taa_quad.py, test_taa_inwindow.py): every word,
overflow 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.framework.renderer import FrameState as JaxFrameState
from voidin_tpu.framework.renderer import Globals as JaxGlobals
from voidin_tpu.framework.renderer import render_frame as jax_render_frame
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import resolve as j_resolve
from voidin_tpu.passes import taa as j_taa
from voidin_tpu.scene import texture as j_tex

from voidin_tpu_torch.framework import renderer as t_renderer
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import taa as t_taa
from voidin_tpu_torch.scene import texture as t_tex

from tests import test_raster, test_resolve_quad
from tests.test_taa_inwindow import _coords
from tests.test_taa_quad import _data
from tests.test_texture_meta import _pool
from tests.test_torch_records import (J_CFG, _all_draws,
                                      assert_gbuffer_words, jax_vis,
                                      normal_mapped_world, port_cfg,
                                      port_vis, resolve_port)
from tests.test_torch_scene import packer  # noqa: F401 (fixture)
from tests.test_torch_scene import port_scene, unpermuted_worlds

torch.set_num_threads(2)
AUX_ATOL = 1e-6
BUDGET = 5e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_words(want, got):
    """Every word equal; NaN where the other is NaN."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

# (h, w) of each pool's textures after the four reserved 1x1 slots
POOLS = {
    "square": ((64, 64), (48, 24), (16, 16)),
    "odd": ((37, 21), (5, 12), (3, 3), (7, 1)),
    "strips": ((1, 40), (40, 1), (2, 33), (1, 1)),
}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pool_is_the_jax_quad_table_alone(pool, packer):  # noqa: F811
    """On each packer, on pools with non-square, non-power-of-two and 1xN
    textures: the port's device pool is the JAX package's quad table,
    word for word, and nothing else: pool_device_bytes(T, S) bytes
    (the JAX function's count without blocks) and no block fields,
    where the JAX pool built with its tap-block tables holds 5x that."""
    rng = np.random.default_rng(len(pool))
    jp, tp = j_tex.TexturePool(base_size=64), t_tex.TexturePool(base_size=64)
    for h, w in POOLS[pool]:
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        jp.add(img, srgb=True)
        tp.add(img, srgb=True)
    jd = jp.device(blocks=True)
    td = tp.device("cpu")
    assert td.quads.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jd.quads), td.quads.numpy())
    assert not {"child_blocks", "parent_blocks"} & {
        f.name for f in dataclasses.fields(td)}
    T, S = td.count, td.base_size
    n_bytes = td.quads.numel() * td.quads.element_size()
    assert n_bytes == t_tex.pool_device_bytes(T, S) \
        == j_tex.pool_device_bytes(T, S, blocks=False)
    j_bytes = sum(np.asarray(getattr(jd, k)).nbytes
                  for k in ("quads", "child_blocks", "parent_blocks"))
    assert j_bytes == 5 * n_bytes


# ---------------------------------------------------------------------------
# The albedo tap against the JAX package's quad-rate tap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pools():
    """tests/test_texture_meta.py's pool on both packages (the JAX one
    with its tap-block tables)."""
    pool = _pool()
    tp = t_tex.TexturePool(base_size=pool.base_size)
    for img, srgb in zip(pool.images[4:], pool.srgb_flags[4:]):
        tp.add(img, srgb=srgb)
    jd, td = pool.device(blocks=True), tp.device("cpu")
    assert np.array_equal(np.asarray(jd.quads), td.quads.numpy())
    return jd, td


def _tap_inputs(case, H=32, W=64):
    """(tex_id, uv, lod) of tests/test_texture_meta.py:93-117's smooth and
    random cases."""
    if case == "smooth":
        yy, xx = np.meshgrid(np.linspace(-0.2, 1.3, H),
                             np.linspace(-0.1, 2.1, W), indexing="ij")
        return (np.full((H, W), 4, np.int32),
                np.stack([xx, yy], -1).astype(np.float32),
                (xx * 2.0 + yy).astype(np.float32))
    rng = np.random.default_rng(21)
    uv = rng.uniform(-2, 3, (H, W, 2)).astype(np.float32)
    lod = rng.uniform(0, 9, (H, W)).astype(np.float32)
    tex = rng.integers(4, 7, (H, W)).astype(np.int32)
    return tex, uv, lod


@pytest.mark.parametrize("case", ["smooth", "random"])
def test_tap_quadblock_matches_jax(pools, case):
    """The port's sample_trilinear against the JAX package's
    sample_trilinear_quadblock at its auto capacity: the filtered words
    (before the sRGB decode) equal, the decoded samples within 1e-6, the
    JAX overflow 0."""
    jd, td = pools
    tex, uv, lod = _tap_inputs(case)
    whg = jd.size[jnp.asarray(tex)]
    wh = (whg[..., 0].astype(jnp.float32), whg[..., 1].astype(jnp.float32))
    twh = (_t(wh[0]), _t(wh[1]))
    for srgb in (False, None):
        jq, jo = j_tex.sample_trilinear_quadblock(
            jd, jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(lod), wh=wh,
            srgb=srgb)
        assert int(jo) == 0
        tq = t_tex.sample_trilinear(td, _t(tex), _t(uv), _t(lod), wh=twh,
                                    srgb=srgb)
        if srgb is False:
            assert_words(jq, tq.numpy())
        else:
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                                       atol=AUX_ATOL)
    assert np.isfinite(tq.numpy()).all()


# ---------------------------------------------------------------------------
# resolve_gbuffer against the JAX package's with tap_block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    return {}


def block_case(cases, name):
    """tests/test_torch_records.py's case `name` ("textured", "nmap",
    "alpha"), its JAX scene built with the tap-block tables (the port's
    scene takes its quad table alone)."""
    if name not in cases:
        with unpermuted_worlds():
            w = dict(textured=test_resolve_quad._textured_scene,
                     nmap=normal_mapped_world,
                     alpha=lambda: test_raster._alpha_scene()[0])[name]()
            js = w.device()
        assert js.textures.child_blocks is not None
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
        cases[name] = dict(name=name, js=js, ts=ts, cam=cam, jd=jd, td=td,
                           alpha=js.alpha_masked, vis={})
    return cases[name]


# (case, the options both packages take); the JAX package adds tap_block
TAP_CASES = {
    "tap": ("textured", {}),
    "tap_f16": ("textured", {"inst_rec_f16": True}),
    "tap_nmap": ("nmap", {}),
    "tap_alpha": ("alpha", {}),
    "tap_alpha_dense": ("alpha", {"lazy_alpha_resolve": False}),
    "tap_quad": ("textured", {"quad_rate_resolve": True}),
    "tap_slot": ("textured", {"slot_resolve": True}),
}


@pytest.mark.parametrize("case", sorted(TAP_CASES))
def test_resolve_tap_block_matches_jax(cases, case):
    """The port's resolve_gbuffer (alone, with the f16 record, normal
    maps, the alpha fallback lazy and dense, with quad and slot) against
    the JAX package's under the same options plus tap_block: G-buffer
    words equal, the material fields within 1e-6, the JAX overflow 0 (and
    the port's, where it tracks one)."""
    name, opts = TAP_CASES[case]
    c = block_case(cases, name)
    jcfg = dataclasses.replace(J_CFG, alpha_mask=c["alpha"], tap_block=True,
                               **opts)
    jg, ja = j_resolve.resolve_gbuffer(c["js"], jax_vis(port_vis(c, **opts)),
                                       c["cam"], jcfg)
    tg, ta = resolve_port(c, **opts)
    assert_gbuffer_words(jg, tg)
    for field in ("albedo", "emissive", "mr"):
        np.testing.assert_allclose(getattr(ta, field).numpy(),
                                   np.asarray(getattr(ja, field)), rtol=0,
                                   atol=AUX_ATOL, err_msg=field)
    assert int(ja.overflow) == 0
    assert ta.overflow is None or int(ta.overflow) == 0
    assert (tg.material.numpy() > 0).any()


# ---------------------------------------------------------------------------
# The TAA history fetches
# ---------------------------------------------------------------------------


def _hist_uv(motion):
    """taa_resolve's history coordinates of (H, W, 3) motion, in numpy
    f32 (the same words as both packages compute them)."""
    H, W = motion.shape[:2]
    u = (np.arange(W, dtype=np.float32) + np.float32(0.5)) / np.float32(W)
    v = (np.arange(H, dtype=np.float32) + np.float32(0.5)) / np.float32(H)
    m = np.asarray(motion)
    hu = u[None, :] - m[..., 0] * np.float32(0.5)
    hv = v[:, None] + m[..., 1] * np.float32(0.5)
    return hu.astype(np.float32), hv.astype(np.float32)


def _adversarial(seed=0, H=64, W=96):
    """A history with -0.0, negatives that round to -0.0 in f16, values
    above 65504 (inf in f16) and NaN and inf texels."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.001, 1.0, (H, W, 3)).astype(np.float32)
    img[rng.random((H, W)) < 0.05, 0] = -0.0
    img[rng.random((H, W)) < 0.03, 1] = -1e-9
    img[rng.random((H, W)) < 0.01, 2] = 7e4
    img[rng.random((H, W)) < 0.005, 0] = np.nan
    img[rng.random((H, W)) < 0.003, 1] = np.inf
    img[:8, :8] = -rng.uniform(0.0, 1e-3, (8, 8, 3)).astype(np.float32)
    img[2, 2, 0] = -0.0  # a -0.0 among negatives only
    return img


QUAD_FETCHES = {
    # tests/test_taa_quad.py's histories and motions (seed, velocity
    # scale, edge capacity): smooth, extreme velocities, overflowing
    "smooth": (0, 2.0, 0),
    "extreme": (3, 40.0, 0),
    "overflow": (5, 40.0, 4),
}


@pytest.mark.parametrize("select", ["einsum", "where"])
@pytest.mark.parametrize("case", sorted(QUAD_FETCHES))
def test_quadblock_fetch_matches_jax(case, select):
    """_bilinear_clamp_quadblock with each select against the JAX
    package's on tests/test_taa_quad.py's cases: every word and the
    overflow equal; without overflow every word of the port's per-pixel
    fetch."""
    seed, vel, cap = QUAD_FETCHES[case]
    _color, history, motion = _data(seed=seed, vel_scale=vel)
    hu, hv = _hist_uv(motion)
    jo, jov = j_taa._bilinear_clamp_quadblock(
        history, jnp.asarray(hu), jnp.asarray(hv), capacity=cap,
        select=select)
    to, tov = t_taa._bilinear_clamp_quadblock(
        _t(history), _t(hu), _t(hv), capacity=cap, select=select)
    assert_words(jo, to.numpy())
    assert int(tov) == int(jov)
    assert (int(tov) > 0) == (case == "overflow")
    if not cap:
        base = t_taa._bilinear_clamp(_t(history), _t(hu), _t(hv))
        assert_words(base.numpy(), to.numpy())


@pytest.mark.parametrize("cap", [0, 4])
@pytest.mark.parametrize("motion", ["static", "fast"])
def test_quadblock_selects_on_adversarial_history(motion, cap):
    """Both selects against the JAX package's on a history with -0.0,
    f16-underflowing negatives, values above 65504 and non-finite texels:
    every word and the overflow equal. The JAX package's two selects
    differ there (its einsum turns -0.0 into +0.0 and spreads NaN over a
    block's quads); the where select keeps the per-pixel fetch's words."""
    img = _adversarial()
    H, W = img.shape[:2]
    rng = np.random.default_rng(7)
    frac, mag = (0.0, 0.0) if motion == "static" else (1.0, 0.5)
    u, v = (np.asarray(a) for a in _coords(H, W, rng, frac, mag))
    if motion == "static":  # exact texel centres: tx = ty = 0
        u = ((np.arange(W, dtype=np.float32) + 0.5) / W)[None].repeat(H, 0)
        v = ((np.arange(H, dtype=np.float32) + 0.5) / H)[:, None].repeat(W, 1)
    outs = {}
    for select in ("einsum", "where"):
        jo, jov = j_taa._bilinear_clamp_quadblock(
            jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), capacity=cap,
            select=select)
        to, tov = t_taa._bilinear_clamp_quadblock(
            _t(img), _t(u), _t(v), capacity=cap, select=select)
        assert_words(jo, to.numpy())
        assert int(tov) == int(jov)
        outs[select] = to.numpy()
    nan = {k: np.isnan(o) for k, o in outs.items()}
    assert nan["einsum"].sum() > nan["where"].sum()
    if motion == "static" and cap == 0:
        base = t_taa._bilinear_clamp(_t(img), _t(u), _t(v)).numpy()
        assert_words(base, outs["where"])
        # -0.0 comes out +0.0 under the einsum select only
        assert np.signbit(outs["where"][2, 2, 0])
        assert not np.signbit(outs["einsum"][2, 2, 0])


INWINDOW = {
    # tests/test_taa_inwindow.py's cases (size, fast fraction, fast
    # magnitude, capacity); "offscreen" draws uv in [-0.5, 1.5), "odd" is
    # a size that 8 does not divide (the per-pixel fetch, overflow 0)
    "still": ((64, 96), 0.0, 0.0, 0),
    "some_fast": ((64, 96), 0.1, 0.08, 0),
    "half_fast": ((64, 96), 0.5, 0.3, 0),
    "offscreen": ((32, 64), None, None, 0),
    "overflow": ((32, 64), 1.0, 0.5, 2),
    "odd": ((36, 60), 0.5, 0.3, 0),
}


@pytest.mark.parametrize("case", sorted(INWINDOW))
def test_inwindow_fetch_matches_jax(case):
    """_bilinear_clamp_inwindow against the JAX package's: every word and
    the overflow equal; without overflow every word of the per-pixel
    fetch; and on the adversarial history too."""
    (H, W), frac, mag, cap = INWINDOW[case]
    rng = np.random.default_rng(len(case))
    img = rng.random((H, W, 3), dtype=np.float32)
    if frac is None:
        u = rng.uniform(-0.5, 1.5, (H, W)).astype(np.float32)
        v = rng.uniform(-0.5, 1.5, (H, W)).astype(np.float32)
    else:
        u, v = (np.asarray(a) for a in _coords(H, W, rng, frac, mag))
    for hist in (img, _adversarial(H=H, W=W)):
        jo, jov = j_taa._bilinear_clamp_inwindow(
            jnp.asarray(hist), jnp.asarray(u), jnp.asarray(v), capacity=cap)
        to, tov = t_taa._bilinear_clamp_inwindow(_t(hist), _t(u), _t(v),
                                                 capacity=cap)
        assert_words(jo, to.numpy())
        assert int(tov) == int(jov)
        if not cap:
            base = t_taa._bilinear_clamp(_t(hist), _t(u), _t(v))
            assert_words(base.numpy(), to.numpy())
    assert (int(tov) > 0) == (case == "overflow")


TAA_OPTIONS = {
    "quad_einsum": dict(quad_history=True),
    "quad_where": dict(quad_history=True, quad_select="where"),
    "inwindow": dict(inwindow=True),
    "quad_before_inwindow": dict(quad_history=True, inwindow=True,
                                 edge_capacity=4),
}


@pytest.mark.parametrize("opt", sorted(TAA_OPTIONS))
def test_taa_resolve_options_keep_the_words(opt):
    """taa_resolve with each fetch option: every word of the default
    resolve while the batch holds (tests/test_taa_quad.py's data), and
    the quad fetch first where both are set (its overflow counted)."""
    color, history, motion = (_t(a) for a in _data(seed=1))
    base, ovf0 = t_taa.taa_resolve(color, history, motion)
    got, ovf = t_taa.taa_resolve(color, history, motion,
                                 **TAA_OPTIONS[opt])
    assert int(ovf0) == 0
    if opt == "quad_before_inwindow":
        want, wovf = t_taa.taa_resolve(color, history, motion,
                                       quad_history=True, edge_capacity=4)
        assert int(ovf) == int(wovf) > 0
        assert_words(want.numpy(), got.numpy())
    else:
        assert int(ovf) == 0
        assert_words(base.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

# (the port's options, the JAX package's): the port has no tap_block
FRAME_OPTIONS = {
    "tap_block": ({}, dict(tap_block=True)),
    "taa_quad_history": (dict(taa_quad_history=True),) * 2,
    "taa_quad_where": (dict(taa_quad_history=True, taa_quad_where=True),) * 2,
    "taa_inwindow": (dict(taa_inwindow=True),) * 2,
}


@pytest.fixture(scope="module")
def frames(cases):
    """The port's and the JAX package's default frame of the textured
    block case with a seeded history and a camera that moved since the
    previous frame: ({"port": image, "jax": image}, frame inputs)."""
    c = block_case(cases, "textured")
    w, h = J_CFG.width, J_CFG.height
    rng = np.random.default_rng(9)
    history = rng.uniform(0.0, 1.2, (h, w, 3)).astype(np.float32)
    prev = vt.Camera(position=[0.1, 0.45, 2.1], pitch=-9.0,
                     aspect=w / h).uniform()
    cam = vt.Camera(position=[0.0, 0.5, 2.0], pitch=-10.0,
                    aspect=w / h).uniform(previous=prev)
    inputs = dict(c=c, history=history, cam=cam)
    return dict(port=_port_frame(inputs, {}), jax=_jax_frame(inputs, {})), \
        inputs


def _port_frame(inputs, opts):
    c, (h, w) = inputs["c"], inputs["history"].shape[:2]
    state = t_renderer.frame_state_from_numpy(inputs["history"], True, "cpu")
    img, _st, _sc, aux = t_renderer.render_frame(
        c["ts"], inputs["cam"], t_renderer.Globals.make(w, h), state,
        torch.zeros(0, dtype=torch.int32), port_cfg(**opts))
    assert int(aux["overflow"]) == 0
    return img.numpy()


def _jax_frame(inputs, opts):
    c, (h, w) = inputs["c"], inputs["history"].shape[:2]
    state = JaxFrameState(history=jnp.asarray(inputs["history"]),
                          history_valid=jnp.asarray(True))
    img, _st, _sc, aux = jax_render_frame(
        c["js"], inputs["cam"], JaxGlobals.make(w, h), state,
        jnp.zeros(0, jnp.int32), dataclasses.replace(J_CFG, **opts))
    assert int(aux["overflow"]) == 0
    return np.asarray(img)


@pytest.mark.parametrize("opt", sorted(FRAME_OPTIONS))
def test_frame_option_matches_default_and_jax(frames, opt):
    """A frame under each sampler (TAA reading a seeded history through
    motion): every word of the port's default frame, and within the
    frame budget of the JAX package's frame under the same option (under
    tap_block, the port's default frame against the JAX package's
    tap_block frame)."""
    (imgs, inputs) = frames
    port_opts, jax_opts = FRAME_OPTIONS[opt]
    got = _port_frame(inputs, port_opts)
    np.testing.assert_array_equal(got.view(np.int32),
                                  imgs["port"].view(np.int32))
    diff = np.abs(got - _jax_frame(inputs, jax_opts)).mean()
    print(f"{opt}: mean abs diff vs the JAX frame {diff:.3e}")
    assert diff < BUDGET and got.std() > 0.02
    assert np.abs(imgs["port"] - imgs["jax"]).mean() < BUDGET
