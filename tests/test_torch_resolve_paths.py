"""Port parity for the JAX package's coherent resolve paths: quad-rate
(RasterConfig.quad_rate_resolve), slot-rate (slot_resolve) and planar
(planar_resolve) resolve, their overflow counts, their exclusions, and
whole frames under them.

Scenes and inputs as in tests/test_torch_records.py (128x64; both
packages resolve the port's VisBuffer, the JAX side op by op). Against
the JAX package's path of the same option: G-buffer words equal, the
material fields within 1e-6, ResolveAux.overflow equal (the overflow
cases' words too). Against the port's own default path, as the JAX
package's tests hold theirs (tests/test_resolve_quad.py,
test_resolve_slot.py, test_resolve_planar.py; the tap_block cases are
in tests/test_torch_quadblock.py): quad and slot every word, planar
every word too. The
port resolves planar_resolve by its dense path. The JAX package's
op-by-op planar twin rounds its cross products unfused, where its dense
path's jnp.cross is contracted (fastmath.cross), so the port's material
fields are held to the JAX planar twin's within that test's AUX_ATOL
(2e-5) and to the JAX dense path's within 1e-6. Frames: the port's
within the mean 5e-3 of tests/test_torch_frame.py of the JAX package's
frame under the same options.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voidin_tpu.framework.renderer import FrameState as JaxFrameState
from voidin_tpu.framework.renderer import Globals as JaxGlobals
from voidin_tpu.framework.renderer import render_frame as jax_render_frame
from voidin_tpu.passes import resolve as j_resolve

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.passes import resolve as t_resolve
from voidin_tpu_torch.passes.gbuffer import VisBuffer

from tests import test_resolve_planar
from tests.test_torch_records import (J_CFG, assert_matches_jax,
                                      assert_same_words, case_of, jax_vis,
                                      port_cfg, port_vis, resolve_both,
                                      resolve_port)

torch.set_num_threads(2)
BUDGET = 5e-3
PLANAR_AUX_ATOL = test_resolve_planar.AUX_ATOL


@pytest.fixture(scope="module")
def cases():
    return {}


# ---------------------------------------------------------------------------
# The slot path's one-hot select
# ---------------------------------------------------------------------------


def test_onehot_select_words_match_jax():
    """The select against the JAX package's f32 einsum on a table with
    -0.0, infinities and a NaN, and pixels that match no slot: every word
    equal where the result is a number, NaN at the same places (a NaN's
    payload is the hardware's)."""
    rng = np.random.default_rng(11)
    ids = rng.integers(-1, 6, (2, 3, 128)).astype(np.int32)
    uniq = np.stack([np.sort(rng.choice(np.arange(-1, 6), 4,
                                        replace=False))[::-1]
                     for _ in range(6)]).reshape(2, 3, 4).astype(np.int32)
    onehot = (ids[..., None] == uniq[..., None, :]).astype(np.float32)
    assert (onehot.sum(-1) == 0).any() and (onehot.sum(-1) == 1).any()
    table = rng.normal(size=(2, 3, 4, 7)).astype(np.float32)
    table[0, 0, 1, 2] = -0.0
    table[0, 0, :, 3] = -0.0
    table[0, 1, 2, 4] = np.inf
    table[1, 2, 0, 5] = -np.inf
    table[1, 1, 3, 6] = np.nan
    want = np.asarray(jnp.einsum("abpk,abkc->abpc", onehot, table,
                                 precision=jax.lax.Precision.HIGHEST))
    got = t_resolve._onehot_select(torch.from_numpy(onehot > 0),
                                   torch.from_numpy(table)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])
    assert nan.any() and np.isinf(got).any()
    assert (got.view(np.int32) == 0).any()  # -0.0 and no-match give +0.0
    assert not (got.view(np.int32) == np.float32(-0.0).view(np.int32)).any()


def test_onehot_select_keeps_the_tf32_switch():
    """The select runs no matmul: it leaves the process-wide TF32 switch
    as it found it and gives the selected words exactly."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        table = torch.tensor([[1.0 + 2.0 ** -20, -0.0],
                              [3.0, 2.0 ** -130]])
        got = t_resolve._onehot_select(torch.eye(2, dtype=torch.bool),
                                       table)
        assert torch.equal(got.view(torch.int32),
                           (table + 0.0).view(torch.int32))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------------------
# Quad, slot and planar resolve against the JAX package's
# ---------------------------------------------------------------------------

QUAD = dict(quad_rate_resolve=True)
SLOT = dict(slot_resolve=True)
PLANAR = dict(planar_resolve=True)
F16 = dict(inst_rec_f16=True)
DENSE = dict(lazy_alpha_resolve=False)

PATH_CASES = {
    "quad": ("textured", QUAD),
    "quad_f16": ("textured", {**QUAD, **F16}),
    "quad_nmap": ("nmap", QUAD),
    "quad_alpha": ("alpha", QUAD),
    "quad_alpha_dense": ("alpha", {**QUAD, **DENSE}),
    "quad_overflow": ("textured", {**QUAD, "quad_edge_capacity": 8}),
    "slot": ("textured", SLOT),
    "slot_f16": ("textured", {**SLOT, **F16}),
    "slot_nmap": ("nmap", SLOT),
    "slot_alpha": ("alpha", SLOT),
    "slot_alpha_dense": ("alpha", {**SLOT, **DENSE}),
    "slot_k2": ("textured", {**SLOT, "slot_k": 2}),
    "slot_overflow": ("textured", {**SLOT, "slot_k": 2,
                                   "slot_edge_capacity": 8}),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_coherent_path_matches_jax(cases, case):
    name, opts = PATH_CASES[case]
    j, t = resolve_both(case_of(cases, name), **opts)
    assert_matches_jax(j, t)
    assert t[1].overflow is not None
    if case.endswith("overflow"):
        assert int(t[1].overflow) > 0  # the scene overflows the batch
    else:
        assert int(t[1].overflow) == 0


@pytest.mark.parametrize("case", sorted(
    c for c in PATH_CASES if not c.endswith("overflow")))
def test_coherent_path_bit_identical_to_per_pixel(cases, case):
    """tests/test_resolve_quad.py / test_resolve_slot.py on the port:
    every word of the per-pixel path of the same records (and alpha
    fallback), overflow 0."""
    name, opts = PATH_CASES[case]
    c = case_of(cases, name)
    base = {k: v for k, v in opts.items()
            if k in ("inst_rec_f16", "lazy_alpha_resolve")}
    assert_same_words(resolve_port(c, **base), resolve_port(c, **opts))


PLANAR_CASES = {
    "planar": ("textured", PLANAR),
    "planar_f16": ("textured", {**PLANAR, **F16}),
    "planar_fused": ("textured", {**PLANAR, **F16,
                                  "fused_resolve_rec": True}),
    "planar_nmap": ("nmap", PLANAR),
    "planar_alpha": ("alpha", PLANAR),
    "planar_alpha_dense": ("alpha", {**PLANAR, **DENSE}),
}


@pytest.mark.parametrize("case", sorted(PLANAR_CASES))
def test_planar_matches_jax(cases, case):
    """G-buffer words of the JAX package's planar twin; material fields
    within its planar budget of it and within 1e-6 of its dense path."""
    name, opts = PLANAR_CASES[case]
    c = case_of(cases, name)
    j, t = resolve_both(c, **opts)
    assert_matches_jax(j, t, aux_atol=PLANAR_AUX_ATOL)
    dense = {k: v for k, v in opts.items() if k != "planar_resolve"}
    jd, _ = resolve_both(c, **dense)
    assert_matches_jax(jd, t)


@pytest.mark.parametrize("case", sorted(PLANAR_CASES))
def test_planar_bit_identical_to_per_pixel(cases, case):
    name, opts = PLANAR_CASES[case]
    c = case_of(cases, name)
    dense = {k: v for k, v in opts.items() if k != "planar_resolve"}
    assert_same_words(resolve_port(c, **dense), resolve_port(c, **opts))


def test_planar_gives_way_to_the_coherent_paths(cases):
    """planar_resolve with quad or slot: the coherent path runs (the
    JAX package's dense-path-only rule), the same words."""
    c = case_of(cases, "textured")
    for opts in (QUAD, SLOT):
        a = resolve_port(c, **opts)
        b = resolve_port(c, **opts, **PLANAR)
        assert_same_words(a, b)
        assert b[1].overflow is not None


@pytest.mark.parametrize("opts", [
    dict(quad_rate_resolve=True, fused_resolve_rec=True),
    dict(slot_resolve=True, fused_resolve_rec=True),
    dict(quad_rate_resolve=True, slim_rec=True),
    dict(slot_resolve=True, slim_rec=True),
], ids=["quad_fused", "slot_fused", "quad_slim", "slot_slim"])
def test_coherent_path_exclusions(cases, opts):
    """The JAX package's mutual exclusions, with its exception and
    message."""
    c = case_of(cases, "textured")
    vis = port_vis(c)
    with pytest.raises(ValueError) as want:
        j_resolve.resolve_gbuffer(c["js"], jax_vis(vis), c["cam"],
                                  dataclasses.replace(J_CFG, **opts))
    with pytest.raises(ValueError) as got:
        t_resolve.resolve_gbuffer(c["ts"], vis, port_cfg(**opts))
    assert str(got.value) == str(want.value)
    assert "mutually exclusive" in str(got.value)


def test_odd_sizes_fall_back_to_the_dense_path(cases):
    """Quad needs even sizes and slot 8x16 tiles, as in the JAX package:
    elsewhere the dense path runs and no overflow is tracked."""
    c = case_of(cases, "textured")
    vis = port_vis(c)
    crop = VisBuffer(tri_id=vis.tri_id[:63, :127],
                     depth=vis.depth[:63, :127],
                     resolve_rec=vis.resolve_rec, overflow=vis.overflow)
    base = t_resolve.resolve_gbuffer(c["ts"], crop, port_cfg())
    for opts in (QUAD, SLOT):
        got = t_resolve.resolve_gbuffer(c["ts"], crop, port_cfg(**opts))
        assert got[1].overflow is None
        assert_same_words(base, got)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

FRAME_OPTIONS = {
    # every record layout and binning option of the slice in one frame
    "records_planar": dict(sort_payload=True, two_stream_bin=False,
                           fused_resolve_rec=True, inst_rec_f16=True,
                           fused_inst_rec=True, planar_resolve=True),
    "quad_f16": dict(quad_rate_resolve=True, inst_rec_f16=True),
    "slot": dict(slot_resolve=True),
}


def _port_frame(c, **opts):
    r = Renderer(c["ts"], port_cfg(**opts), enable_taa=False)
    img = r.render(pt.Camera(position=[0.0, 0.5, 2.0], pitch=-10.0,
                             aspect=J_CFG.width / J_CFG.height)).numpy()
    return img, r


@pytest.mark.parametrize("opt", sorted(FRAME_OPTIONS))
def test_frame_matches_jax(cases, opt):
    """The port's frame under the options against the JAX package's frame
    under them (op by op): within the frame budget, overflow equal; and
    against the port's own frame of the same record precision: word for
    word (the options keep the words, inst_rec_f16 aside)."""
    opts = FRAME_OPTIONS[opt]
    c = case_of(cases, "nmap")
    got, r = _port_frame(c, **opts)
    w, h = J_CFG.width, J_CFG.height
    img, _st, _sc, aux = jax_render_frame(
        c["js"], c["cam"], JaxGlobals.make(w, h), JaxFrameState.initial(w, h),
        jnp.zeros(0, jnp.int32), dataclasses.replace(J_CFG, **opts),
        enable_taa=False)
    diff = np.abs(got - np.asarray(img)).mean()
    print(f"{opt}: mean abs diff vs the JAX frame {diff:.3e}")
    assert diff < BUDGET and got.std() > 0.02
    assert int(r.aux["overflow"]) == int(aux["overflow"]) == 0
    same = _port_frame(c, **{k: v for k, v in opts.items()
                             if k == "inst_rec_f16"})[0]
    np.testing.assert_array_equal(got, same)
