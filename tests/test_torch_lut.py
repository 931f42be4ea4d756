"""Port parity: kernel K3's twin (voidin_tpu_torch.ops.lut_fetch) against
the JAX package's Pallas LUT-fetch kernel (interpret mode) and its XLA
formulation, sample_lut_bilinear_mxu_multi; and the twin of its bf16
variant against the Pallas kernel's bf16 path; and that shade reaches the
LTC tables through the fused LTC wrapper (ops/ltc_rect.py), which carries
K3's fetch, following the bf16 switch.

Tolerance 1e-6 absolute on standard-normal tables: the JAX forms contract
the same two taps per axis as one-hot weight products (their sums may fuse
into FMAs), the twin as two separately rounded products and a sum — a few
ulp at |values| <= ~4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voidin_tpu.ops.lut_fetch import lut_fetch_pallas
from voidin_tpu.passes import shading as j_shading

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer, build_world
from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.ops import ltc_rect as t_ltc
from voidin_tpu_torch.passes import shading as t_shading
from voidin_tpu_torch.passes.raster import RasterConfig

torch.set_num_threads(2)
TOL = 1e-6


def _tables(rng, n_chan):
    return [rng.standard_normal((64, 64)).astype(np.float32)
            for _ in range(n_chan)]


def _check(tables, uv):
    got = t_lut.lut_fetch([torch.from_numpy(t) for t in tables],
                          torch.from_numpy(uv))
    ref_x = j_shading.sample_lut_bilinear_mxu_multi(
        [jnp.asarray(t) for t in tables], jnp.asarray(uv))
    ref_k = lut_fetch_pallas([jnp.asarray(t) for t in tables],
                             jnp.asarray(uv), interpret=True)
    assert len(got) == len(tables)
    for g, a, b in zip(got, ref_x, ref_k):
        assert tuple(g.shape) == uv.shape[:-1]
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("n_chan", [1, 5, 8])
def test_twin_matches_pallas_and_xla(n_chan):
    rng = np.random.default_rng(3 + n_chan)
    uv = (rng.uniform(0, 1, (17, 29, 2)).astype(np.float32)
          * np.float32(t_ltc.LUT_SCALE) + np.float32(t_ltc.LUT_BIAS))
    _check(_tables(rng, n_chan), uv)


def test_twin_corner_uvs():
    """Corner uvs exercise the clamped second tap (y1 == y0 merge)."""
    rng = np.random.default_rng(11)
    uv = (np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]],
                   np.float32) * np.float32(t_ltc.LUT_SCALE)
          + np.float32(t_ltc.LUT_BIAS))
    _check(_tables(rng, 5), uv)


def _check_bf16(tables, uv):
    got = t_lut.lut_fetch([torch.from_numpy(t) for t in tables],
                          torch.from_numpy(uv), bf16=True)
    want = lut_fetch_pallas([jnp.asarray(t) for t in tables],
                            jnp.asarray(uv), interpret=True, bf16=True)
    f32 = t_lut.lut_fetch([torch.from_numpy(t) for t in tables],
                          torch.from_numpy(uv))
    for g, w, f in zip(got, want, f32):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
        assert (g != f).any()  # the variant really rounds


@pytest.mark.parametrize("n_chan", [1, 5, 8])
def test_bf16_twin_matches_pallas(n_chan):
    """K3's bf16 variant (LTC_LUT_BF16): bf16 row weights and tables, f32
    sums, against the Pallas kernel's bf16 path (interpret), with the
    clamp-edge uvs among random ones."""
    rng = np.random.default_rng(13 + n_chan)
    uv = rng.uniform(0, 1, (23, 19, 2)).astype(np.float32)
    uv[0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]]
    uv = uv * np.float32(t_ltc.LUT_SCALE) + np.float32(t_ltc.LUT_BIAS)
    _check_bf16(_tables(rng, n_chan), uv)


def _shade_calls(monkeypatch, bf16):
    """One frame of a small area-lit scene on the CPU with the shading
    module's LTC_LUT_BF16 switch at `bf16`, every call of the fused
    wrapper recorded; returns (calls, scene, image)."""
    calls = []
    real = t_ltc.ltc_rect_terms

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(t_ltc, "ltc_rect_terms", record)
    monkeypatch.setattr(t_shading, "LTC_LUT_BF16", bf16)
    world, moving = build_world(40, seed=2)
    scene = world.device("cpu")
    r = Renderer(scene, RasterConfig(width=48, height=32,
                                     tri_capacity=1 << 12,
                                     pair_capacity=1 << 13),
                 moving_ids=moving, enable_taa=False)
    img = r.render(pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                             aspect=1.5))
    return calls, scene, img


def test_shading_fetch_follows_the_bf16_switch(monkeypatch):
    """shade passes LTC_LUT_BF16 to the fused wrapper at each call, and
    the bf16 fetch really rounds."""
    terms = {}
    for bf16 in (False, True):
        calls, _, _ = _shade_calls(monkeypatch, bf16)
        assert len(calls) == 1 and calls[0][1]["bf16"] is bf16
        terms[bf16] = calls[0][2]
    assert not torch.equal(terms[False][1], terms[True][1])


def test_shading_fetch_goes_through_the_wrapper(monkeypatch):
    """shade reaches the LTC tables through one call of the fused wrapper
    a frame, with the scene's tables as stored and every area light."""
    calls, scene, img = _shade_calls(monkeypatch, False)
    assert len(calls) == 1
    args = calls[0][0]
    assert args[5] is scene.ltc1 and args[6] is scene.ltc2
    assert torch.equal(args[4], scene.lights.area_points)
    diff, spec = calls[0][2]
    n_lights = scene.lights.area_points.shape[0]
    assert n_lights > 0 and tuple(diff.shape) == (n_lights,) + img.shape[:2]
    assert (diff > 0).any() and torch.isfinite(spec).all()


def test_rejects_bad_table_count():
    with pytest.raises(ValueError):
        t_lut.lut_fetch([torch.zeros(64, 64)] * 9, torch.zeros(4, 2))
