"""Port parity: kernel K3's twin (voidin_tpu_torch.ops.lut_fetch) against
the JAX package's Pallas LUT-fetch kernel (interpret mode) and its XLA
formulation, sample_lut_bilinear_mxu_multi; and the twin of its bf16
variant against the Pallas kernel's bf16 path.

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

from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.passes import shading as t_shading

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
          * np.float32(t_shading.LUT_SCALE) + np.float32(t_shading.LUT_BIAS))
    _check(_tables(rng, n_chan), uv)


def test_twin_corner_uvs():
    """Corner uvs exercise the clamped second tap (y1 == y0 merge)."""
    rng = np.random.default_rng(11)
    uv = (np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]],
                   np.float32) * np.float32(t_shading.LUT_SCALE)
          + np.float32(t_shading.LUT_BIAS))
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
    uv = uv * np.float32(t_shading.LUT_SCALE) + np.float32(t_shading.LUT_BIAS)
    _check_bf16(_tables(rng, n_chan), uv)


def test_shading_fetch_follows_the_bf16_switch(monkeypatch):
    tables = [torch.full((64, 64), 1.0 / 3.0)]
    uv = torch.full((3, 2), 0.5)
    (f32,) = t_shading.sample_lut_bilinear_multi(tables, uv)
    monkeypatch.setattr(t_shading, "LTC_LUT_BF16", True)
    (bf,) = t_shading.sample_lut_bilinear_multi(tables, uv)
    np.testing.assert_array_equal(f32.numpy(), np.float32(1.0 / 3.0))
    assert float(bf[0]) == float(torch.tensor(1.0 / 3.0).bfloat16())


def test_shading_fetch_goes_through_the_wrapper():
    assert t_shading.sample_lut_bilinear_multi.__module__ == t_shading.__name__
    tables = [torch.ones(64, 64)]
    uv = torch.full((3, 2), 0.5)
    (out,) = t_shading.sample_lut_bilinear_multi(tables, uv)
    np.testing.assert_array_equal(out.numpy(), np.ones(3, np.float32))


def test_rejects_bad_table_count():
    with pytest.raises(ValueError):
        t_lut.lut_fetch([torch.zeros(64, 64)] * 9, torch.zeros(4, 2))
