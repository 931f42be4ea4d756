"""The Renderer options the port once refused: area_light_scale (the
JAX package's documented deviation, shading.py:416-484) and slim_rec on a
scene outside its envelope (JAX renderer.py:309-330), on the golden
deferred scene at 160x96; and the resampling helpers area_light_scale
runs (core/fastmath.py: _bilinear_matrix, upsample_bilinear_mm,
subsample_mm) against the JAX package's.

Budgets: a port frame against the JAX frame, mean 5e-3
(tests/test_torch_frame.py); the area_light_scale=2 frame against the
full-resolution one, tests/test_ltc.py:394-401's mean 5e-3 and 0.99
quantile 0.12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.core import fastmath as j_fastmath
from voidin_tpu.framework.renderer import Renderer as JaxRenderer

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import fastmath
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.ops import ltc_rect

from tests.test_golden import CFG, H, W
from tests.test_torch_raster import T_CFG
from tests.test_torch_scene import (deferred_scene, port_scene,
                                    unpermuted_worlds)

torch.set_num_threads(2)
BUDGET = 5e-3
Q99_BUDGET = 0.12


def _cams():
    return (vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H),
            pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H))


@pytest.fixture(scope="module")
def golden():
    """The golden deferred scene, JAX's SceneData and the port's copy."""
    with unpermuted_worlds():
        js = deferred_scene(vt).device(tap_blocks=False)
    return js, port_scene(js)


def test_area_light_scale_matches_jax(golden):
    """area_light_scale=2: the port's frame within the frame budget of the
    JAX package's (both the documented deviation)."""
    js, ps = golden
    jcam, cam = _cams()
    want = np.asarray(JaxRenderer(js, CFG, enable_taa=False,
                                  area_light_scale=2).render(jcam))
    r = Renderer(ps, T_CFG, enable_taa=False, area_light_scale=2)
    got = r.render(cam).numpy()
    assert int(r.aux["overflow"]) == 0
    diff = np.abs(got - want).mean()
    print(f"area_light_scale=2: mean abs diff vs JAX {diff:.3e}")
    assert diff < BUDGET


def test_half_res_area_lights_close_to_full_res(golden):
    """tests/test_ltc.py:374 on the port: the scale-2 frame stays close to
    the full-resolution frame, and differs from it."""
    _, ps = golden
    _, cam = _cams()
    img1 = Renderer(ps, T_CFG, enable_taa=False).render(cam).numpy()
    img2 = Renderer(ps, T_CFG, enable_taa=False,
                    area_light_scale=2).render(cam).numpy()
    diff = np.abs(img1 - img2)
    print(f"scale 2 vs 1: mean {diff.mean():.3e}, q99 "
          f"{np.quantile(diff, 0.99):.3e}")
    assert 0 < diff.mean() < BUDGET
    assert np.quantile(diff, 0.99) < Q99_BUDGET


@pytest.mark.parametrize("s", [2, 3])
def test_area_light_scale_runs_ltc_once_on_the_subsampled_grid(golden,
                                                               monkeypatch,
                                                               s):
    """The fused LTC entry point runs once a frame, on the (ceil(H/s),
    ceil(W/s)) fields: every s-th pixel of the full-resolution frame's
    own fields."""
    _, ps = golden
    _, cam = _cams()
    seen = []
    real = ltc_rect.ltc_rect_terms

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(ltc_rect, "ltc_rect_terms", spy)
    Renderer(ps, T_CFG, enable_taa=False).render(cam)
    Renderer(ps, T_CFG, enable_taa=False, area_light_scale=s).render(cam)
    assert len(seen) == 2
    full, sub = seen
    assert tuple(sub[3].shape) == (-(-H // s), -(-W // s))
    for f, g in zip(full[:4], sub[:4]):
        np.testing.assert_array_equal(g.numpy(), f[::s, ::s].numpy())


def test_upsample_and_subsample_match_jax():
    """upsample_bilinear_mm (two taps a row, rows then columns) against
    the JAX package's matrix products, and the port's own
    _bilinear_matrix; subsample_mm exactly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for s, (h, w) in ((2, (48, 80)), (3, (32, 54)), (4, (24, 40))):
        x = rng.normal(size=(-(-h // s), -(-w // s), 3)).astype(np.float32)
        got = fastmath.upsample_bilinear_mm(torch.from_numpy(x), s, h,
                                            w).numpy()
        want = np.asarray(j_fastmath.upsample_bilinear_mm(jnp.asarray(x), s,
                                                          h, w))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        ah = fastmath._bilinear_matrix(h, x.shape[0], s)
        aw = fastmath._bilinear_matrix(w, x.shape[1], s)
        np.testing.assert_array_equal(
            ah, j_fastmath._bilinear_matrix(h, x.shape[0], s))
        mm = np.einsum("ij,jkc,lk->ilc", ah.astype(np.float64), x, aw)
        np.testing.assert_allclose(got, mm, rtol=1e-6, atol=1e-6)
        big = rng.normal(size=(h, w, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            fastmath.subsample_mm(torch.from_numpy(big), s).numpy(),
            np.asarray(j_fastmath.subsample_mm(jnp.asarray(big), s)))


def test_upsample_row_windows_equal_the_whole():
    """A window of output rows from its subsampled rows (one halo row each
    side) gives the words of those rows of the whole upsample."""
    rng = np.random.default_rng(4)
    for s, h, w in ((2, 64, 40), (3, 63, 30)):
        x = torch.from_numpy(rng.normal(
            size=(-(-h // s), -(-w // s), 3)).astype(np.float32))
        whole = fastmath.upsample_bilinear_mm(x, s, h, w)
        for r0, r1 in ((0, 2 * s), (s, 5 * s), (2 * s, h)):
            k0, k1 = max(0, r0 // s - 1), min(x.shape[0], -(-r1 // s) + 1)
            a = k0 * s
            part = fastmath.upsample_bilinear_mm(x[k0:k1], s, r1 - a, w,
                                                 row0=a, height=h)
            np.testing.assert_array_equal(part[r0 - a:].numpy(),
                                          whole[r0:r1].numpy())
        with pytest.raises(ValueError):
            fastmath.upsample_bilinear_mm(x, s, 4, w, row0=1, height=h)


def _normal_mapped_world(pkg):
    """The golden deferred scene plus a normal-mapped sphere: outside
    slim_rec's envelope."""
    w = deferred_scene(pkg)
    yy, xx = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    nmap = np.stack([128 + 60 * np.sin(xx), 128 + 60 * np.cos(yy),
                     np.full_like(xx, 230)], -1).astype(np.uint8)
    mat = w.materials.add(albedo=w.textures.add(
        np.array([[[90, 160, 220, 255]]], np.uint8), srgb=True),
        normal=w.textures.add(nmap))
    w.instances.add(np.asarray(pkg.core.mathx.from_translation(
        [0.0, 0.6, -4.5])), 3, mat)  # SPHERE_10_MESH
    return w


def test_slim_rec_outside_its_envelope_falls_back(golden):
    """slim_rec on a normal-mapped scene: the Renderer falls back as the
    JAX package's does (renderer.py:315-333), to fused_resolve_rec +
    inst_rec_f16 with kernel_payload off. The frame equals the port's
    frame of that config word for word and JAX's fallback frame within
    the frame budget, and its G-buffer has the words of JAX's resolve
    under that config; inside the envelope slim_rec stays on."""
    from voidin_tpu.passes import resolve as j_resolve

    from voidin_tpu_torch.passes import cull, raster, resolve

    from tests.test_torch_records import assert_gbuffer_words, jax_vis

    with unpermuted_worlds():
        js = _normal_mapped_world(vt).device(tap_blocks=False)
    assert not js.no_normal_maps
    ps = port_scene(js)
    jcam, cam = _cams()
    slim = dataclasses.replace(T_CFG, slim_rec=True, kernel_payload=True)
    jax_r = JaxRenderer(js, dataclasses.replace(CFG, slim_rec=True),
                        enable_taa=False)
    r = Renderer(ps, slim, enable_taa=False)
    fallback = dict(slim_rec=False, kernel_payload=False,
                    fused_resolve_rec=True, inst_rec_f16=True)
    for k, v in fallback.items():
        assert getattr(r.config, k) == v, k
        assert getattr(jax_r.config, k, False) == v, k
    got = r.render(cam).numpy()
    assert int(r.aux["overflow"]) == 0
    explicit = dataclasses.replace(T_CFG, fused_resolve_rec=True,
                                   inst_rec_f16=True)
    np.testing.assert_array_equal(
        got, Renderer(ps, explicit, enable_taa=False).render(cam).numpy())
    want = np.asarray(jax_r.render(jcam))
    diff = np.abs(got - want).mean()
    print(f"slim fallback: mean abs diff vs JAX {diff:.3e}")
    assert diff < BUDGET
    uniform = cam.uniform()
    draws = cull.emit_draws(ps.meshes, ps.instances, uniform)
    vis = raster.rasterize(ps.meshes, ps.instances, draws, uniform,
                           r.config, materials=ps.materials)
    assert vis.resolve_rec.shape[-1] == 24
    jg, _ = j_resolve.resolve_gbuffer(
        js, jax_vis(vis), jcam.uniform(), jax_r.config)
    tg, _ = resolve.resolve_gbuffer(ps, vis, r.config)
    assert_gbuffer_words(jg, tg)
    assert Renderer(golden[1], slim, enable_taa=False).config.slim_rec
