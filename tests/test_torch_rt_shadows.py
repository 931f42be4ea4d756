"""Port parity: the raytraced-shadow frame (voidin_tpu_torch.passes.
shading.shade_raytraced with the shadow-ray twin, and the Renderer with
enable_rt_shadows) against the JAX package, the golden image and the
numpy oracle, on the CPU at 160x96 / 128x72.

- shade_raytraced: both packages shade one G-buffer and its material
  fields (carried across as numpy) with the same TLAS (the JAX shade runs
  op by op around its traversal loop) at rt_shadow_scale 1 and 2: HDR
  within 1e-5 relative plus 1e-6 absolute (tests/test_torch_shade.py's
  budget).
- The port's frame of tests/test_golden.py's rt_shadows scene within mean
  5e-3 of tests/golden/rt_shadows.png, no ray at the step limit.
- tests/test_oracle.py:135-200's raytraced anchor on the port, with its
  check that the shadows matter.
- tests/test_traverse.py:170-200's scale-2 clause with post off.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.passes import shading as j_shading
from voidin_tpu.passes.gbuffer import GBuffer as JaxGBuffer
from voidin_tpu.passes.resolve import ResolveAux as JaxResolveAux
from voidin_tpu.io.image import load_image

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import mathx
from voidin_tpu_torch.core.encoding import as_u32_np
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.ops import shadow_trace as t_st
from voidin_tpu_torch.passes import cull as t_cull
from voidin_tpu_torch.passes import raster as t_raster
from voidin_tpu_torch.passes import resolve as t_resolve
from voidin_tpu_torch.passes import shading as t_shading
from voidin_tpu_torch.passes.raster import RasterConfig

from tests import oracle_renderer as orc
from tests.test_golden import GOLDEN_DIR, H, W
from tests.test_oracle import _assert_anchored
from tests.test_torch_raster import T_CFG
from tests.test_torch_scene import deferred_scene, port_scene

torch.set_num_threads(2)
GOLDEN_BUDGET = 5e-3


def _golden_camera(pkg):
    return pkg.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)


@pytest.fixture(scope="module")
def resolved():
    """The golden deferred scene with its TLAS, rasterized and resolved
    once (the port's raster and resolve, which tests/test_torch_raster.py
    and test_torch_shade.py hold to JAX's); the G-buffer and material
    fields go to both shades."""
    js = deferred_scene(vt).device(with_tlas=True, tap_blocks=False)
    ts = port_scene(js)
    cam = _golden_camera(vt).uniform()
    draws = t_cull.emit_draws(ts.meshes, ts.instances, cam)
    tvis = t_raster.rasterize(ts.meshes, ts.instances, draws, cam, T_CFG,
                              materials=ts.materials)
    assert int(tvis.overflow) == 0
    tg, ta = t_resolve.resolve_gbuffer(ts, tvis, T_CFG)
    jg = JaxGBuffer(normal_uv=jnp.asarray(as_u32_np(tg.normal_uv)),
                    material=jnp.asarray(tg.material.numpy()),
                    depth=jnp.asarray(tg.depth.numpy()))
    ja = JaxResolveAux(**{k: jnp.asarray(getattr(ta, k).numpy())
                          for k in ("albedo", "emissive", "mr")})
    return dict(js=js, ts=ts, cam=cam, jg=jg, ja=ja, tg=tg, ta=ta)


@pytest.mark.parametrize("scale", [1, 2])
def test_shade_raytraced_matches_jax(resolved, scale, monkeypatch):
    r = resolved
    assert r["ts"].tlas is not None and r["ts"].meshes.bvh_max_leaf <= 3
    jh = np.asarray(j_shading.shade_raytraced(
        r["js"], r["jg"], r["cam"], aux=r["ja"], shadow_scale=scale))
    th, rt = t_shading.shade_raytraced(r["ts"], r["tg"], r["cam"], r["ta"],
                                       shadow_scale=scale)
    th = th.numpy()
    assert th.shape == (H, W, 3) and np.isfinite(th).all()
    assert int(rt["exhausted"]) == 0 and rt["rays"] > 0
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    # the shadows matter: with every ray a miss, the image brightens
    real = t_st.occluded

    def misses(*args, **kwargs):
        res = real(*args, **kwargs)
        return res._replace(hit=torch.zeros_like(res.hit))

    monkeypatch.setattr(t_st, "occluded", misses)
    lit = t_shading.shade_raytraced(r["ts"], r["tg"], r["cam"], r["ta"],
                                    shadow_scale=scale)[0].numpy()
    assert (lit >= th).all() and (lit > th).any(axis=-1).sum() > 20


def test_frame_matches_golden_rt_shadows():
    """tests/test_golden.py's rt_shadows frame on the port's own World
    (BVH built, TLAS) at 160x96."""
    before = t_st.LAUNCHES
    scene = deferred_scene(pt).device("cpu", with_tlas=True)
    r = Renderer(scene, T_CFG, enable_taa=False, enable_rt_shadows=True)
    got = r.render(_golden_camera(pt)).numpy()
    assert int(r.aux["overflow"]) == 0 and int(r.aux["rt_exhausted"]) == 0
    assert int(r.aux["rt_rays"]) > W * H // 4
    assert t_st.LAUNCHES == before  # the CPU runs the twin
    ref = load_image(os.path.join(GOLDEN_DIR, "rt_shadows.png"))
    ref = ref[..., :3].astype(np.float32) / 255.0
    diff = np.abs(np.clip(got, 0, 1) - ref).mean()
    print(f"rt_shadows: mean abs diff vs golden {diff:.3e}")
    assert diff < GOLDEN_BUDGET
    deferred = load_image(os.path.join(GOLDEN_DIR, "deferred.png"))
    assert np.abs(deferred[..., :3] / 255.0 - ref).mean() > 10 * diff


def _oracle_rt_world(pkg):
    """tests/test_oracle.py:146-170's config-5-class scene."""
    from chip_smoke import _mesh_module

    mesh = _mesh_module(pkg)
    w = pkg.World()
    knot = w.meshes.add(mesh.make_torus_knot(segments=48, sides=8))
    sphere = w.meshes.add(mesh.make_uv_sphere(1.0, 4))
    mat = w.materials.add()
    rng = np.random.default_rng(11)
    for i in range(8):
        a = 2 * np.pi * i / 8
        r = 3 + (i % 3)
        t = mathx.from_translation(
            [r * np.cos(a), 0.5 + (i % 3) * 1.2, -8 + r * np.sin(a)]
        ) @ mathx.from_scale(float(rng.uniform(0.6, 1.0)))
        w.instances.add(np.asarray(t), knot if i % 2 else sphere, mat)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1.0, -8])
                   @ mathx.from_scale(30.0)),
        mesh.HORIZONTAL_PLANE_MESH, mat)
    w.lights.add_point_light([8, 4, -2], 35.0, [0.7, 0.68, 0.6])
    return w


def test_frame_anchored_to_raytraced_oracle(monkeypatch):
    """The port's raytraced frame (no cull, no TAA) against the numpy
    brute-force occlusion oracle, and the same frame with every shadow ray
    a miss must differ from it: a dead traversal trips both. At 128x72
    (tests/test_oracle.py runs 192x108): the numpy oracle's time goes
    with the pixels."""
    w_, h_ = 128, 72
    jw = _oracle_rt_world(vt)
    scene = _oracle_rt_world(pt).device("cpu", with_tlas=True)
    cfg = RasterConfig(width=w_, height=h_, tri_capacity=1 << 15,
                       pair_capacity=1 << 16)
    cam = pt.Camera(position=[0, 4, 3], pitch=-22.0, aspect=w_ / h_)
    def render():
        r = Renderer(scene, cfg, enable_cull=False, enable_taa=False,
                     enable_rt_shadows=True)
        img = r.render(cam).numpy()
        assert int(r.aux["overflow"]) == 0
        assert int(r.aux["rt_exhausted"]) == 0
        return img

    prod = render()
    cu = vt.Camera(position=[0, 4, 3], pitch=-22.0,
                   aspect=w_ / h_).uniform()
    oracle = orc.render_oracle_raytraced(jw, cu, w_, h_)
    _assert_anchored(prod, oracle, name="port raytraced")
    real = t_st.occluded
    monkeypatch.setattr(t_st, "occluded", lambda *a, **k: real(
        *a, **k)._replace(hit=torch.zeros(a[4].shape[0], dtype=torch.bool)))
    d = np.abs(prod - render())
    print(f"port raytraced vs oracle: no-shadow diff mean {d.mean():.3e}, "
          f"share > 0.01 {(d.sum(-1) > 0.01).mean():.4f}")
    assert d.mean() > 5e-4 and (d.sum(-1) > 0.01).mean() > 0.02


def test_half_res_shadow_rays_close_to_full_res():
    """rt_shadow_scale 2 against 1, post off (tests/test_traverse.py:
    170-200): >= 90% of the pixels identical, the top-left sample of every
    2x2 block exact."""
    scene = deferred_scene(pt).device("cpu", with_tlas=True)
    cam = _golden_camera(pt)
    img = {s: Renderer(scene, T_CFG, enable_taa=False, enable_post=False,
                       enable_rt_shadows=True, rt_shadow_scale=s
                       ).render(cam).numpy() for s in (1, 2)}
    same = (img[1] == img[2]).all(axis=-1)
    assert same.mean() > 0.90, same.mean()
    assert (img[1][::2, ::2] == img[2][::2, ::2]).all(axis=-1).mean() > 0.999
    assert same.mean() < 1.0  # the shadow edges coarsen


def test_rt_frame_without_tlas_raises():
    r = Renderer(deferred_scene(pt).device("cpu"), T_CFG,
                 enable_rt_shadows=True)
    with pytest.raises(ValueError, match="with_tlas"):
        r.render(_golden_camera(pt))
