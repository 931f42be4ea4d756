"""Port parity: G-buffer resolve, deferred shading (voidin_tpu_torch.
passes.resolve / shading, with kernel K3's twin) and TAA against the JAX
package on the golden 160x96 scene.

Both packages resolve the very same visibility buffer (the JAX raster's,
carried across as numpy), so the comparison isolates resolve and shade.
The JAX passes run op by op with the LTC fetch through its Pallas kernel
in interpret mode. Tolerances: GBuffer normal_uv / material / depth
bit-exact, albedo / emissive / mr within 1e-6, HDR within 1e-5 relative
(plus 1e-6 absolute for values near 0); the TAA pass, fed the same HDR
frame, G-buffer, jittered camera pair and a seeded history bridged with
frame_state_from_numpy, within 1e-5 relative as well.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster
from voidin_tpu.passes import resolve as j_resolve
from voidin_tpu.passes import shading as j_shading
from voidin_tpu.passes import taa as j_taa
from voidin_tpu.framework.renderer import FrameState as JaxFrameState

import voidin_tpu_torch as pt
from voidin_tpu_torch.core.encoding import as_u32_np
from voidin_tpu_torch.framework.renderer import frame_state_from_numpy
from voidin_tpu_torch.passes import taa as t_taa
from voidin_tpu_torch.passes import resolve as t_resolve
from voidin_tpu_torch.passes import shading as t_shading
from voidin_tpu_torch.passes.gbuffer import VisBuffer

from tests.test_golden import CFG, H, W
from tests.test_torch_raster import T_CFG
from tests.test_torch_scene import (deferred_scene, port_scene,
                                    unpermuted_worlds)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def resolved():
    with unpermuted_worlds() as mp:
        js = deferred_scene(vt).device(tap_blocks=False)
        mp.setattr(j_shading, "LTC_FETCH_PALLAS", "interpret")
        ts = port_scene(js)
        cam = vt.Camera(position=[0, 2, 0], pitch=-18.0,
                        aspect=W / H).uniform()
        draws = j_cull.emit_draws(js.meshes, js.instances, cam)
        vis = jax.jit(
            functools.partial(j_raster.rasterize, config=CFG),
        )(js.meshes, js.instances, draws, cam, materials=js.materials)
        tvis = VisBuffer(
            tri_id=torch.from_numpy(np.array(vis.tri_id)),
            depth=torch.from_numpy(np.array(vis.depth)),
            resolve_rec=torch.from_numpy(np.array(vis.resolve_rec)),
            overflow=torch.tensor(int(vis.overflow)),
        )
        jg, ja = j_resolve.resolve_gbuffer(js, vis, cam, CFG)
        tg, ta = t_resolve.resolve_gbuffer(ts, tvis, T_CFG)
        jh = np.asarray(j_shading.shade(js, jg, cam, aux=ja))
        th = t_shading.shade(ts, tg, cam, ta).numpy()
    return dict(vis=vis, jg=jg, ja=ja, tg=tg, ta=ta, jh=jh, th=th)


def test_gbuffer_exact(resolved):
    jg, tg = resolved["jg"], resolved["tg"]
    assert tuple(tg.normal_uv.shape) == (H, W, 2)
    np.testing.assert_array_equal(np.asarray(jg.normal_uv),
                                  as_u32_np(tg.normal_uv))
    np.testing.assert_array_equal(np.asarray(jg.material),
                                  tg.material.numpy())
    np.testing.assert_array_equal(np.asarray(jg.depth), tg.depth.numpy())
    assert (tg.material.numpy() != 0).sum() > W * H // 2


@pytest.mark.parametrize("field", ["albedo", "emissive", "mr"])
def test_material_fields(resolved, field):
    a = np.asarray(getattr(resolved["ja"], field))
    b = getattr(resolved["ta"], field).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_hdr(resolved):
    jh, th = resolved["jh"], resolved["th"]
    assert th.shape == (H, W, 3) and np.isfinite(th).all()
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    assert th.std() > 0


def test_taa_with_bridged_history(resolved):
    """One TAA pass on a seeded history, moving jittered camera: JAX taa
    (op by op) against the port's on the same HDR frame, the history
    carried across as numpy."""
    rng = np.random.default_rng(5)
    history = rng.uniform(0.0, 1.5, (H, W, 3)).astype(np.float32)
    prev = pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    prev.jitter = np.array([0.3 / W, -0.2 / H], np.float32)
    cam = pt.Camera(position=[0.05, 2, 0], pitch=-18.0, aspect=W / H)
    cam.jitter = np.array([-0.4 / W, 0.1 / H], np.float32)
    cu = cam.uniform(previous=prev.uniform())
    jout, _, _ = j_taa.taa(
        jax.numpy.asarray(resolved["jh"]), resolved["jg"], cu,
        JaxFrameState(history=jax.numpy.asarray(history),
                      history_valid=jax.numpy.asarray(True)))
    state = frame_state_from_numpy(history, True, "cpu")
    tout, tstate, tovf = t_taa.taa(torch.from_numpy(resolved["jh"].copy()),
                                   resolved["tg"], cu, state)
    assert int(tovf) == 0  # the per-pixel fetch has no edge batch
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    assert tstate.history is tout and tstate.history_valid
    assert np.abs(tout.numpy() - resolved["jh"]).mean() > 1e-3
