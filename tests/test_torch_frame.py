"""Port parity: the whole frame through voidin_tpu_torch's Renderer
against the JAX package's Renderer (jitted, Pallas kernels in interpret
mode) and against the checked-in goldens, on the golden 160x96 scene.

Budget: sRGB mean abs diff < 5e-3, the golden tests' own budget
(tests/test_golden.py:217); overflow must be 0. The JAX frame is one jitted
program whose multiply-adds XLA fuses into FMAs, so the port agrees with it
to rounding, not bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.framework.renderer import Renderer as JaxRenderer
from voidin_tpu.io.image import load_image

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.passes.raster import RasterConfig

from tests.test_golden import CFG, GOLDEN_DIR, H, W
from tests.test_torch_raster import T_CFG
from tests.test_torch_scene import (deferred_scene, port_scene,
                                    unpermuted_worlds)

torch.set_num_threads(2)
BUDGET = 5e-3


@pytest.mark.parametrize("golden,taa,frames", [("deferred", False, 1),
                                               ("taa3", True, 3)])
def test_frame_matches_jax_and_golden(golden, taa, frames):
    with unpermuted_worlds():
        js = deferred_scene(vt).device(tap_blocks=False)
    jr = JaxRenderer(js, CFG, enable_taa=taa)
    r = Renderer(port_scene(js), T_CFG, enable_taa=taa)
    jcam = vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    cam = pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    for _ in range(frames):
        want = np.asarray(jr.render(jcam))
        got = r.render(cam)
        assert int(r.aux["overflow"]) == 0
    got = got.numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    vs_jax = np.abs(got - want).mean()
    ref = load_image(os.path.join(GOLDEN_DIR, f"{golden}.png"))
    ref = ref[..., :3].astype(np.float32) / 255.0
    vs_golden = np.abs(np.clip(got, 0, 1) - ref).mean()
    print(f"{golden}: mean abs diff vs JAX {vs_jax:.3e}, vs golden "
          f"{vs_golden:.3e}")
    assert vs_jax < BUDGET
    assert vs_golden < BUDGET


def test_frame_without_post_matches_jax():
    """enable_post=False (the frame is the sRGB of the HDR, no sharpen and
    no tonemap) in both Renderers on the golden deferred scene, TAA off;
    post-processing does change the frame."""
    with unpermuted_worlds():
        js = deferred_scene(vt).device(tap_blocks=False)
    want = np.asarray(JaxRenderer(js, CFG, enable_taa=False,
                                  enable_post=False).render(
        vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)))
    cam = pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    r = Renderer(port_scene(js), T_CFG, enable_taa=False, enable_post=False)
    got = r.render(cam).numpy()
    post = Renderer(port_scene(js), T_CFG, enable_taa=False).render(
        cam).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert int(r.aux["overflow"]) == 0
    vs_jax = np.abs(got - want).mean()
    print(f"no post: mean abs diff vs JAX {vs_jax:.3e}")
    assert vs_jax < BUDGET
    assert np.abs(got - post).mean() > BUDGET


def test_port_world_renders_like_bridged_scene():
    """The port's own World gives the frame the bridged JAX state gives."""
    with unpermuted_worlds():
        bridged = port_scene(deferred_scene(vt).device(tap_blocks=False))
        own = deferred_scene(pt).device("cpu")
    cam = pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    a = Renderer(bridged, T_CFG, enable_taa=False).render(cam)
    b = Renderer(own, T_CFG, enable_taa=False).render(cam)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_frame_480p_matches_golden():
    """854x480 (test_golden.py's compiled-path golden): binning and mip
    LODs at a size where they are non-trivial."""
    w, h = 854, 480
    cfg = RasterConfig(width=w, height=h, tri_capacity=1 << 15,
                       pair_capacity=1 << 17)
    r = Renderer(deferred_scene(pt).device("cpu"), cfg, enable_taa=False)
    got = r.render(pt.Camera(position=[0, 2, 0], pitch=-18.0,
                             aspect=w / h)).numpy()
    assert int(r.aux["overflow"]) == 0
    ref = load_image(os.path.join(GOLDEN_DIR, "deferred_480p.png"))
    ref = ref[..., :3].astype(np.float32) / 255.0
    diff = np.abs(np.clip(got, 0, 1) - ref).mean()
    print(f"deferred_480p: mean abs diff vs golden {diff:.3e}")
    assert diff < BUDGET


def test_frame_anchored_to_numpy_oracle():
    """The port's first frame (no cull, no TAA) against the independent
    numpy oracle of the reference semantics, at the oracle test's budget
    (tests/test_oracle.py)."""
    from tests import oracle_renderer as orc
    from tests.test_oracle import _assert_anchored

    w = deferred_scene(vt)
    cu = vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H).uniform()
    oracle = orc.render_oracle(w, cu, W, H)
    r = Renderer(deferred_scene(pt).device("cpu"), T_CFG, enable_cull=False,
                 enable_taa=False)
    got = r.render(pt.Camera(position=[0, 2, 0], pitch=-18.0,
                             aspect=W / H)).numpy()
    assert int(r.aux["overflow"]) == 0
    _assert_anchored(got, oracle, name="port deferred")
