"""The oracle anchors of tests/test_oracle.py on the port's presets: the
port's frames against the numpy oracle (tests/oracle_renderer.py) of the
same scene at tests/test_oracle.py's budgets: config 1 (:95, mean 1e-2),
config 7 (:265, 1.5e-2) and the two jittered TAA frames of the golden
scene (:213, 1e-2). The oracle reads the JAX preset's World, which equals
the port's word for word (tests/test_torch_presets.py).
"""

import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.framework import presets as j_presets

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework import presets as t_presets
from voidin_tpu_torch.framework.renderer import (FrameState, Globals,
                                                 Renderer, render_frame)
from voidin_tpu_torch.passes.raster import RasterConfig

from tests import oracle_renderer as orc
from tests.test_oracle import _assert_anchored
from tests.test_torch_preset_frames import CASES

torch.set_num_threads(2)


def _port_first_frame(p, w, h, caps, enable_cull):
    r = Renderer(p.world.device("cpu"), RasterConfig(width=w, height=h,
                                                    **caps),
                 enable_cull=enable_cull, enable_taa=False)
    img = r.render(p.camera).numpy()
    assert int(r.aux["overflow"]) == 0
    return img


@pytest.mark.parametrize("n,budget", [(1, 1e-2), (7, 1.5e-2)])
def test_preset_anchored_to_numpy_oracle(n, budget):
    """tests/test_oracle.py's config 1 and config 7 anchors on the port:
    the first frame (TAA off) against the oracle of the JAX preset's World
    (the same World, tests/test_torch_presets.py)."""
    w, h, kwargs, caps = CASES[n]
    jp = j_presets.PRESETS[n](w / h, **kwargs)
    tp = t_presets.PRESETS[n](w / h, **kwargs)
    oracle = orc.render_oracle(jp.world, jp.camera.uniform(), w, h)
    got = _port_first_frame(tp, w, h, caps, enable_cull=tp.enable_cull)
    print(f"config {n} vs the numpy oracle: mean abs diff "
          f"{np.abs(got - oracle).mean():.3e} (budget {budget})")
    _assert_anchored(got, oracle, mean_budget=budget, name=f"port config {n}")


def test_taa_two_frames_anchored_to_numpy_oracle():
    """tests/test_oracle.py:213 on the port: frame 0 seeds the history,
    frame 1 renders at another sub-pixel jitter with the previous camera;
    the TAA resolve against the oracle's reproject + clamp + blend."""
    from tests.test_golden import CFG, H, W
    from tests.test_torch_scene import deferred_scene

    cam = pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    j0 = np.array([0.25 / W, -0.33 / H], np.float32) * 2.0
    j1 = np.array([-0.4 / W, 0.2 / H], np.float32) * 2.0
    cam.jitter = j0
    cu0 = cam.uniform()
    cam.jitter = j1
    cu1 = cam.uniform(previous=cu0)
    jcam = vt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=W / H)
    jcam.jitter = j0
    ju0 = jcam.uniform()
    jcam.jitter = j1
    ju1 = jcam.uniform(previous=ju0)

    cfg = RasterConfig(width=W, height=H, tri_capacity=CFG.tri_capacity,
                       pair_capacity=CFG.pair_capacity)
    scene = deferred_scene(pt).device("cpu")
    state = FrameState.initial(W, H, "cpu")
    g = Globals.make(W, H, frame=0, time=0.0, dt=0.0)
    mov = torch.zeros(0, dtype=torch.int32)
    imgs = []
    for cu in (cu0, cu1):
        img, state, _, aux = render_frame(scene, cu, g, state, mov, cfg,
                                          enable_cull=False, enable_taa=True)
        assert int(aux["overflow"]) == 0
        imgs.append(img.numpy())
    oracle = orc.render_oracle_taa(deferred_scene(vt), [ju0, ju1], W, H)
    print(f"two TAA frames vs the numpy oracle: mean abs diff "
          f"{np.abs(imgs[1] - oracle).mean():.3e} (budget 1e-2)")
    _assert_anchored(imgs[1], oracle, name="port taa_two_frames")
    assert np.abs(imgs[1] - imgs[0]).mean() > 1e-4
