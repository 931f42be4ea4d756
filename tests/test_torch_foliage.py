"""Port parity: the whole frame of the textured, alpha-masked foliage
scene (tests/test_torch_alpha.py's `foliage_world`: build_world(300) plus
60 chip_smoke.add_foliage cards, 160x96) through the port's Renderer
against the jitted JAX Renderer, with TAA off, with 3 TAA frames and with
the bf16 LUT fetch in both packages (mean abs sRGB diff < 5e-3, the golden
tests' budget, overflow 0); and, with the cut-out made opaque, against the
numpy oracle at tests/test_oracle.py's textured budget of 1.5e-2.
"""

import numpy as np
import pytest
import torch

import bench
import voidin_tpu as vt
from voidin_tpu.framework.renderer import Renderer as JaxRenderer
from voidin_tpu.passes import shading as j_shading

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.framework.renderer import build_world as port_build_world
from voidin_tpu_torch.passes import raster as t_raster
from voidin_tpu_torch.passes import shading as t_shading

from tests.test_torch_alpha import (FH, FW, J_FOLIAGE, _foliage_camera,
                                    _port_cfg, foliage_world)
from tests.test_torch_scene import port_scene, unpermuted_worlds

torch.set_num_threads(2)
BUDGET = 5e-3


@pytest.mark.parametrize("taa,frames,bf16", [(False, 1, False),
                                             (True, 3, False),
                                             (False, 1, True)])
def test_foliage_frame_matches_jax(taa, frames, bf16, monkeypatch):
    monkeypatch.setattr(j_shading, "LTC_LUT_BF16", bf16)
    monkeypatch.setattr(t_shading, "LTC_LUT_BF16", bf16)
    with unpermuted_worlds():
        jw, moving = foliage_world(bench.build_world)
        js = jw.device(tap_blocks=False)
    jr = JaxRenderer(js, J_FOLIAGE, enable_taa=taa, moving_ids=moving)
    r = Renderer(port_scene(js), _port_cfg(J_FOLIAGE), enable_taa=taa,
                 moving_ids=moving)
    assert r.config.alpha_mask and jr.config.alpha_mask
    for _ in range(frames):
        want = np.asarray(jr.render(_foliage_camera(vt)))
        got = r.render(_foliage_camera(pt)).numpy()
        assert int(r.aux["overflow"]) == int(jr.aux["overflow"]) == 0
    assert got.shape == (FH, FW, 3) and np.isfinite(got).all()
    diff = np.abs(got - want).mean()
    print(f"foliage taa={taa} frames={frames} bf16={bf16}: mean abs diff "
          f"vs JAX {diff:.3e}")
    assert diff < BUDGET
    assert got.std() > 0


def test_port_world_builds_the_foliage_scene(monkeypatch):
    """add_foliage on the port's World gives the state it gives on the
    JAX World, and the textured statics are live."""
    from tests.test_torch_scene import _assert_scene_equal

    with unpermuted_worlds():
        jw, _ = foliage_world(bench.build_world)
        pw, _ = foliage_world(port_build_world)
        _assert_scene_equal(jw, pw)
    st = pw.statics()
    assert st["alpha_masked"] and not st["no_normal_maps"]
    assert not st["emissive_const"] and not st["mr_const"]


def test_textured_frame_anchored_to_numpy_oracle():
    """The foliage scene with its cut-out made opaque (normal map, MR and
    emissive textures all live): the port's first frame (no cull, no TAA)
    against the numpy oracle at mean 1.5e-2."""
    from tests import oracle_renderer as orc
    from tests.test_oracle import _assert_anchored

    jw, _ = foliage_world(bench.build_world, opaque=True)
    pw, _ = foliage_world(port_build_world, opaque=True)
    scene = pw.device("cpu")
    assert not scene.alpha_masked and not scene.no_normal_maps
    oracle = orc.render_oracle(jw, _foliage_camera(vt).uniform(), FW, FH)
    # without cull all 360 instances are drawn: ~60k triangles
    cfg = t_raster.RasterConfig(width=FW, height=FH, tri_capacity=1 << 17,
                                pair_capacity=1 << 17)
    r = Renderer(scene, cfg, enable_cull=False, enable_taa=False)
    got = r.render(_foliage_camera(pt)).numpy()
    assert int(r.aux["overflow"]) == 0
    print(f"textured foliage vs oracle: mean abs diff "
          f"{np.abs(got - oracle).mean():.3e}")
    _assert_anchored(got, oracle, mean_budget=1.5e-2, name="port foliage")
