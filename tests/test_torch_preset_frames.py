"""Port parity: frames of the BASELINE presets through the port's Renderer
against the JAX package's Renderer (jitted, Pallas kernels in interpret
mode). The oracle anchors of the presets are in
tests/test_torch_preset_oracle.py.

- Configs 1, 3, 6 and 7 (one frame) and 4 (two TAA frames posed by
  clapper_joint_mats(0.0) and (0.7), its moving instances animated) at
  160x96 or 256x144, each Renderer wired from its Preset: sRGB mean abs
  diff < 5e-3 (tests/test_golden.py's budget), overflow 0 in both. Both
  packages build their own World with the numpy BVH builder and texture
  packer, and the textured configs 6 and 7 also with the native ones
  (tests/test_torch_presets.py holds the two Worlds equal word for word).
"""

import numpy as np
import pytest
import torch

from voidin_tpu.framework import presets as j_presets
from voidin_tpu.framework.renderer import Renderer as JaxRenderer
from voidin_tpu.passes.raster import RasterConfig as JaxRasterConfig

from voidin_tpu_torch.framework import presets as t_presets
from voidin_tpu_torch.framework.renderer import Renderer
from voidin_tpu_torch.passes.raster import RasterConfig

from tests.test_torch_scene import load_jax_native

torch.set_num_threads(2)
BUDGET = 5e-3

# config -> (width, height, preset arguments, capacities): the sizes and
# capacities of the JAX package's own tests of each preset
# (tests/test_oracle.py:95 and :117, tests/test_stress.py:52 and :124);
# config 4 at tests/test_skin.py:255's size with its preset's triangle
# capacity (its 24 spheres draw ~54k triangles, over that test's 2^13).
CASES = {
    1: (256, 144, {}, dict(tri_capacity=1 << 17, pair_capacity=1 << 18)),
    3: (256, 144, {}, dict(tri_capacity=1 << 17, pair_capacity=1 << 18)),
    4: (160, 96, {}, dict(tri_capacity=1 << 16, pair_capacity=1 << 16)),
    6: (160, 96, dict(base_size=64, n_textures=12, n_knots=2,
                      knot_detail=(48, 8)),
        dict(tri_capacity=1 << 14, pair_capacity=1 << 16)),
    7: (256, 144, dict(n_textures=8, base_size=64, detail=0.15),
        dict(tri_capacity=1 << 15, pair_capacity=1 << 17)),
}


@pytest.fixture
def host_builders(request, monkeypatch):
    """Both packages on the numpy BVH builder and texture packer
    (VOIDIN_NATIVE=0, read by both at each build), or both on their
    native ones (the default); indirect, by the test's parameter."""
    if request.param == "numpy":
        monkeypatch.setenv("VOIDIN_NATIVE", "0")
    else:
        load_jax_native()
    return request.param


def _renderers(n):
    """(JAX Renderer, port Renderer, JAX preset, port preset) of config
    `n` at its CASES size, each wired from its own Preset."""
    w, h, kwargs, caps = CASES[n]
    jp = j_presets.PRESETS[n](w / h, **kwargs)
    tp = t_presets.PRESETS[n](w / h, **kwargs)
    flags = dict(enable_cull=tp.enable_cull, enable_taa=tp.enable_taa,
                 moving_ids=np.asarray(tp.moving_ids, np.int32))
    jr = JaxRenderer(jp.world.device(tap_blocks=False),
                     JaxRasterConfig(width=w, height=h, interpret=True,
                                     **caps), **flags)
    tr = Renderer(tp.world.device("cpu"),
                  RasterConfig(width=w, height=h, **caps), **flags)
    return jr, tr, jp, tp


# the textured configs 6 and 7 also on the native packers, whose deepest
# mips differ from numpy's (the other presets hold 1x1 textures only)
@pytest.mark.parametrize("n, host_builders",
                         [(n, "numpy") for n in sorted(CASES)]
                         + [(6, "native"), (7, "native")],
                         indirect=["host_builders"])
def test_preset_frame_matches_jax(n, host_builders):
    jr, tr, jp, tp = _renderers(n)
    times = (0.0, 0.7) if n == 4 else (None,)
    for t in times:
        jm = None if t is None else t_presets.clapper_joint_mats(t)
        want = np.asarray(jr.render(jp.camera, joint_mats=jm))
        got = tr.render(tp.camera, joint_mats=jm).numpy()
        assert int(jr.aux["overflow"]) == 0
        assert int(tr.aux["overflow"]) == 0
    assert np.isfinite(got).all() and got.std() > 0.02
    diff = float(np.abs(got - want).mean())
    print(f"config {n} {got.shape[1]}x{got.shape[0]} ({len(times)} "
          f"frame(s)): mean abs diff vs JAX {diff:.3e}")
    assert diff < BUDGET
