"""Card-only checks of the port's hand-written CUDA kernels against their
PyTorch twins, and of the frame on the card against the CPU path. Marked
`cuda`; they skip where torch sees no CUDA device. On the card:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(--noconftest: tests/conftest.py pins JAX to the CPU and imports jax,
which the card's host does not have.)
"""

import numpy as np
import pytest
import torch

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer, build_world
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.passes import cull, raster
from voidin_tpu_torch.passes.raster import RasterConfig

pytestmark = pytest.mark.cuda

CFG = RasterConfig(width=320, height=184, tri_capacity=1 << 15,
                   pair_capacity=1 << 15)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda:0")


def _records(device):
    world, _ = build_world(1000, seed=0)
    scene = world.device(device)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                    aspect=CFG.width / CFG.height).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    setup = raster.triangle_setup(scene.meshes, scene.instances, draws, cam,
                                  CFG, materials=scene.materials)
    return raster.bin_triangles_pairs(setup, CFG)[:3]


def test_fine_raster_kernel_matches_twin(cuda):
    rec, starts, counts = _records(cuda)
    n = t_fr.LAUNCHES
    kd, ki = t_fr.fine_raster_pairs(rec, starts, counts)
    rd, ri = t_fr.fine_raster_pairs_reference(rec, starts, counts)
    torch.cuda.synchronize()
    assert t_fr.LAUNCHES == n + 1
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    assert (ki >= 0).any()


def test_lut_fetch_kernel_matches_twin(cuda):
    g = torch.Generator().manual_seed(0)
    for n_chan in (1, 5, 8):
        tables = [torch.randn(64, 64, generator=g).to(cuda)
                  for _ in range(n_chan)]
        uv = (torch.rand(37, 53, 2, generator=g) * (63 / 64)
              + 0.5 / 64).to(cuda)
        for a, b in zip(t_lut.lut_fetch(tables, uv),
                        t_lut.lut_fetch_reference(tables, uv)):
            assert (a - b).abs().max().item() <= 1e-6


def test_frame_on_card_matches_cpu(cuda):
    world, moving = build_world(1000, seed=0)
    imgs = []
    for device in (cuda, torch.device("cpu")):
        r = Renderer(world.device(device), CFG, moving_ids=moving)
        cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                        aspect=CFG.width / CFG.height)
        for _ in range(3):
            img = r.render(cam)
        assert int(r.aux["overflow"]) == 0
        imgs.append(img.cpu().numpy())
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3
