"""Card-only checks of the port's hand-written CUDA kernels (K1 base,
track2 and payload; K2 base and track2; K3 f32 and bf16) against their
PyTorch twins, and of the frame on the card against the CPU path, on the
pair and block paths and with slim_rec + kernel_payload. Marked
`cuda`; they skip where torch sees no CUDA device. On the card:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(--noconftest: tests/conftest.py pins JAX to the CPU and imports jax,
which the card's host does not have.)
"""

import dataclasses

import numpy as np
import pytest
import torch

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework.renderer import Renderer, build_world
from voidin_tpu_torch.ops import fine_raster as t_fr
from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.passes import cull, raster, resolve
from voidin_tpu_torch.passes.raster import RasterConfig

from chip_smoke import add_foliage

pytestmark = pytest.mark.cuda

CFG = RasterConfig(width=320, height=184, tri_capacity=1 << 15,
                   pair_capacity=1 << 15)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda:0")


def _foliage_world():
    world, moving = build_world(1000, seed=0)
    add_foliage(world, 300, seed=1)
    return world, moving


def _setup(device, world=None, cfg=CFG):
    world = world or build_world(1000, seed=0)[0]
    scene = world.device(device)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                    aspect=cfg.width / cfg.height).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    inst_rec = resolve._inst_rec_f16(scene) if cfg.slim_rec else None
    return raster.triangle_setup(scene.meshes, scene.instances, draws, cam,
                                 cfg, materials=scene.materials,
                                 inst_rec=inst_rec)


def _records(device, world=None):
    return raster.bin_triangles_pairs(_setup(device, world), CFG)[:3]


def _blocks(device, world=None):
    cfg = dataclasses.replace(CFG, backend="xla", tile_tri_capacity=1024)
    blocks, counts, _ = raster.bin_triangles(_setup(device, world, cfg), cfg)
    assert int(counts.max()) > 128  # a tile spans several staged slices
    return blocks, counts


def test_fine_raster_kernel_matches_twin(cuda):
    rec, starts, counts = _records(cuda)
    n = t_fr.LAUNCHES
    kd, ki = t_fr.fine_raster_pairs(rec, starts, counts)
    rd, ri = t_fr.fine_raster_pairs_reference(rec, starts, counts)
    torch.cuda.synchronize()
    assert t_fr.LAUNCHES == n + 1
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    assert (ki >= 0).any()


def test_fine_raster_track2_kernel_matches_twin(cuda):
    rec, starts, counts = _records(cuda, _foliage_world()[0])
    n, n2 = t_fr.LAUNCHES, t_fr.LAUNCHES_TRACK2
    outs = t_fr.fine_raster_pairs(rec, starts, counts, track2=True)
    refs = t_fr.fine_raster_pairs_reference(rec, starts, counts, track2=True)
    torch.cuda.synchronize()
    assert (t_fr.LAUNCHES, t_fr.LAUNCHES_TRACK2) == (n, n2 + 1)
    for a, b in zip(outs, refs):
        assert torch.equal(a, b)
    assert (outs[3] >= 0).any()


@pytest.mark.parametrize("masked", [False, True])
def test_fine_raster_blocks_kernel_matches_twin(cuda, masked):
    blocks, counts = _blocks(cuda, _foliage_world()[0] if masked else None)
    names = ("LAUNCHES_BLOCKS", "LAUNCHES_BLOCKS_TRACK2")
    before = [getattr(t_fr, n) for n in names]
    outs = t_fr.fine_raster_blocks(blocks, counts, track2=masked)
    refs = t_fr.fine_raster_blocks_reference(blocks, counts, track2=masked)
    torch.cuda.synchronize()
    after = [getattr(t_fr, n) for n in names]
    assert after == [before[0] + (not masked), before[1] + masked]
    assert len(outs) == (4 if masked else 2)
    for a, b in zip(outs, refs):
        assert torch.equal(a, b)
    assert (outs[-1] >= 0).any()


@pytest.mark.parametrize("track2", [False, True])
def test_fine_raster_payload_kernel_matches_twin(cuda, track2):
    """K1's payload variant, alone and with track2 (all four template
    combinations are built; the Renderer runs payload without track2)."""
    cfg = dataclasses.replace(CFG, slim_rec=True, kernel_payload=True)
    setup = _setup(cuda, _foliage_world()[0] if track2 else None, cfg)
    rec, starts, counts, _ = raster.bin_triangles_pairs(setup, cfg)
    payload = raster._pair_payload_stream(rec, setup["resolve_rec"])
    n = t_fr.LAUNCHES_PAYLOAD
    outs = t_fr.fine_raster_pairs(rec, starts, counts, track2=track2,
                                  payload=payload)
    refs = t_fr.fine_raster_pairs_reference(rec, starts, counts,
                                            track2=track2, payload=payload)
    torch.cuda.synchronize()
    assert t_fr.LAUNCHES_PAYLOAD == n + 1
    assert len(outs) == (5 if track2 else 3)
    for a, b in zip(outs, refs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _, tri_id = raster._untile(outs[0], outs[1], cfg)
    tri_id = tri_id[:cfg.height, :cfg.width]
    img = raster._untile_payload(outs[-1], tri_id, setup["resolve_rec"],
                                 cfg)
    want = setup["resolve_rec"][torch.clamp(tri_id.long(), min=0)]
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))
    assert (tri_id >= 0).any()


@pytest.mark.parametrize("bf16", [False, True])
def test_lut_fetch_kernel_matches_twin(cuda, bf16):
    g = torch.Generator().manual_seed(0)
    for n_chan in (1, 5, 8):
        tables = [torch.randn(64, 64, generator=g).to(cuda)
                  for _ in range(n_chan)]
        uv = (torch.rand(37, 53, 2, generator=g) * (63 / 64)
              + 0.5 / 64).to(cuda)
        uv[0, :2] = torch.tensor([[0.0, 0.0], [1.0, 1.0]]) * (63 / 64) \
            + 0.5 / 64
        for a, b in zip(t_lut.lut_fetch(tables, uv, bf16=bf16),
                        t_lut.lut_fetch_reference(tables, uv, bf16=bf16)):
            assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.parametrize("masked,options", [
    (False, {}), (True, {}), (False, dict(backend="xla",
                                          tile_tri_capacity=1024)),
    (True, dict(backend="xla", tile_tri_capacity=1024)),
    (False, dict(slim_rec=True, kernel_payload=True)),
])
def test_frame_on_card_matches_cpu(cuda, masked, options):
    world, moving = _foliage_world() if masked else build_world(1000, seed=0)
    cfg = dataclasses.replace(CFG, **options)
    imgs = []
    for device in (cuda, torch.device("cpu")):
        r = Renderer(world.device(device), cfg, moving_ids=moving)
        assert r.config.alpha_mask == masked
        cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                        aspect=CFG.width / CFG.height)
        for _ in range(3):
            img = r.render(cam)
        assert int(r.aux["overflow"]) == 0
        imgs.append(img.cpu().numpy())
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3
