"""The yardstick's frozen work counts give chip_smoke.py's on fixed
shapes, and each roofline module counts the work of the calls it
records."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from pb import yardstick
from roofline import k1, ltc_rect, shadow_trace


@pytest.mark.parametrize("n_out,tile_bytes,px_bytes",
                         [(2, 8, 0), (4, 8, 0), (2, 4, 0), (2, 8, 96)])
def test_k1_bound(n_out, tile_bytes, px_bytes):
    counts = np.random.default_rng(1).integers(0, 700, 16_320)
    want, _ = chip_smoke.k1_bound(counts, n_out, tile_bytes, px_bytes)
    got = yardstick.k1_bound(int(counts.sum()), counts.shape[0], n_out,
                             tile_bytes, px_bytes)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("n_px,n_lights", [(1920 * 1080, 2), (518_400, 1),
                                           (2_073_600, 5)])
def test_ltc_rect_bound(n_px, n_lights):
    want, _ = chip_smoke.ltc_rect_bound(n_px, n_lights)
    assert yardstick.ltc_rect_bound(n_px, n_lights) == pytest.approx(
        want, rel=1e-12)


def test_shadow_bound():
    table = np.zeros((9_517, 16), np.float32)
    inst = np.zeros((41, 24), np.float32)
    tri = np.zeros((10_444, 9), np.float32)
    counts = types.SimpleNamespace(node_visits=29_800_000,
                                   instance_entries=2_000_000,
                                   triangle_tests=9_000_000)
    want, _ = chip_smoke.shadow_bound(2_073_600, 1_221_973, counts,
                                      torch.as_tensor(table),
                                      torch.as_tensor(inst),
                                      torch.as_tensor(tri))
    n_ops = 12 * 29_800_000 + 30 * 2_000_000 + 40 * 9_000_000
    got = yardstick.shadow_bound(2_073_600, 1_221_973, table.size,
                                 inst.size, tri.size, n_ops=n_ops)
    assert got == pytest.approx(want, rel=1e-12)
    # without a walk, the root tests alone: never above the full count
    assert yardstick.shadow_bound(2_073_600, 1_221_973, table.size,
                                  inst.size, tri.size) <= got


def test_modules_count_recorded_calls():
    counts = torch.tensor([3, 0, 5, 9])
    rec = k1.reduce((None, None, counts), {}, None)
    assert k1.bound_ms({(k1.MODULE, "fine_raster_pairs"): [rec, rec]}) == \
        pytest.approx(2 * yardstick.k1_bound(17, 4, 2))
    nor = torch.zeros(90, 160, 3)
    pts = torch.zeros(2, 4, 3)
    rec = ltc_rect.reduce((nor, None, None, None, pts), {}, None)
    assert rec == (14_400, 2)
    active = torch.tensor([True, False, True])
    walk = shadow_trace.reduce_walk(
        (torch.zeros(5, 16), 2, torch.zeros(1, 24), torch.zeros(7, 9),
         torch.zeros(3, 3)), {"active": active}, None)
    rows = types.SimpleNamespace(top=torch.zeros(40), blas=torch.zeros(3, 8),
                                 tris=torch.zeros(7, 12))
    pack = shadow_trace.reduce_pack(
        (torch.zeros(5, 16), 2, torch.zeros(1, 24), torch.zeros(7, 9)), {},
        rows)
    calls = {(shadow_trace.MODULE, "occluded"): [walk],
             (shadow_trace.MODULE, "pack_rows"): [pack]}
    want = (yardstick.shadow_bound(3, 2, 80, 24, 63)
            + yardstick.shadow_pack_bound(80 + 24 + 63, 40 + 24 + 84, 7))
    assert shadow_trace.bound_ms(calls) == pytest.approx(want)
