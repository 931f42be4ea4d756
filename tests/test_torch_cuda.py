"""Card-only checks of the port's hand-written CUDA kernels (K1 base,
track2 and payload, also on hand-built record streams at each staging
edge; K2 base and track2, also on the adversarial block sets of
chip_smoke.block_edge_set; K3 f32 and bf16; the fused LTC rect kernel f32
and bf16, and that it launches nothing on empty inputs; the shadow-ray
kernel on the golden rt_shadows frame's rays at both scales and on the
adversarial ray sets of chip_smoke.shadow_edge_case; the closest-hit
kernel on those sets, on a tree deeper than its stack and on the
bvh_trace example's primary rays with a step limit and per-ray t_max;
K3 on a ring disk's horizon uvs; the fused LTC ring kernel f32 and bf16,
one- and two-sided) against their PyTorch twins, and of
the frame on the card against the CPU path, on the pair and block paths,
with slim_rec + kernel_payload, with raytraced shadows, skinned, for the
ring light, for the presets (configs 4 and 7) and for the imported glTF
scene; the App path (examples/model.py's scene through App.step, launches
and the resize) on the card against the CPU, its recorded MJPEG-AVI read
back by the port's JPEG decoder, and the profiler's CUDA-event timing;
the native texture packer on the card's host. Marked
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
from voidin_tpu_torch.ops import ltc_rect as t_ltc
from voidin_tpu_torch.ops import ltc_ring as t_ring
from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.passes import cull, raster, resolve
from voidin_tpu_torch.passes import shading as t_shading
from voidin_tpu_torch.passes.raster import RasterConfig
from voidin_tpu_torch.scene.ltc import load_ltc_tables

from chip_smoke import BIG_BLOCK_EDGE_SET, BLOCK_EDGE_SETS, \
    SHADOW_EDGE_CASES, add_foliage, block_edge_set, \
    closest_hit_check, config5_preset, frame_shadow_rays, golden_scene, \
    knot_joint_mats, preset_renderer, shadow_edge_case, shadow_trace_check, \
    staircase_case
from voidin_tpu_torch.examples import bvh_trace, ring_light
from voidin_tpu_torch.ops import closest_hit as t_ch
from voidin_tpu_torch.ops import shadow_trace as t_st
from voidin_tpu_torch.rt import traverse as t_trav

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
@pytest.mark.parametrize("name", BLOCK_EDGE_SETS + (BIG_BLOCK_EDGE_SET,))
def test_fine_raster_blocks_kernel_edge_sets(cuda, name, track2):
    """K2 on the adversarial block sets (every K, count, tile number, tie,
    NaN and dead record chip_smoke.block_edge_set builds, and the set with
    more than 64 tiles a resident block): every output word equals the
    twin's."""
    blocks, counts = (torch.from_numpy(a).to(cuda)
                      for a in block_edge_set(name))
    outs = t_fr.fine_raster_blocks(blocks, counts, track2=track2)
    torch.cuda.synchronize()
    refs = t_fr.fine_raster_blocks_reference(blocks, counts, track2=track2)
    assert len(outs) == len(refs) == (4 if track2 else 2)
    for a, b in zip(outs, refs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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


# Tile ranges (start, count) of a hand-built pair stream, one per staging
# edge of K1: inside one chunk, from mid-chunk to mid-chunk, count 0, over
# three chunks, a 650-record tile (the fullest 1080p north-star tile) over
# seven, ending on a chunk boundary, and one whole aligned chunk.
EDGE_RANGES = [(40, 60), (100, 80), (180, 0), (180, 330), (510, 650),
               (1160, 120), (1280, 128)]


def _edge_stream(device, seed=0):
    """(records, starts, counts, payload) of EDGE_RANGES: random edge planes
    (about a third of each tile's pixels inside a record), depth planes on
    a 1/64 grid so records tie within and across chunks, a few records
    clamped by zmax, one NaN depth in the 650-record tile, unique ids, and
    a random 24-word payload per slot."""
    rng = np.random.default_rng(seed)
    e_pad = 1408
    rec = np.zeros((e_pad, t_fr.RECORD_F), np.float32)
    rec[:, 0:9] = rng.uniform(-1.0, 1.0, (e_pad, 9))
    rec[:, [2, 5, 8]] = rng.uniform(-2.0, 12.0, (e_pad, 3))
    flat = rng.uniform(size=e_pad) < 0.5
    rec[:, 9:11] = np.where(flat[:, None], 0.0,
                            rng.uniform(-0.01, 0.01, (e_pad, 2)))
    rec[:, 11] = rng.integers(8, 64, e_pad) / 64.0
    rec[:, t_fr.F_ID] = np.arange(e_pad)
    rec[:, t_fr.F_ZMAX] = np.where(rng.uniform(size=e_pad) < 0.1, 0.5, 2.0)
    rec[700, 11] = np.nan
    payload = rng.integers(-2**31, 2**31, (e_pad, 24)).astype(np.int32)
    starts, counts = zip(*EDGE_RANGES)
    return (torch.from_numpy(rec).to(device),
            torch.tensor(starts, dtype=torch.int32, device=device),
            torch.tensor(counts, dtype=torch.int32, device=device),
            torch.from_numpy(payload.view(np.float32)).to(device))


@pytest.mark.parametrize("track2,with_payload", [
    (False, False), (True, False), (False, True), (True, True)])
def test_fine_raster_pairs_staging_edges(cuda, track2, with_payload):
    """K1 stages only each chunk's slice of the tile's range: every variant
    equals its twin word for word on the edge-case stream."""
    rec, starts, counts, payload = _edge_stream(cuda)
    pay = payload if with_payload else None
    outs = t_fr.fine_raster_pairs(rec, starts, counts, track2=track2,
                                  payload=pay)
    refs = t_fr.fine_raster_pairs_reference(rec, starts, counts,
                                            track2=track2, payload=pay)
    torch.cuda.synchronize()
    assert len(outs) == len(refs) == 2 + 2 * track2 + with_payload
    for a, b in zip(outs, refs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ids = outs[1]
    assert (ids[2] == -1).all()  # the empty tile
    assert ((ids[4] >= 510 + 128) & (ids[4] != 700)).any()  # later chunks


def _ltc_fields(device, seed=0, h=96, w=160):
    """(nor, rd, pos, roughness, area_points, ltc1, ltc2) from a seed:
    unit normals and view vectors, positions around two rect lights (both
    sides of each), a background row at +-1e12, roughness 0 and 1 rows
    (test_torch_ltc_rect's fields, rebuilt here: that module imports jax,
    which the card's host lacks)."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    nor = unit(rng.standard_normal((h, w, 3)))
    rd = unit(rng.standard_normal((h, w, 3)))
    pos = rng.uniform(-8.0, 8.0, (h, w, 3))
    pos[2] = np.where(rng.uniform(size=(w, 3)) < 0.5, -1e12, 1e12)
    rough = rng.uniform(0.0, 1.0, (h, w))
    rough[0], rough[1] = 0.0, 1.0
    quad = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]])
    points = np.stack([quad + [0.0, 6.0, 0.0], quad[:, [1, 0, 2]] + 1.0])
    ltc1, ltc2 = load_ltc_tables()
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device)
            for a in (nor, rd, pos, rough, points, ltc1, ltc2)]


@pytest.mark.parametrize("bf16", [False, True])
def test_ltc_rect_kernel_matches_twin(cuda, bf16):
    """The fused kernel equals the eager chain on the card with 0 differing
    words."""
    fields = _ltc_fields(cuda)
    names = ("LAUNCHES", "LAUNCHES_BF16")
    before = [getattr(t_ltc, n) for n in names]
    got = t_ltc.ltc_rect_terms(*fields, bf16=bf16)
    want = t_ltc.ltc_rect_terms_reference(*fields, bf16=bf16)
    torch.cuda.synchronize()
    assert [getattr(t_ltc, n) for n in names] == [before[0] + (not bf16),
                                                  before[1] + bf16]
    for a, b in zip(got, want):
        assert a.shape == (2, 96, 160)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (got[0] != 0).any() and (got[0] == 0).any()


def test_ltc_rect_kernel_non_finite_pixels(cuda):
    """Non-finite fields (an infinite normal, a NaN roughness) reach the
    same words, NaN where the twin has NaN: the identity's 0 * x terms
    are kept."""
    nor, rd, pos, rough, points, ltc1, ltc2 = _ltc_fields(cuda, seed=1)
    nor[5, :4] = float("inf")
    rough[6, :4] = float("nan")
    got = t_ltc.ltc_rect_terms(nor, rd, pos, rough, points, ltc1, ltc2)
    want = t_ltc.ltc_rect_terms_reference(nor, rd, pos, rough, points, ltc1,
                                          ltc2)
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = ~torch.isnan(a)
        assert torch.equal(a[fin].view(torch.int32), b[fin].view(torch.int32))
    assert torch.isnan(want[0]).any() and torch.isnan(want[1]).any()


@pytest.mark.parametrize("n_lights,h", [(0, 96), (2, 0)])
def test_ltc_rect_kernel_empty_launches_nothing(cuda, n_lights, h):
    """No light or no pixel: empty outputs of the right shape, no launch
    and no count."""
    nor, rd, pos, rough, points, ltc1, ltc2 = _ltc_fields(cuda)
    before = (t_ltc.LAUNCHES, t_ltc.LAUNCHES_BF16)
    got = t_ltc.ltc_rect_terms(nor[:h], rd[:h], pos[:h], rough[:h],
                               points[:n_lights], ltc1, ltc2)
    assert [tuple(a.shape) for a in got] == [(n_lights, h, 160)] * 2
    assert (t_ltc.LAUNCHES, t_ltc.LAUNCHES_BF16) == before


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


GOLDEN_RT = RasterConfig(width=160, height=96, tri_capacity=1 << 16,
                         pair_capacity=1 << 17)


def _golden_rt_camera():
    return pt.Camera(position=[0, 2, 0], pitch=-18.0, aspect=160 / 96)


@pytest.mark.parametrize("scale", [1, 2])
def test_shadow_trace_kernel_matches_twin(cuda, scale):
    scene = golden_scene(pt).device(cuda, with_tlas=True)
    args, kwargs = frame_shadow_rays(pt, scene, GOLDEN_RT,
                                     _golden_rt_camera(), scale)
    got, want, counts, differ = shadow_trace_check(args, kwargs)
    assert differ == 0 and int(got.exhausted) == int(want.exhausted) == 0
    assert got.hit.any() and counts.node_visits > 0


@pytest.mark.parametrize("kind", SHADOW_EDGE_CASES)
def test_shadow_trace_kernel_edge_sets(cuda, kind):
    world, o, d, act = shadow_edge_case(pt, kind)
    scene = world.device(cuda, with_tlas=True)
    args = t_trav.scene_rays_threaded(scene) + (
        torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda))
    kwargs = dict(active=torch.from_numpy(act).to(cuda),
                  max_leaf=scene.meshes.bvh_max_leaf)
    before = t_st.LAUNCHES
    got, want, _counts, differ = shadow_trace_check(args, kwargs)
    assert differ == 0 and int(got.exhausted) == int(want.exhausted) == 0
    assert t_st.LAUNCHES == before + (1 if len(o) else 0)


@pytest.mark.parametrize("kind", SHADOW_EDGE_CASES[:3])
def test_shadow_pack_kernel_matches_twin(cuda, kind):
    """The packing kernel (one launch a frame) writes every word of
    rt/traverse.py pack_shadow_rows's tables."""
    world = shadow_edge_case(pt, kind)[0]
    tables = t_trav.scene_rays_threaded(world.device(cuda, with_tlas=True))
    before = t_st.LAUNCHES_PACK
    got = t_st.pack_rows(*tables)
    want = t_trav.pack_shadow_rows(*tables)
    assert t_st.LAUNCHES_PACK == before + 1 and got.n_inst == want.n_inst
    for field in ("top", "blas", "tris"):
        assert torch.equal(getattr(got, field).view(torch.int32),
                           getattr(want, field).view(torch.int32))


@pytest.mark.parametrize("steps", [1, 4, 16])
def test_shadow_trace_kernel_step_limits(cuda, steps):
    """Cut at a small step limit, the kernel's walk stops where its twin's
    does: the same hits and the same count of rays still walking."""
    world, o, d, act = shadow_edge_case(pt, "box")
    scene = world.device(cuda, with_tlas=True)
    args = t_trav.scene_rays_threaded(scene) + (
        torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda))
    kwargs = dict(active=torch.from_numpy(act).to(cuda),
                  max_leaf=scene.meshes.bvh_max_leaf, max_steps=steps)
    got, want, _counts, differ = shadow_trace_check(args, kwargs)
    assert differ == 0 and int(got.exhausted) == int(want.exhausted)
    assert steps > 4 or int(want.exhausted) > 0


@pytest.mark.parametrize("scale", [1, 2])
def test_rt_frame_on_card_matches_cpu(cuda, scale):
    imgs = []
    for device in (cuda, torch.device("cpu")):
        before = t_st.LAUNCHES
        r = Renderer(golden_scene(pt).device(device, with_tlas=True),
                     GOLDEN_RT, enable_taa=False, enable_rt_shadows=True,
                     rt_shadow_scale=scale)
        imgs.append(r.render(_golden_rt_camera()).cpu().numpy())
        assert int(r.aux["overflow"]) == 0
        assert int(r.aux["rt_exhausted"]) == 0
        assert t_st.LAUNCHES == before + (device.type == "cuda")
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3


@pytest.mark.parametrize("width", [None, 37])
@pytest.mark.parametrize("kind", SHADOW_EDGE_CASES + ("staircase",))
def test_closest_hit_kernel_edge_sets(cuda, kind, width):
    """Both thread orders: the rays in order, and in pixel tiles of rows
    of `width` (ragged at the right and the bottom)."""
    if kind == "staircase":
        world, o, d = staircase_case(pt)
        act = np.ones(len(o), bool)
    else:
        world, o, d, act = shadow_edge_case(pt, kind)
    scene = world.device(cuda, with_tlas=True)
    args = t_trav.scene_rays(scene) + (
        torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda))
    before = t_ch.LAUNCHES
    got, want, _counts, differ = closest_hit_check(
        args, dict(active=torch.from_numpy(act).to(cuda), width=width))
    assert not any(differ.values()), differ
    assert int(got.exhausted) == 0
    assert (int(got.overflow) > 0) == (kind == "staircase")
    assert t_ch.LAUNCHES == before + (1 if len(o) else 0)


@pytest.mark.parametrize("max_steps,per_ray,width", [
    (2048, False, 256), (3, True, 256), (1, False, 256), (2, True, None),
    (2048, False, None)])
def test_closest_hit_kernel_on_primary_rays(cuda, max_steps, per_ray, width):
    scene = bvh_trace.trace_world().device(cuda, with_tlas=True)
    o, d = bvh_trace.primary_rays(256, 144)
    t_max = 1e6
    if per_ray:
        t_max = torch.where(torch.arange(len(o)) % 3 == 0, 8.0, 1e6).to(cuda)
    args = t_trav.scene_rays(scene) + (torch.from_numpy(o).to(cuda),
                                       torch.from_numpy(d).to(cuda))
    got, want, _counts, differ = closest_hit_check(
        args, dict(t_max=t_max, max_steps=max_steps, width=width))
    assert not any(differ.values()), differ
    assert (int(got.exhausted) > 0) == (max_steps < 2048)
    assert (got.t < 1e6).any() or max_steps < 3


def test_closest_hit_kernel_on_the_longest_walks(cuda):
    """The 1,024 rays with the most pops alone (an active mask), as
    chip_smoke.closest_walk_profile times them."""
    scene = bvh_trace.trace_world().device(cuda, with_tlas=True)
    o, d = bvh_trace.primary_rays(256, 144)
    args = t_trav.scene_rays(scene) + (torch.from_numpy(o).to(cuda),
                                       torch.from_numpy(d).to(cuda))
    visits = t_ch.closest_hit(*args, t_max=1e6, width=256).visits
    active = torch.zeros(len(o), dtype=torch.bool, device=cuda)
    active[torch.topk(visits, 1024).indices] = True
    got, want, _counts, differ = closest_hit_check(
        args, dict(t_max=1e6, active=active, width=256))
    assert not any(differ.values()), differ
    assert (got.visits[~active] == 0).all()
    assert torch.equal(got.visits[active], visits[active])


def test_lut_fetch_kernel_on_ring_uvs(cuda):
    """K3 on the horizon uvs a disk evaluation hands it through
    shading._lut_scale on a 320x184 ring G-buffer: one launch, within 1e-6
    of its twin (a twin never runs on this card path)."""
    seen, real = [], t_lut.lut_fetch

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    scene = ring_light.ring_world().device(cuda)
    gb, _aux, cam = ring_light.gbuffer(scene, 320, 184)
    nor, rd, pos = _ring_fields(scene, gb, cam)
    minv = torch.eye(3, device=cuda).expand(nor.shape + (3,))
    pts = torch.from_numpy(t_shading.disk_points3(
        *(ring_light.LIGHT[k] for k in ("disk_center", "disk_dirx",
                                        "disk_diry", "halfx",
                                        "halfy")))).to(cuda)
    before = t_lut.LAUNCHES
    t_lut.lut_fetch = capture
    try:
        t_shading.ltc_evaluate_disk(scene, nor, rd, pos, minv, pts)
    finally:
        t_lut.lut_fetch = real
    assert len(seen) == 1 and t_lut.LAUNCHES == before + 1
    (tables, uv), kwargs = seen[0]
    assert len(tables) == 1 and uv.is_cuda
    got = t_lut.lut_fetch(tables, uv, **kwargs)
    want = t_lut.lut_fetch_reference(tables, uv, **kwargs)
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-6


def _ring_fields(scene, gb, cam):
    """shade_ring_light's nor, rd and pos of a G-buffer."""
    nor = t_shading.encoding.decode_octahedral_32(gb.normal_uv[..., 0])
    pos = t_shading.world_position_from_depth(gb.depth, cam.clip_to_world)
    cam_pos = torch.as_tensor(np.asarray(cam.position, np.float32)[:3],
                              device=pos.device)
    return nor, t_shading.fastmath.normalize(cam_pos - pos), pos


def _ring_args(device, seed=0, h=96, w=160):
    """Seeded fields around the demo's ring light (half of them facing
    away, one row at 1e12) and the light's (2, 3, 3) disk corners."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    nor = unit(rng.standard_normal((h, w, 3)))
    pos = rng.uniform([-6.0, -1.0, -12.0], [6.0, 3.0, 0.0], (h, w, 3))
    pos[3:4] = 1e12
    rd = unit(np.asarray(ring_light.CAMERA["position"], np.float64) - pos)
    points = t_ring.ring_points3(*(ring_light.LIGHT[k] for k in (
        "disk_center", "disk_dirx", "disk_diry", "halfx", "halfy")))
    ltc1, ltc2 = load_ltc_tables()
    fields = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
              for a in (nor, rd, pos)]
    return fields + [0.3, points] + [
        torch.from_numpy(np.asarray(a, np.float32)).to(device)
        for a in (ltc1, ltc2)]


@pytest.mark.parametrize("bf16,two_sided", [(False, True), (True, True),
                                             (False, False)])
def test_ltc_ring_kernel_matches_twin(cuda, bf16, two_sided):
    """The fused ring kernel against the eager chain on the card: one
    count of its variant, every word equal or within the ring tests'
    REL_TOL of the largest term (atan2f / cosf of one library on both
    sides), NaN where the twin has NaN."""
    args = _ring_args(cuda)
    names = ("LAUNCHES", "LAUNCHES_BF16")
    before = [getattr(t_ring, n) for n in names]
    kw = dict(two_sided=two_sided, bf16=bf16)
    got = t_ring.ltc_ring_terms(*args, **kw)
    want = t_ring.ltc_ring_terms_reference(*args, **kw)
    torch.cuda.synchronize()
    assert [getattr(t_ring, n) for n in names] == [before[0] + (not bf16),
                                                  before[1] + bf16]
    for a, b in zip(got, want):
        assert a.shape == (96, 160)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(b)
        inf = ~fin & ~torch.isnan(b)
        assert torch.equal(a[inf], b[inf])
        scale = max(float(b[fin].abs().max()), 1.0)
        assert float((a[fin] - b[fin]).abs().max()) <= 1e-5 * scale
    assert (want[0] != 0).any() and (want[1] != 0).any()


def test_ltc_ring_kernel_empty_launches_nothing(cuda):
    args = _ring_args(cuda, h=0)
    before = (t_ring.LAUNCHES, t_ring.LAUNCHES_BF16)
    got = t_ring.ltc_ring_terms(*args)
    assert [tuple(a.shape) for a in got] == [(0, 160)] * 2
    assert (t_ring.LAUNCHES, t_ring.LAUNCHES_BF16) == before


def test_ring_light_on_card_matches_cpu(cuda):
    """The ring frame: K1 and the fused ring kernel once on the card, K3
    never; the CPU runs the twins."""
    imgs = []
    for device in (cuda, torch.device("cpu")):
        before = (t_fr.LAUNCHES, t_ring.LAUNCHES, t_lut.LAUNCHES)
        imgs.append(ring_light.render(ring_light.ring_world().device(device),
                                      160, 96).cpu().numpy())
        launched = device.type == "cuda"
        assert (t_fr.LAUNCHES, t_ring.LAUNCHES, t_lut.LAUNCHES) == (
            before[0] + launched, before[1] + launched, before[2])
    assert np.isfinite(imgs[0]).all()
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3


def test_skinned_frame_on_card_matches_cpu(cuda):
    imgs = []
    for device in (cuda, torch.device("cpu")):
        p = dataclasses.replace(config5_preset(pt, True, 160 / 96),
                                pair_capacity=1 << 17)
        r = preset_renderer(p, p.world.device(device, with_tlas=True), 160,
                            96)
        with pytest.raises(ValueError):
            r.render(p.camera)
        img = r.render(p.camera, joint_mats=knot_joint_mats(2))
        assert int(r.aux["overflow"]) == 0 and int(r.aux["rt_exhausted"]) == 0
        imgs.append(img.cpu().numpy())
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3


@pytest.mark.parametrize("n", [4, 7])
def test_preset_frame_on_card_matches_cpu(cuda, n):
    """A BASELINE preset at 160x96 (config 4: two TAA frames, skinned arms
    posed by clapper_joint_mats, moving instances; config 7 at
    tests/test_oracle.py's reduced size), wired from its Preset, on the
    card against the CPU twins; K1 once a frame on the card."""
    from voidin_tpu_torch.framework import presets

    kwargs = {7: dict(n_textures=8, base_size=64, detail=0.15)}.get(n, {})
    imgs = []
    for device in (cuda, torch.device("cpu")):
        p = presets.PRESETS[n](160 / 96, **kwargs)
        r = preset_renderer(p, p.world.device(device), 160, 96)
        before = t_fr.LAUNCHES
        for _ in range(2):
            jm = p.animator(r.time) if p.animator else None
            img = r.render(p.camera, joint_mats=jm)
            assert int(r.aux["overflow"]) == 0
        assert t_fr.LAUNCHES - before == (2 if device.type == "cuda" else 0)
        imgs.append(img.cpu().numpy())
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0.02
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3


def test_gltf_frame_on_card_matches_cpu(cuda, tmp_path):
    """chip_smoke's import scene (glTF with its skin and animation, OBJ) at
    160x96, two TAA frames posed by GltfAnimator, on the card against the
    CPU twins."""
    from voidin_tpu_torch.io.gltf import GltfAnimator

    from chip_smoke import (IMPORT_CAMERA, import_joint_mats, import_world,
                            write_import_scene)

    paths = write_import_scene(str(tmp_path))
    cfg = RasterConfig(width=160, height=96, tri_capacity=1 << 12,
                       pair_capacity=1 << 14)
    imgs = []
    for device in (cuda, torch.device("cpu")):
        world, doc = import_world(pt, paths, "glb")
        r = Renderer(world.device(device), cfg)
        an = GltfAnimator(doc)
        for i in (2, 6):
            img = r.render(pt.Camera(**IMPORT_CAMERA, aspect=160 / 96),
                           joint_mats=import_joint_mats(an, i))
            assert int(r.aux["overflow"]) == 0
        imgs.append(img.cpu().numpy())
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0.02
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3


def test_app_model_on_card_matches_cpu(cuda):
    """examples/model.py's App at 160x128 on the card and on the CPU:
    three App.step frames within 5e-3 mean; K1 base and the fused LTC
    kernel launched once a card frame; the resize to 128x96 frees the old
    Renderer and renders at the new size."""
    import gc
    import weakref

    from voidin_tpu_torch.examples import model

    imgs = []
    for device in (cuda, torch.device("cpu")):
        app = model.make_app(160, 128, device)
        b_fr, b_ltc = t_fr.LAUNCHES, t_ltc.LAUNCHES
        for _ in range(3):
            img = app.step()
        assert img.device.type == device.type
        assert int(app.renderer.aux["overflow"]) == 0
        n = 3 if device.type == "cuda" else 0
        assert (t_fr.LAUNCHES - b_fr, t_ltc.LAUNCHES - b_ltc) == (n, n)
        imgs.append(img.cpu().numpy())
        old = weakref.ref(app.renderer)
        app.resize(128, 96)
        gc.collect()
        assert old() is None
        assert app.step().shape == (96, 128, 3)
    assert np.isfinite(imgs[0]).all() and imgs[0].std() > 0.02
    assert np.abs(imgs[0] - imgs[1]).mean() < 5e-3


def test_app_recording_round_trip_on_card(cuda, tmp_path):
    """App.run records card frames (host copies) into the MJPEG-AVI; the
    port's decoder reads each frame back within mean 0.01 of the frame
    the recorder was handed."""
    from chip_smoke import avi_frames
    from voidin_tpu_torch.examples import model
    from voidin_tpu_torch.framework import recorder
    from voidin_tpu_torch.io.jpeg import decode_jpeg

    app = model.make_app(160, 128, cuda)
    pushed = []
    real_push = app.recorder.push
    app.recorder.push = lambda f: (pushed.append(np.array(f)), real_push(f))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(recorder.shutil, "which", lambda name: None)
        app.run(4, record_path=str(tmp_path / "clip.mp4"), hud=True)
    frames = avi_frames((tmp_path / "clip.avi").read_bytes())
    assert len(frames) == len(pushed) == 4
    for data, want in zip(frames, pushed):
        got = decode_jpeg(data) / 255.0
        assert np.abs(got - np.clip(want, 0, 1)).mean() <= 0.01


def test_profiler_times_card_passes_with_cuda_events(cuda, monkeypatch):
    from voidin_tpu_torch.framework import profiler

    made = []
    real = torch.cuda.Event

    def event(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", event)
    ms = profiler.time_fn(lambda x: x * 2, torch.ones(1 << 20, device=cuda),
                          n=3)
    assert ms > 0 and len(made) == 6
    world, _ = build_world(200, seed=0)
    rows = profiler.profile_frame(
        world.device(cuda), pt.Camera(position=[0.0, 2.0, 30.0],
                                      pitch=-5.0, aspect=2.0).uniform(),
        RasterConfig(width=320, height=160, tri_capacity=1 << 15,
                     pair_capacity=1 << 15))
    assert [n for n, _ in rows][3] == "fine raster (cuda)"
    assert all(ms > 0 for _, ms in rows)


SHARD_CFG = RasterConfig(width=320, height=192, tri_capacity=1 << 15,
                         pair_capacity=1 << 16)  # 24 tile rows


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_on_card_launches_k1_per_slab(cuda, n):
    """The row-sharded frame on a mesh naming the card n times: K1 once
    per slab and frame, the fused LTC kernel once per slab and frame, the
    image word for word the unsharded card frame's over 3 TAA frames;
    each slab's K1 equals its twin on that slab's own records."""
    from voidin_tpu_torch.parallel import sharding as sh

    world, moving = build_world(1000, seed=0)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                    aspect=320 / 192)
    imgs = []
    for mesh in (None, sh.make_mesh(devices=[cuda] * n)):
        r = Renderer(world.device(cuda), SHARD_CFG, moving_ids=moving,
                     mesh=mesh)
        k1, ltc = t_fr.LAUNCHES, t_ltc.LAUNCHES
        for _ in range(3):
            img = r.render(cam)
            assert int(r.aux["overflow"]) == 0
        slabs = 1 if mesh is None else n
        assert (t_fr.LAUNCHES - k1, t_ltc.LAUNCHES - ltc) == (3 * slabs,
                                                              3 * slabs)
        imgs.append(img.cpu().numpy())
    np.testing.assert_array_equal(imgs[1], imgs[0])

    seen = []
    real = t_fr.fine_raster_pairs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_fr, "fine_raster_pairs",
                   lambda *a, **k: (seen.append((a, k)), real(*a, **k))[1])
        Renderer(world.device(cuda), SHARD_CFG,
                 mesh=sh.make_mesh(devices=[cuda] * n)).render(cam)
    assert len(seen) == n
    for args, kw in seen:
        got = t_fr.fine_raster_pairs(*args, **kw)
        ref = t_fr.fine_raster_pairs_reference(*args, **kw)
        for g, w in zip(got, ref):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_walk_tables_checked_before_launch_on_card(cuda):
    """In the bounds mode a corrupt TLAS child raises a named rt. error
    from the shadow and closest-hit wrappers before anything launches;
    the clean tables launch, and the card stays usable."""
    from voidin_tpu_torch.core import checks

    scene = config5_preset(pt).world.device(cuda, with_tlas=True)
    table, n_tlas, inst, tri_pos = t_trav.scene_rays_threaded(scene)
    tlas, blas, inst2, tri_pos2 = t_trav.scene_rays(scene)
    o = torch.zeros(64, 3, device=cuda)
    d = torch.randn(64, 3, device=cuda, generator=torch.Generator(
        cuda).manual_seed(0))
    bad_table = table.clone()
    bad_table[0, 3] = 1.0e7
    bad_tlas = tlas.clone()
    bad_tlas[0, 3] = 1.0e7
    with checks.bounds(True):
        before = (t_st.LAUNCHES, t_ch.LAUNCHES)
        with pytest.raises(IndexError, match="rt\\.node"):
            t_st.occluded(bad_table, n_tlas, inst, tri_pos, o, d,
                          t_max=10.0)
        with pytest.raises(IndexError, match="rt\\.tlas_node"):
            t_ch.closest_hit(bad_tlas, blas, inst2, tri_pos2, o, d)
        assert (t_st.LAUNCHES, t_ch.LAUNCHES) == before
        hit = t_st.occluded(table, n_tlas, inst, tri_pos, o, d, t_max=10.0)
        t_ch.closest_hit(tlas, blas, inst2, tri_pos2, o, d)
    torch.cuda.synchronize()
    assert (t_st.LAUNCHES, t_ch.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert hit.hit.shape == (64,)


def test_resolve_check_and_clean_checked_frame_on_card(cuda):
    """debug_bounds on the card: the checked frame equals the unchecked
    one word for word; a corrupted tri_id raises resolve.rec."""
    from voidin_tpu_torch.core import checks

    world, _ = build_world(1000, seed=0)
    scene = world.device(cuda)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0, aspect=320 / 184)
    imgs = [Renderer(scene, dataclasses.replace(CFG, debug_bounds=b),
                     enable_taa=False).render(cam).cpu().numpy()
            for b in (False, True)]
    np.testing.assert_array_equal(imgs[1], imgs[0])
    u = cam.uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, u)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, u, CFG)
    vis.tri_id = torch.where(vis.tri_id >= 0, vis.tri_id + 10_000_000,
                             vis.tri_id)
    with checks.bounds(True), pytest.raises(IndexError, match="resolve.rec"):
        resolve.resolve_gbuffer(scene, vis, CFG)


def test_area_light_scale_on_card(cuda):
    """area_light_scale=2 on the card: one fused LTC launch on the
    subsampled fields, equal to its twin word for word there; the frame
    within the frame budget of the CPU's."""
    world, _ = build_world(1000, seed=0)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0, aspect=320 / 184)
    seen = []
    real = t_ltc.ltc_rect_terms
    imgs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_ltc, "ltc_rect_terms",
                   lambda *a, **k: (seen.append((a, k)), real(*a, **k))[1])
        for d in (cuda, torch.device("cpu")):
            n = t_ltc.LAUNCHES
            imgs[d.type] = Renderer(world.device(d), CFG, enable_taa=False,
                                    area_light_scale=2).render(
                cam).cpu().numpy()
            if d.type == "cuda":
                assert t_ltc.LAUNCHES == n + 1
    args, kw = seen[0]
    assert tuple(args[3].shape) == (92, 160)
    got = t_ltc.ltc_rect_terms(*args, **kw)
    ref = t_ltc.ltc_rect_terms_reference(*args, **kw)
    for g, w in zip(got, ref):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert np.abs(imgs["cuda"] - imgs["cpu"]).mean() < 5e-3


def test_native_packer_on_the_card_host(cuda):
    """The card's host builds the native texture packer (no numpy fallback
    there), and config 6's scene built on the card carries the very quads
    of its CPU build: the pool is packed on the host either way."""
    from voidin_tpu_torch import native
    from voidin_tpu_torch.framework import presets

    assert native.packer() == "native"
    p = presets.PRESETS[6](16 / 9, base_size=64, n_textures=12, n_knots=2,
                           knot_detail=(48, 8))
    on_card = p.world.device(cuda).textures.quads
    assert on_card.is_cuda
    assert torch.equal(on_card.cpu(),
                       p.world.device("cpu").textures.quads)
