"""Chip smoke test of the PyTorch + CUDA port (voidin_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a) and, at the
first scene, the host BVH builder (native/bvh_builder.cpp, the host C++
compiler), then:
  1. prints torch's version and the card's name and power limit;
  2. every kernel against its PyTorch twin on its 1080p inputs, each timed
     by call (CUDA events over back-to-back calls, the host wrapper
     included) and on the device (torch.profiler: the kernel's own CUDA
     time per call), beside its bound (kernel_phases): K1 on the records
     of the north-star frame itself (depth and id identical); K1's payload
     variant on them with slim_rec (all outputs identical, the payload
     image equal to resolve_rec[max(tri_id, 0)] bit for bit); K2 on the
     north-star block records, K (tile_tri_capacity) the smallest multiple
     of 128 above its fullest tile, with the histogram of its per-tile
     counts, then K2 and K2 track2 on the adversarial block sets of
     block_edge_set (every output word equal); K3 and its bf16 variant on 5 and on 1
     random 64x64 tables at 1920x1080 random uvs plus the corner uvs (max
     abs diff <= 1e-6), torch's grid_sample timing the same fetches as a
     yardstick (the port never calls it); K1 track2 and K2 track2 on the
     masked frame's records and blocks (all four outputs identical); the
     fused LTC kernel and its bf16 variant on the north-star and masked
     frames' own shade fields (0 differing words) (ltc_rect_phases);
  3. the golden deferred scene at 160x96 on the card against the checked-in
     golden image (tests/golden/deferred.png, mean abs diff < 5e-3, the
     golden tests' budget) and against the port's CPU render;
  4. the masked scene (build_world(1000) + 300 foliage cards, 320x184, 3
     TAA frames) on the card against the port's CPU render (mean 5e-3),
     then on the block path (backend "xla"): K2 track2 and the fused LTC
     kernel launched once per frame;
  5. the north-star frame: build_world(10_000, seed=0) at 1920x1080 with
     raster capacities 2^19, moving instances and TAA, for 12 frames
     through Renderer.render; overflow 0 on every frame, a finite image
     with variance, K1 and the fused LTC kernel launched once per frame,
     K3 never;
  6. the block-path north-star frame: one VisBuffer of each path at the
     first frame's camera (depth bit-identical; the pixels whose id
     differs, which only depth ties allow, are printed), then 12 frames
     with backend "xla": overflow 0, K2 / K1 launched 12 / 0;
  7. the slim north-star frames: 12 frames with slim_rec (K1 12 launches)
     and 12 with slim_rec + kernel_payload (K1 payload 12, K1 0): the two
     last images identical, and within mean 5e-3 of the default
     north-star frame;
  8. the masked frame: the north star plus add_foliage(world, 3000, seed=1)
     (alpha-tested cut-out cards with normal, metallic-roughness and
     emissive maps), the same camera and 12 frames, pair capacity 2^20;
     overflow 0 (the alpha-fallback capacity included), per frame the
     cut-winner and fallback pixel counts, K1 track2 / K1 base launched
     12 / 0;
  9. shading.LTC_LUT_BF16 on against off, one frame each (TAA off): the
     golden scene within tests/test_ltc.py's budgets (max abs diff < 1e-2,
     mean < 2e-4), then the masked 1080p frame: one launch of the fused
     kernel's bf16 variant, mean < 2e-4, its max abs diff printed;
 10. raytraced shadows (rt_phases): the golden rt_shadows scene at 160x96
     on the card against tests/golden/rt_shadows.png and the CPU twins
     (mean 5e-3); the shadow-ray kernel against its twin on the
     adversarial ray sets of shadow_edge_case (every hit equal, nothing
     exhausted); then config 5 (config5_world, 1920x1080, TLAS, no TAA),
     printing the BVH builder and the host's BLAS / TLAS build times: 12
     frames at rt_shadow_scale 1 and 12 at 2 (overflow 0, no shadow ray
     at the step limit, K1 and the shadow kernel launched once a frame),
     and the kernel against its twin on each scale's shadow rays, timed;
 11. closest hit (closest_phases): the kernel against its twin on the
     adversarial ray sets and a tree deeper than its stack (the overflow
     counted alike); the bvh_trace example's scene (12 instances of
     the knot and the sphere) and config 5's scene (81-node TLAS), each
     with its camera's 1920x1080 primary rays through the example's trace
     (one launch), then kernel against twin on those rays (every t word,
     visit count and counter equal, nothing overflowed or exhausted),
     timed; the example module at its own size (512x288);
 12. the skinned frame (skin_phases): config 5 with its knot a 2-joint
     skin (weights by height) bent by a new pose each frame, raytraced
     shadows, 12 frames at 1920x1080 (overflow 0, rt_exhausted 0, K1 and
     the shadow kernel once a frame), the last pose's refit BLAS and TLAS
     valid and tight on the card, and the scene at 320x184 on the card
     against the CPU twins (mean 5e-3);
 13. the ring light (ring_phases): the golden ring_light scene at 160x96
     on the card against tests/golden/ring_light.png and the CPU twins
     (mean 5e-3), 12 frames of it at 1920x1080 (K1 and K3 once a frame,
     the fused LTC kernel never), and K3 against its twin on that frame's
     own uvs (max abs diff <= 1e-6).
Phases 5-8 and 10-13 print the median ms/frame of frames 3-12 (CUDA
events) and the peak device memory of the 12 frames. Every path run sets
the launch counts to 0 just before it and checks them just after. Prints
the kernel table as one JSON line (each row also with device_ms, K3's with
its 1-table shape under one_table and the ring frame's fetch under ring,
the shadow kernel's with its scale-2 rays under scale2, the closest-hit
kernel's with config 5's rays under config5), then the card line, then the
result line {"ok": true,
"device": {...}}. A device time whose profiler trace lost its kernel
records is null, with a line saying so. Exits non-zero on any failure and
when no CUDA device is available.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

FRAMES = 12
WIDTH, HEIGHT = 1920, 1080
CAP = 1 << 19
N_FOLIAGE = 3000
# The foliage cards near the camera span ~1,000 tiles each: their extra
# (triangle, tile) pairs overflow the 2^19 / 4 extras stream of the north
# star's capacities, so the masked frame bins with 2^20 pairs.
MASKED_PAIR_CAP = 1 << 20
K3_TOL = 1e-6
GOLDEN_BUDGET = 5e-3
BF16_BUDGET = 1e-2  # max abs sRGB diff, tests/test_ltc.py:431
BF16_MEAN_BUDGET = 2e-4  # mean abs sRGB diff, tests/test_ltc.py:432
# Peak rates of one H100 SXM (NVIDIA data sheet) for the bound_ms column:
# HBM bytes/s and FP32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def golden_rgb(name):
    """tests/golden/<name>.png as (H, W, 3) floats in [0, 1]."""
    from voidin_tpu_torch.io.image import load_image

    root = os.path.dirname(os.path.abspath(__file__))
    img = load_image(os.path.join(root, "tests", "golden", f"{name}.png"))
    return img[..., :3] / 255.0


def time_cuda(fn, reps):
    """Call time in ms: CUDA events around `reps` back-to-back calls of
    `fn`, host wrapper included (where the wrapper is slower than its
    kernel, this measures the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel, attempts=3):
    """Kernel-only device time in ms per call: the mean duration of the CUDA
    kernels whose name contains `kernel` in a torch.profiler trace (CUDA
    activity, read from the profiler's kineto results) of `reps` calls of
    `fn`, each of which launches one such kernel. A trace that holds
    another number of them is reported and taken again, up to `attempts`
    traces; then the time is None ("not measured"), with a line saying so:
    a lost trace is no wrong result, so it fails no gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and kernel in e.name()]
        if len(spans) == reps:
            return sum(spans) / reps / 1e6
        print(f"  (the profiler trace holds {len(spans)} of {reps} {kernel} "
              f"kernels; tracing again)", flush=True)
    print(f"  device_ms: null for {kernel}: {attempts} profiler traces of "
          f"{reps} calls did not hold {reps} {kernel} kernels", flush=True)
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def north_star_camera(pt):
    return pt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                     aspect=WIDTH / HEIGHT)


def bound_ms(n_bytes, n_ops):
    """(least time in ms, what bounds it): the larger of the bytes over the
    card's memory rate and the FP32 operations over its FP32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bound(counts, n_out, tile_bytes=8, px_bytes=0):
    """K1 must read each of the frame's valid (triangle, tile) records once
    (64 B), the per-tile start/count (8 B), and write n_out f32 per pixel
    (plus px_bytes more per pixel, the payload variant's 96 B row); every
    record-pixel test evaluates three edge planes (12 FP32 ops). K2 the
    same over its blocks' valid records, with a 4 B count per tile."""
    pairs = int(counts.sum())
    nt = counts.shape[0]
    return bound_ms(pairs * 64 + nt * tile_bytes
                    + nt * 128 * (4 * n_out + px_bytes), pairs * 128 * 12)


def block_capacity(counts):
    """The block path's tile_tri_capacity: the smallest multiple of 128 at
    or above the fullest tile of the frame's pair binning (the same
    (triangle, tile) pairs the block binning makes)."""
    return max(128, -(-int(counts.max()) // 128) * 128)


COUNT_BINS = (0, 1, 9, 17, 33, 65, 129, 257, 513)


def count_histogram(counts):
    """The per-tile record counts as text: for each bin of COUNT_BINS the
    tiles in it and their share of all records (what decides how K2 hands
    tiles to its blocks)."""
    c = counts.to("cpu").numpy().astype(np.int64)
    total = max(int(c.sum()), 1)
    edges = list(COUNT_BINS) + [int(c.max()) + 1]
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi <= lo:
            continue
        sel = (c >= lo) & (c < hi)
        name = str(lo) if hi == lo + 1 else f"{lo}-{hi - 1}"
        parts.append(f"{name}: {int(sel.sum())} tiles "
                     f"{100.0 * c[sel].sum() / total:.1f}%")
    return "; ".join(parts)


# Hand-built block sets at every edge of K2's tile walk (block_edge_set):
# K and the tile count in the name, the per-tile counts below.
EDGE_COUNTS = (0, 1, 7, 8, 9, 127, 128, 129, -1, 0, 5, 31, 32, 33, 64, 65)
BLOCK_EDGE_SETS = ("k8", "k16", "k128", "k136", "k768", "nt1_k8", "nt1_k128",
                   "nt8_k16", "nt2309_k72")
# More than 64 tiles per resident block of K2 on an H100, so that a block
# refills its window of tile counts twice: too large for the CPU twin's
# intermediates, so the card alone runs it.
BIG_BLOCK_EDGE_SET = "nt100001_k8"


def block_edge_set(name, seed=0):
    """(blocks (NT, K, 16) f32, counts (NT,) i32, not capped at K) of the
    named adversarial block set, as numpy arrays. "k<K>": 16 tiles with
    counts 0, 1, 7, 8, 9, 127, 128, 129, K - 1, K, K + 5, 31, 32, 33, 64,
    65; "nt<NT>_k<K>": 1 or 8 tiles, or random counts 0 .. K + 4.

    Every coefficient lies on a dyadic grid (edges 1/8, depth slopes 1/1024,
    depths 1/64), so each plane is exact in f32 whether its multiply-adds
    are fused or not, and many depths tie. A tenth of the records have id
    -1 and would win every pixel; the slots at or past min(count, K) hold
    live records that would win every pixel if read. On tiles that hold
    them, equal-depth records covering the whole tile sit at slots (7, 8),
    (31, 32) and (127, 128), on either side of a group, a 32-record and a
    128-record boundary, the later one with the higher id (tiles 1, 2 mod
    3); a NaN depth sits at slots 3, 121 and 130, in the last group of a
    128-record slice and the first group of the next (tiles 0 mod 3); on
    odd tiles the last valid slot wins every pixel."""
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    head, _, tail = name.partition("_")
    k = int((tail or head)[1:])
    if not tail:
        counts = [k - 1 if c < 0 else c + k if i in (9, 10) else c
                  for i, c in enumerate(EDGE_COUNTS)]
    elif name == "nt1_k8":
        counts = [8]
    elif name == "nt1_k128":
        counts = [100]
    elif name == "nt8_k16":
        counts = [0, 1, 7, 8, 9, 15, 16, 20]
    else:
        counts = rng.integers(0, k + 5, int(head[2:]))
    counts = np.asarray(counts, np.int32)
    nt = counts.shape[0]

    def cover(depth, tid):
        r = np.zeros(16, np.float32)
        r[[2, 5, 8]] = 1.0
        r[11], r[12], r[15] = depth, tid, 2.0
        return r

    blocks = np.zeros((nt, k, 16), np.float32)
    blocks[:, :, 0:9] = rng.integers(-8, 9, (nt, k, 9)) / 8.0
    blocks[:, :, [2, 5, 8]] = rng.integers(-16, 97, (nt, k, 3)) / 8.0
    flat = rng.uniform(size=(nt, k, 1)) < 0.5
    blocks[:, :, 9:11] = np.where(flat, 0.0,
                                  rng.integers(-2, 3, (nt, k, 2)) / 1024.0)
    blocks[:, :, 11] = rng.integers(8, 56, (nt, k)) / 64.0  # planes < 0.91
    blocks[:, :, 12] = (rng.permuted(np.tile(np.arange(k), (nt, 1)), axis=1)
                        + np.arange(nt)[:, None] * k)
    blocks[:, :, 15] = np.where(rng.uniform(size=(nt, k)) < 0.1, 0.5, 2.0)
    blocks[rng.uniform(size=(nt, k)) < 0.1] = cover(0.995, -1.0)
    past = np.arange(k)[None, :] >= np.minimum(counts, k)[:, None]
    ids = blocks[:, :, 12].copy()
    blocks[past] = cover(0.999, 0.0)
    blocks[:, :, 12] = np.where(past, np.maximum(ids, 0.0), blocks[:, :, 12])
    for t in range(nt):
        c = min(int(counts[t]), k)
        for lo in (7, 31, 127):
            if c >= lo + 2 and t % 3 != 0:
                blocks[t, lo] = cover(0.985, 2.0 * (t * k + lo))
                blocks[t, lo + 1] = cover(0.985, 2.0 * (t * k + lo) + 1.0)
        for slot in (3, 121, 130):
            if c >= slot + 6 and t % 3 == 0:
                blocks[t, slot] = cover(np.nan, blocks[t, slot, 12])
        if c >= 1 and t % 2 == 1:
            blocks[t, c - 1] = cover(0.99, max(blocks[t, c - 1, 12], 0.0))
    return blocks, counts


def k3_bound(n_chan, n_px):
    """K3 must read each pixel's uv (8 B) and the tables (16 KB each) once
    and write 4 B per pixel and table; per pixel and table two row lerps
    and one column lerp (9 FP32 ops)."""
    return bound_ms(n_px * (8 + 4 * n_chan) + n_chan * 64 * 64 * 4,
                    n_px * n_chan * 9)


def launch_counters():
    """Every kernel's launch counter: name -> (ops module, attribute)."""
    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.ops import fine_raster as fr
    from voidin_tpu_torch.ops import ltc_rect as lr
    from voidin_tpu_torch.ops import lut_fetch as lf
    from voidin_tpu_torch.ops import shadow_trace as st

    return dict(k1=(fr, "LAUNCHES"), k1_track2=(fr, "LAUNCHES_TRACK2"),
                k1_payload=(fr, "LAUNCHES_PAYLOAD"),
                k2=(fr, "LAUNCHES_BLOCKS"),
                k2_track2=(fr, "LAUNCHES_BLOCKS_TRACK2"),
                k3=(lf, "LAUNCHES"), k3_bf16=(lf, "LAUNCHES_BF16"),
                ltc_rect=(lr, "LAUNCHES"),
                ltc_rect_bf16=(lr, "LAUNCHES_BF16"),
                shadow_trace=(st, "LAUNCHES"),
                closest_hit=(ch, "LAUNCHES"))


def reset_launches():
    for m, a in launch_counters().values():
        setattr(m, a, 0)


def expect_launches(label, want):
    """The counts since the last reset: `want`, every other zero."""
    counters = launch_counters()
    want = {k: want.get(k, 0) for k in counters}
    got = {k: getattr(m, a) for k, (m, a) in counters.items()}
    print(f"{label} launches: {got}", flush=True)
    if got != want:
        fail(f"{label}: kernel launches {got}, expected {want}")
    return got


def frame_setup(scene, cfg, cam=None):
    """Triangle setup of the first frame of `scene` at `cam` (default the
    north-star camera), with the f16 instance record when cfg.slim_rec."""
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.passes import cull, raster, resolve

    uniform = (cam or north_star_camera(pt)).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, uniform)
    inst_rec = resolve._inst_rec_f16(scene) if cfg.slim_rec else None
    setup = raster.triangle_setup(scene.meshes, scene.instances, draws,
                                  uniform, cfg, materials=scene.materials,
                                  inst_rec=inst_rec)
    setup["draw_count"] = int(draws.count)
    return setup


def frame_records(scene, cfg, setup=None, cam=None):
    """Tile-sorted pair records of the first frame of `scene` at `cam`
    (default the north-star camera), as the main path's binning produces
    them; `setup` given, its records."""
    from voidin_tpu_torch.passes import raster

    setup = setup or frame_setup(scene, cfg, cam)
    rec, starts, counts, ovf = raster.bin_triangles_pairs(setup, cfg)
    ovf = int(ovf) + int(setup["setup_overflow"])
    print(f"  records: draws {setup['draw_count']} pair slots "
          f"{rec.shape[0]} valid pairs {int(counts.sum())} tiles "
          f"{starts.shape[0]} max per tile {int(counts.max())} overflow "
          f"{ovf}", flush=True)
    if ovf:
        fail("binning overflowed")
    return rec, starts, counts


def frame_blocks(scene, cfg):
    """Per-tile record blocks of the first frame of `scene` at the
    north-star camera, as the block path's binning produces them."""
    from voidin_tpu_torch.passes import raster

    setup = frame_setup(scene, cfg)
    blocks, counts, ovf = raster.bin_triangles(setup, cfg)
    ovf = int(ovf) + int(setup["setup_overflow"])
    print(f"  blocks: K {cfg.tile_tri_capacity}, max per-tile count "
          f"{int(counts.max())}, valid records {int(counts.sum())}, tiles "
          f"{blocks.shape[0]}, block bytes {blocks.numel() * 4:,} "
          f"({blocks.numel() * 4 / 1e9:.3f} GB), overflow {ovf}",
          flush=True)
    if ovf:
        fail("block binning overflowed")
    return blocks, counts


def run_frames(renderer, cam, label, joint_mats=None):
    """FRAMES frames through Renderer.render, each timed with CUDA events
    and checked: overflow 0, something visible; `joint_mats(i)` poses
    frame i's skins. Returns (last image, per-frame ms, the peak device
    memory over the frames and the part of it above what was resident
    before, as text)."""
    import torch

    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, img = [], None
    for i in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = renderer.render(cam, joint_mats=None if joint_mats is None
                              else joint_mats(i))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        aux = {k: int(v) for k, v in renderer.aux.items() if v.numel() == 1}
        line = (f"{label} frame {i}: {times[-1]:.3f} ms draws "
                f"{aux['draw_count']} overflow {aux['overflow']} coverage "
                f"{aux['vis_coverage']}")
        if "alpha_cut" in aux:
            line += (f" cut winners {aux['alpha_cut']} "
                     f"({100.0 * aux['alpha_cut'] / (WIDTH * HEIGHT):.2f}%) "
                     f"fallback resolved {aux['alpha_fallback']}")
        if "rt_rays" in aux:
            line += (f" shadow rays {aux['rt_rays']} exhausted "
                     f"{aux['rt_exhausted']}")
        print(line, flush=True)
        if aux["overflow"] != 0:
            fail(f"{label} frame {i} overflowed")
        if aux.get("rt_exhausted", 0) != 0:
            fail(f"{label} frame {i}: shadow rays hit the step limit")
        if aux["vis_coverage"] <= 0:
            fail(f"{label} frame {i} has no visible pixel")
    out = img.cpu().numpy()
    if out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all():
        fail(f"{label} image bad: shape {out.shape}")
    if not out.std() > 0:
        fail(f"{label} image has no variance")
    peak = torch.cuda.max_memory_allocated()
    mem = (f"peak device memory {peak / 2**30:.3f} GiB "
           f"({(peak - before) / 2**30:.3f} above the resident "
           f"{before / 2**30:.3f})")
    return out, times, mem


def ltc_rect_bound(n_px, n_lights):
    """The fused LTC kernel must read each pixel's nor, rd, pos (12 B each)
    and roughness (4 B) and the two (64, 64, 4) tables once, and write 4 B
    per pixel, light and output (diff, spec). Its FP32 operations, counted
    from csrc/ltc_rect.cu with add, sub, mul, div, sqrt, rcp, floor, min
    and max one each: per pixel 192 (n . v and its clamp 7, the matrix
    uv 6, the 5-channel fetch 59, the basis 30, the two mat3_mat3 90), per
    light 32 (corners, light normal, side test) plus two evaluations of
    251 (4 x (mat3_vec 15 + normalize 10), 4 edge integrals of 26, the sum
    9, the norm 6, z 2, the uv 6, the 1-channel fetch 23, the product 1)
    and the t2.x product. An edge integral whose cosine is <= 0 costs 7
    more; counted at its cheaper branch, the bound stays a lower bound."""
    return bound_ms(n_px * (40 + 8 * n_lights) + 2 * 64 * 64 * 4 * 4,
                    n_px * (192 + n_lights * (32 + 2 * 251 + 1)))


def frame_ltc_inputs(pt, scene, cfg):
    """The fused LTC kernel's arguments as shade hands them over, in the
    first frame of `scene` at the north-star camera (TAA off)."""
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.ops import ltc_rect as lr

    seen = []
    real = lr.ltc_rect_terms

    def capture(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    lr.ltc_rect_terms = capture
    try:
        Renderer(scene, cfg, enable_taa=False).render(north_star_camera(pt))
    finally:
        lr.ltc_rect_terms = real
    return seen[0]


def words_differ(a, b):
    import torch

    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def timed_row(fn, kernel, reps, plain, plain_reps, bound, err):
    """A kernel's row: `fn` timed by call and on the device, its twin
    `plain` by call, beside its bound and its max abs error."""
    b_ms, b_by = bound
    return dict(max_abs_err=err, ms=time_cuda(fn, reps),
                device_ms=device_ms(fn, reps, kernel),
                plain_ms=time_cuda(plain, plain_reps), bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def timing(r):
    return (f"call {fmt_ms(r['ms'])}, device {fmt_ms(r['device_ms'])}, "
            f"twin {fmt_ms(r['plain_ms'])}, bound {fmt_ms(r['bound_ms'])}"
            f" ({r['bound_by']})")


def k2_edge_phase(dev, card):
    """K2 and its track2 variant against their twin on every adversarial
    block set (block_edge_set), the large one included: every output word
    equal."""
    import torch

    from voidin_tpu_torch.ops import fine_raster as fr

    worst = {}
    for name in BLOCK_EDGE_SETS + (BIG_BLOCK_EDGE_SET,):
        blocks, counts = (torch.from_numpy(a).to(dev)
                          for a in block_edge_set(name))
        for track2 in (False, True):
            outs = fr.fine_raster_blocks(blocks, counts, track2=track2)
            torch.cuda.synchronize()
            refs = fr.fine_raster_blocks_reference(blocks, counts,
                                                   track2=track2)
            worst[name, track2] = sum(words_differ(a, b)
                                      for a, b in zip(outs, refs))
    print(f"K2 edge sets {', '.join(n for n, t in worst if not t)} (base and "
          f"track2): differing words {sum(worst.values())} ({card})",
          flush=True)
    if any(worst.values()):
        fail(f"K2 disagrees with its twin on edge sets "
             f"{[k for k, v in worst.items() if v]}")


def kernel_phases(dev, card, world, masked_world, cfg, masked_cfg):
    """K1, K2 and K3, every variant, against their twins on their 1080p
    inputs, timed by call (CUDA events, wrapper included) and on the
    device (torch.profiler, the kernel alone). Returns (kernel rows, the
    north star's and the masked frame's block capacity, the masked scene
    on the card)."""
    import torch
    import torch.nn.functional as F

    from voidin_tpu_torch.ops import fine_raster as fr
    from voidin_tpu_torch.ops import lut_fetch as lf
    from voidin_tpu_torch.passes import raster

    rows = {}

    def row(name, *args):
        rows[name] = timed_row(*args)
        return rows[name]

    # --- K1 vs twin on the north-star records ----------------------------
    rec, starts, counts = frame_records(world.device(dev), cfg)
    kd, ki = fr.fine_raster_pairs(rec, starts, counts)
    rd, ri = fr.fine_raster_pairs_reference(rec, starts, counts)
    torch.cuda.synchronize()
    k1_mismatch = int(((kd != rd) | (ki != ri)).sum())
    k1 = row("fine_raster_pairs",
             lambda: fr.fine_raster_pairs(rec, starts, counts),
             "fine_raster_pairs_kernel", 20,
             lambda: fr.fine_raster_pairs_reference(rec, starts, counts), 3,
             k1_bound(counts, 2), float((kd - rd).abs().max()))
    print(f"K1 fine_raster_pairs: mismatched pixels {k1_mismatch} of "
          f"{kd.numel()}; {timing(k1)} ({card})", flush=True)
    if k1_mismatch:
        fail("K1 disagrees with its twin")
    ns_k = block_capacity(counts)
    del rec, starts, counts, kd, ki, rd, ri

    # --- K1 payload vs twin on the north-star records with slim_rec -----
    slim_cfg = dataclasses.replace(cfg, slim_rec=True)
    setup = frame_setup(world.device(dev), slim_cfg)
    rec, starts, counts = frame_records(None, slim_cfg, setup)
    payload = raster._pair_payload_stream(rec, setup["resolve_rec"])
    outs = fr.fine_raster_pairs(rec, starts, counts, payload=payload)
    refs = fr.fine_raster_pairs_reference(rec, starts, counts,
                                          payload=payload)
    torch.cuda.synchronize()
    mismatch = [words_differ(a, b) for a, b in zip(outs, refs)]
    _, tri_id = raster._untile(outs[0], outs[1], cfg)
    tri_id = tri_id[:HEIGHT, :WIDTH]
    img = raster._untile_payload(outs[2], tri_id, setup["resolve_rec"], cfg)
    want = setup["resolve_rec"][torch.clamp(tri_id.long(), min=0)]
    gather_mismatch = words_differ(img, want)
    pay = row("fine_raster_pairs_payload",
              lambda: fr.fine_raster_pairs(rec, starts, counts,
                                           payload=payload),
              "fine_raster_pairs_kernel", 20,
              lambda: fr.fine_raster_pairs_reference(rec, starts, counts,
                                                     payload=payload), 3,
              k1_bound(counts, 2, px_bytes=4 * payload.shape[1]),
              float((outs[0] - refs[0]).abs().max()))
    base_ms = time_cuda(lambda: fr.fine_raster_pairs(rec, starts, counts),
                        20)
    print(f"K1 fine_raster_pairs_payload ({payload.shape[1]} words): "
          f"mismatched words (depth, id, payload) {mismatch} of "
          f"({outs[0].numel()}, {outs[1].numel()}, {outs[2].numel()}); "
          f"payload image vs resolve_rec[max(tri_id, 0)]: "
          f"{gather_mismatch} of {img.numel()} words differ; {timing(pay)}; "
          f"base variant on the same records call {base_ms:.4f} ms "
          f"({card})", flush=True)
    if any(mismatch) or gather_mismatch:
        fail("K1 payload disagrees with its twin or the record gather")
    del setup, rec, starts, counts, payload, outs, refs, img, want

    # --- K2 vs twin on the north-star block records ----------------------
    block_cfg = dataclasses.replace(cfg, backend="xla",
                                    tile_tri_capacity=ns_k)
    blocks, counts = frame_blocks(world.device(dev), block_cfg)
    outs = fr.fine_raster_blocks(blocks, counts)
    refs = fr.fine_raster_blocks_reference(blocks, counts)
    torch.cuda.synchronize()
    mismatch = [int((a != b).sum()) for a, b in zip(outs, refs)]
    k2 = row("fine_raster_blocks",
             lambda: fr.fine_raster_blocks(blocks, counts),
             "fine_raster_blocks_kernel", 20,
             lambda: fr.fine_raster_blocks_reference(blocks, counts), 3,
             k1_bound(counts, 2, tile_bytes=4),
             float((outs[0] - refs[0]).abs().max()))
    print(f"K2 fine_raster_blocks (K {ns_k}): mismatched (depth, id) "
          f"{mismatch} of {outs[0].numel()} each; {timing(k2)}; K1 on the "
          f"pair records of the same frame call {k1['ms']:.4f} ms ({card})",
          flush=True)
    if any(mismatch):
        fail("K2 disagrees with its twin")
    print(f"K2 per-tile counts (north star): {count_histogram(counts)}",
          flush=True)
    del blocks, counts, outs, refs
    k2_edge_phase(dev, card)

    # --- K3 and its bf16 variant vs their twins, grid_sample beside ------
    # Two shapes: the 5-table fetch of ltc_matrix and the 1-table fetch of
    # each ltc_evaluate_rect call (4 of the 5 fetches a frame made before
    # the fused kernel took them over).
    g = torch.Generator(device="cpu").manual_seed(0)
    tables = [torch.randn(64, 64, generator=g).to(dev) for _ in range(5)]
    uv = torch.rand(HEIGHT, WIDTH, 2, generator=g).to(dev)
    uv = uv * (63.0 / 64.0) + 0.5 / 64.0
    corners = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]],
                           device=dev) * (63.0 / 64.0) + 0.5 / 64.0
    lib_grid = (uv * 2.0 - 1.0)[None]  # (1, H, W, 2), x = u indexes columns
    libs = {}
    for n in (5, 1):
        lib_in = torch.stack(tables[:n])[None]  # (1, n, 64, 64)

        def library(lib_in=lib_in):
            return F.grid_sample(lib_in, lib_grid, mode="bilinear",
                                 padding_mode="border", align_corners=False)

        lib_diff = float((library()[0] - torch.stack(
            lf.lut_fetch(tables[:n], uv))).abs().max())
        libs[n] = (time_cuda(library, 50),
                   device_ms(library, 50, "grid_sampler"), lib_diff)
    for name, bf16 in (("lut_fetch", False), ("lut_fetch_bf16", True)):
        err = 0.0
        for u in (uv, corners):
            got = lf.lut_fetch(tables, u, bf16=bf16)
            want = lf.lut_fetch_reference(tables, u, bf16=bf16)
            for a, b in zip(got, want):
                err = max(err, float((a - b).abs().max()))
        shapes = {}
        for n in (5, 1):
            shapes[n] = dict(
                ms=time_cuda(lambda: lf.lut_fetch(tables[:n], uv, bf16=bf16),
                             50),
                device_ms=device_ms(
                    lambda: lf.lut_fetch(tables[:n], uv, bf16=bf16), 50,
                    "lut_fetch_kernel"),
                plain_ms=time_cuda(lambda: lf.lut_fetch_reference(
                    tables[:n], uv, bf16=bf16), 10),
                library_ms=libs[n][0])
            b_ms, b_by = k3_bound(n, HEIGHT * WIDTH)
            shapes[n].update(bound_ms=b_ms, bound_by=b_by)
            print(f"K3 {name} ({n} table{'s' if n > 1 else ''}, "
                  f"{HEIGHT}x{WIDTH}): max abs diff {err}, call "
                  f"{fmt_ms(shapes[n]['ms'])}, device "
                  f"{fmt_ms(shapes[n]['device_ms'])}, twin "
                  f"{fmt_ms(shapes[n]['plain_ms'])}, grid_sample call "
                  f"{fmt_ms(libs[n][0])} device {fmt_ms(libs[n][1])} (max "
                  f"abs diff to the f32 kernel {libs[n][2]:.2e}), bound "
                  f"{b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        rows[name] = dict(max_abs_err=err, **shapes[5], one_table=shapes[1])
        if not err <= K3_TOL:
            fail(f"K3 {name} disagrees with its twin beyond {K3_TOL}")
    del tables, uv, lib_grid

    # --- K1 track2 vs twin on the masked frame's records -----------------
    masked_scene = masked_world.device(dev)
    if not masked_scene.alpha_masked:
        fail("the foliage scene is not alpha-masked")
    rec, starts, counts = frame_records(masked_scene, masked_cfg)
    outs = fr.fine_raster_pairs(rec, starts, counts, track2=True)
    refs = fr.fine_raster_pairs_reference(rec, starts, counts, track2=True)
    torch.cuda.synchronize()
    mismatch = [int((a != b).sum()) for a, b in zip(outs, refs)]
    t2 = row("fine_raster_pairs_track2",
             lambda: fr.fine_raster_pairs(rec, starts, counts, track2=True),
             "fine_raster_pairs_kernel", 20,
             lambda: fr.fine_raster_pairs_reference(rec, starts, counts,
                                                    track2=True), 3,
             k1_bound(counts, 4),
             max(float((outs[0] - refs[0]).abs().max()),
                 float((outs[2] - refs[2]).abs().max())))
    base_ms = time_cuda(lambda: fr.fine_raster_pairs(rec, starts, counts),
                        20)
    print(f"K1 fine_raster_pairs_track2: mismatched (depth, id, depth2, id2) "
          f"{mismatch} of {outs[0].numel()} each; runner-up pixels "
          f"{int((outs[3] >= 0).sum())}; {timing(t2)}; base variant on the "
          f"same records call {base_ms:.4f} ms ({card})", flush=True)
    if any(mismatch):
        fail("K1 track2 disagrees with its twin")
    masked_k = block_capacity(counts)
    del rec, starts, counts, outs, refs

    # --- K2 track2 vs twin on the masked frame's block records ----------
    masked_block_cfg = dataclasses.replace(masked_cfg, backend="xla",
                                           tile_tri_capacity=masked_k)
    blocks, counts = frame_blocks(masked_scene, masked_block_cfg)
    outs = fr.fine_raster_blocks(blocks, counts, track2=True)
    refs = fr.fine_raster_blocks_reference(blocks, counts, track2=True)
    torch.cuda.synchronize()
    mismatch = [int((a != b).sum()) for a, b in zip(outs, refs)]
    t2 = row("fine_raster_blocks_track2",
             lambda: fr.fine_raster_blocks(blocks, counts, track2=True),
             "fine_raster_blocks_kernel", 20,
             lambda: fr.fine_raster_blocks_reference(blocks, counts,
                                                     track2=True), 3,
             k1_bound(counts, 4, tile_bytes=4),
             max(float((outs[0] - refs[0]).abs().max()),
                 float((outs[2] - refs[2]).abs().max())))
    base_ms = time_cuda(lambda: fr.fine_raster_blocks(blocks, counts), 20)
    print(f"K2 fine_raster_blocks_track2 (K {masked_k}): mismatched "
          f"(depth, id, depth2, id2) {mismatch} of {outs[0].numel()} each; "
          f"runner-up pixels {int((outs[3] >= 0).sum())}; {timing(t2)}; K2 "
          f"base on the same blocks call {base_ms:.4f} ms ({card})",
          flush=True)
    if any(mismatch):
        fail("K2 track2 disagrees with its twin")
    print(f"K2 per-tile counts (masked): {count_histogram(counts)}",
          flush=True)
    del blocks, counts, outs, refs

    return rows, ns_k, masked_k, masked_scene


def ltc_rect_phases(dev, card, rows, world, masked_scene, cfg, masked_cfg):
    """The fused LTC kernel and its bf16 variant against their twin on the
    north-star and masked frames' own shade fields (0 differing words),
    timed as kernel_phases times the others; adds their rows to `rows`."""
    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.ops import ltc_rect as lr

    fields = {"north star": frame_ltc_inputs(pt, world.device(dev), cfg),
              "masked": frame_ltc_inputs(pt, masked_scene, masked_cfg)}
    for name, bf16 in (("ltc_rect", False), ("ltc_rect_bf16", True)):
        err, differ = 0.0, {}
        for label, args in fields.items():
            want = lr.ltc_rect_terms_reference(*args, bf16=bf16)
            got = lr.ltc_rect_terms(*args, bf16=bf16)
            torch.cuda.synchronize()
            differ[label] = [words_differ(a, b) for a, b in zip(got, want)]
            err = max(err, *[float((a - b).abs().max())
                             for a, b in zip(got, want)])
        args = fields["north star"]
        n_px, n_lights = args[3].numel(), args[4].shape[0]
        r = rows[name] = timed_row(
            lambda: lr.ltc_rect_terms(*args, bf16=bf16), "ltc_rect", 50,
            lambda: lr.ltc_rect_terms_reference(*args, bf16=bf16), 3,
            ltc_rect_bound(n_px, n_lights), err)
        print(f"fused LTC {name} ({n_lights} lights, {HEIGHT}x{WIDTH}): "
              f"differing words (diff, spec) by frame {differ}; max abs "
              f"diff {err}; {timing(r)} ({card})", flush=True)
        if any(any(d) for d in differ.values()):
            fail(f"fused LTC {name} disagrees with its twin")


def shadow_bound(n_lanes, n_rays, counts, table, inst, tri_pos):
    """The shadow-ray kernel must read each lane's active byte and write
    its hit byte, read each active ray (24 B), and read the node table,
    instance rows and triangle rows once; its FP32 operations are counted
    by the twin's walk on the same rays: 12 a node visit (the slab test),
    30 an instance entry (the ray's transform and 1/d), 40 a triangle
    test."""
    n_bytes = n_lanes * 2 + n_rays * 24 + 4 * (
        table.numel() + inst.numel() + tri_pos.numel())
    n_ops = (12 * counts.node_visits + 30 * counts.instance_entries
             + 40 * counts.triangle_tests)
    return bound_ms(n_bytes, n_ops)


def frame_shadow_rays(pt, scene, cfg, cam, scale):
    """The shadow-ray kernel's arguments as shade_raytraced hands them over
    in one frame of `scene` at `cam` (TAA off): (args, kwargs)."""
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.ops import shadow_trace as st

    seen = []
    real = st.occluded

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    st.occluded = capture
    try:
        Renderer(scene, cfg, enable_taa=False, enable_rt_shadows=True,
                 rt_shadow_scale=scale).render(cam)
    finally:
        st.occluded = real
    return seen[0]


def shadow_trace_check(args, kwargs):
    """The kernel against its twin on one ray set: (kernel result, twin
    result, twin walk counts, differing hits)."""
    import torch

    from voidin_tpu_torch.ops import shadow_trace as st
    from voidin_tpu_torch.rt import traverse

    got = st.occluded(*args, **kwargs)
    want, counts = traverse.occluded_reference(*args, **kwargs)
    torch.cuda.synchronize()
    return got, want, counts, int((got.hit != want.hit).sum())


def rt_phases(dev, card):
    """Raytraced shadows: the golden rt_shadows scene at 160x96 on the card
    against tests/golden/rt_shadows.png; the adversarial ray sets of
    shadow_edge_case, kernel against twin; config 5 at 1920x1080, 12
    frames at rt_shadow_scale 1 and 12 at 2 through Renderer.render, and
    the kernel against its twin on each scale's shadow rays, timed as
    kernel_phases times the others. Returns (the shadow_trace row, its
    launches on the scale-1 path)."""
    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch import native
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.ops import shadow_trace as st
    from voidin_tpu_torch.passes.raster import RasterConfig
    from voidin_tpu_torch.rt import traverse

    # --- golden rt_shadows: card vs golden image and vs the CPU twins ----
    gw, gh = 160, 96
    gcfg = RasterConfig(width=gw, height=gh, tri_capacity=1 << 16,
                        pair_capacity=1 << 17)
    imgs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        r = Renderer(golden_scene(pt).device(d, with_tlas=True), gcfg,
                     enable_taa=False, enable_rt_shadows=True)
        imgs[where] = r.render(pt.Camera(position=[0, 2, 0], pitch=-18.0,
                                         aspect=gw / gh)).cpu().numpy()
        if int(r.aux["overflow"]) or int(r.aux["rt_exhausted"]):
            fail(f"golden rt_shadows scene overflowed or exhausted on the "
                 f"{where}")
    want = golden_rgb("rt_shadows")
    gold_diff = float(np.abs(np.clip(imgs["card"], 0, 1) - want).mean())
    cpu_diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"golden rt_shadows 160x96 on the card: mean abs diff vs "
          f"tests/golden/rt_shadows.png {gold_diff:.6f} (budget "
          f"{GOLDEN_BUDGET}), vs the CPU twins {cpu_diff:.3e}", flush=True)
    if not (np.isfinite(imgs["card"]).all() and gold_diff < GOLDEN_BUDGET
            and cpu_diff < GOLDEN_BUDGET):
        fail("golden rt_shadows render disagrees")

    # --- adversarial ray sets: kernel vs twin ----------------------------
    for kind in SHADOW_EDGE_CASES:
        world, o, d, act = shadow_edge_case(pt, kind)
        scene = world.device(dev, with_tlas=True)
        args = traverse.scene_rays_threaded(scene) + tuple(
            torch.from_numpy(a).to(dev) for a in (o, d))
        kwargs = dict(active=torch.from_numpy(act).to(dev),
                      max_leaf=scene.meshes.bvh_max_leaf)
        reset_launches()
        got, want, counts, differ = shadow_trace_check(args, kwargs)
        n_launch = st.LAUNCHES
        print(f"shadow_trace edge set {kind}: {len(o)} rays "
              f"({int(act.sum())} active), hits {int(got.hit.sum())}, "
              f"differing hits {differ}, exhausted kernel "
              f"{int(got.exhausted)} twin {int(want.exhausted)}, leaves <= "
              f"{scene.meshes.bvh_max_leaf}, {counts}, launches {n_launch} "
              f"({card})", flush=True)
        if differ or int(got.exhausted) or int(want.exhausted) \
                or n_launch != (1 if len(o) else 0):
            fail(f"shadow_trace disagrees with its twin on edge set {kind}")

    # --- config 5 at 1080p through the Renderer --------------------------
    t0 = time.perf_counter()
    world = config5_world(pt)
    t_blas = time.perf_counter() - t0
    t0 = time.perf_counter()
    tlas = world.build_tlas()
    t_tlas = time.perf_counter() - t0
    print(f"config 5: {native.builder()} BVH builder; World with its BLASes "
          f"(4 builtin meshes, the knot, the sphere) {t_blas * 1e3:.1f} ms, "
          f"TLAS over {len(world.instances)} instances "
          f"({tlas['tlas_min'].shape[0]} nodes; instance AABBs, build, exit "
          f"links, refit plan) {t_tlas * 1e3:.1f} ms on the host",
          flush=True)
    scene = world.device(dev, with_tlas=True)
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 17,
                       pair_capacity=1 << 19)
    cam = pt.Camera(**CONFIG5_CAMERA, aspect=WIDTH / HEIGHT)
    out_rows, launches, frame_ms = {}, None, {}
    for scale in (1, 2):
        label = f"config 5 scale {scale}"
        r = Renderer(scene, cfg, enable_taa=False, enable_rt_shadows=True,
                     rt_shadow_scale=scale)
        reset_launches()
        out, times, mem = run_frames(r, cam, label)
        got = expect_launches(label, dict(k1=FRAMES, shadow_trace=FRAMES))
        if scale == 1:
            launches = got["shadow_trace"]
        frame_ms[scale] = float(np.median(times[2:]))
        print(f"config 5 {WIDTH}x{HEIGHT} rt_shadow_scale {scale}: median "
              f"{frame_ms[scale]:.3f} ms/frame over frames 3-{FRAMES} "
              f"({card}); {mem}; shadow rays {int(r.aux['rt_rays'])}, "
              f"exhausted {int(r.aux['rt_exhausted'])}, overflow "
              f"{int(r.aux['overflow'])}; image mean {out.mean():.4f} std "
              f"{out.std():.4f}", flush=True)
        del r

        args, kwargs = frame_shadow_rays(pt, scene, cfg, cam, scale)
        got, want, counts, differ = shadow_trace_check(args, kwargs)
        n_lanes = args[4].shape[0]
        act = kwargs.get("active")  # None: a package that compacts rays
        n_rays = n_lanes if act is None else int(act.sum())
        row = timed_row(lambda: st.occluded(*args, **kwargs),
                        "shadow_trace_kernel", 20,
                        lambda: traverse.occluded_reference(*args, **kwargs),
                        1, shadow_bound(n_lanes, n_rays, counts, args[0],
                                        args[2], args[3]), float(differ > 0))
        row.update(lanes=n_lanes, rays=n_rays, hits=int(got.hit.sum()),
                   node_visits=counts.node_visits,
                   instance_entries=counts.instance_entries,
                   triangle_tests=counts.triangle_tests,
                   frame_ms=frame_ms[scale])
        out_rows[scale] = row
        print(f"shadow_trace (config 5, scale {scale}): {n_rays} active rays "
              f"of {n_lanes} lanes, hits "
              f"{row['hits']}, differing hits {differ}, exhausted kernel "
              f"{int(got.exhausted)} twin {int(want.exhausted)}; {counts}; "
              f"{timing(row)}; launches a frame 1 ({card})", flush=True)
        if differ or int(got.exhausted) or int(want.exhausted):
            fail(f"shadow_trace disagrees with its twin on the config-5 "
                 f"rays at scale {scale}")
    row = dict(out_rows[1], scale2=out_rows[2])
    return row, launches


def closest_bound(n_rays, counts, tlas, blas, inst, tri_pos):
    """The closest-hit kernel must read each ray (24 B) and write its t
    and visits (8 B), and read the TLAS, BLAS, instance and triangle rows
    once; its FP32 operations are counted by the twin's walk on the same
    rays, as shadow_bound counts them: 12 a node visit, 30 an instance
    entry, 40 a triangle test."""
    n_bytes = n_rays * 32 + 4 * (tlas.numel() + blas.numel() + inst.numel()
                                 + tri_pos.numel())
    n_ops = (12 * counts.node_visits + 30 * counts.instance_entries
             + 40 * counts.triangle_tests)
    return bound_ms(n_bytes, n_ops)


def closest_hit_check(args, kwargs):
    """The closest-hit kernel against its twin on one ray set: (kernel
    result, twin result, twin walk counts, {output: differing words or
    count difference})."""
    import torch

    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.rt import traverse

    got = ch.closest_hit(*args, **kwargs)
    want, counts = traverse.closest_hit_reference(*args, **kwargs)
    torch.cuda.synchronize()
    return got, want, counts, dict(
        t=words_differ(got.t, want.t),
        visits=int((got.visits != want.visits).sum()),
        overflow=abs(int(got.overflow) - int(want.overflow)),
        exhausted=abs(int(got.exhausted) - int(want.exhausted)))


def closest_phases(dev, card):
    """Closest hit: the kernel against its twin on the adversarial ray sets
    of shadow_edge_case and on staircase_case's overflowing stack; the
    bvh_trace example's scene and config 5's
    scene with their cameras' 1920x1080 primary rays through the example's
    trace (launch counted), then kernel against twin on those rays, timed
    as kernel_phases times the others; the example module at its own size.
    Every t word, visit count and counter equal, nothing overflowed or
    exhausted. Returns (the closest_hit row, its launches on the bvh_trace
    path)."""
    import tempfile

    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.examples import bvh_trace
    from voidin_tpu_torch.io.image import load_image
    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.rt import traverse

    for kind in SHADOW_EDGE_CASES:
        world, o, d, act = shadow_edge_case(pt, kind)
        scene = world.device(dev, with_tlas=True)
        args = traverse.scene_rays(scene) + tuple(
            torch.from_numpy(a).to(dev) for a in (o, d))
        kwargs = dict(active=torch.from_numpy(act).to(dev))
        reset_launches()
        got, want, counts, differ = closest_hit_check(args, kwargs)
        n_launch = ch.LAUNCHES
        print(f"closest_hit edge set {kind}: {len(o)} rays ({int(act.sum())} "
              f"active), hits {int((got.t < traverse.MAX_DIST).sum())}, "
              f"differing {differ}, overflow {int(got.overflow)} exhausted "
              f"{int(got.exhausted)}, {counts}, launches {n_launch} "
              f"({card})", flush=True)
        if any(differ.values()) or int(got.overflow) or int(got.exhausted) \
                or n_launch != (1 if len(o) else 0):
            fail(f"closest_hit disagrees with its twin on edge set {kind}")
    world, o, d = staircase_case(pt)
    args = traverse.scene_rays(world.device(dev, with_tlas=True)) + tuple(
        torch.from_numpy(a).to(dev) for a in (o, d))
    got, want, counts, differ = closest_hit_check(args, {})
    print(f"closest_hit on a tree deeper than its stack: overflow kernel "
          f"{int(got.overflow)} twin {int(want.overflow)}, differing "
          f"{differ} ({card})", flush=True)
    if any(differ.values()) or not int(got.overflow) > 0:
        fail("closest_hit disagrees with its twin where the stack overflows")

    rows, launches = {}, None
    for label, world, camera in (
            ("bvh_trace scene", bvh_trace.trace_world(), None),
            ("config 5", config5_world(pt), CONFIG5_CAMERA)):
        scene = world.device(dev, with_tlas=True)
        reset_launches()
        res = bvh_trace.trace(scene, WIDTH, HEIGHT, camera)
        torch.cuda.synchronize()
        got_l = expect_launches(f"closest hit, {label}", dict(closest_hit=1))
        if launches is None:
            launches = got_l["closest_hit"]
        o, d = bvh_trace.primary_rays(WIDTH, HEIGHT, camera)
        args = traverse.scene_rays(scene) + (torch.from_numpy(o).to(dev),
                                             torch.from_numpy(d).to(dev))
        kwargs = dict(t_max=bvh_trace.T_MAX)
        got, want, counts, differ = closest_hit_check(args, kwargs)
        path_differ = words_differ(res.t.reshape(-1), got.t)
        row = timed_row(lambda: ch.closest_hit(*args, **kwargs),
                        "closest_hit_kernel", 20,
                        lambda: traverse.closest_hit_reference(*args,
                                                               **kwargs), 1,
                        closest_bound(len(o), counts, *args[:4]),
                        float((got.t - want.t).abs().max()))
        hits = int((got.t < bvh_trace.T_MAX).sum())
        row.update(rays=len(o), hits=hits, node_visits=counts.node_visits,
                   instance_entries=counts.instance_entries,
                   triangle_tests=counts.triangle_tests,
                   max_visits=int(got.visits.max()),
                   instances=int(scene.instances.count),
                   tlas_nodes=int(scene.tlas.tlas_min.shape[0]))
        rows[label] = row
        print(f"closest_hit ({label}, {WIDTH}x{HEIGHT} primary rays, "
              f"{row['instances']} instances, TLAS of {row['tlas_nodes']} "
              f"nodes): hits {hits}, differing {differ}, path vs kernel t "
              f"words {path_differ}, overflow {int(got.overflow)} exhausted "
              f"{int(got.exhausted)}; {counts}, max visits "
              f"{row['max_visits']}; {timing(row)} ({card})", flush=True)
        if any(differ.values()) or path_differ or int(got.overflow) \
                or int(got.exhausted) or int(res.overflow) \
                or int(res.exhausted):
            fail(f"closest_hit disagrees with its twin on {label}")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bvh_trace.png")
        reset_launches()
        bvh_trace.main(["--out", out])
        expect_launches("the bvh_trace example", dict(closest_hit=1))
        img = load_image(out)
    if img.shape != (288, 512, 4) or not img[..., :3].std() > 0:
        fail(f"the bvh_trace example's image is bad: {img.shape}")
    return dict(rows["bvh_trace scene"], config5=rows["config 5"]), launches


def refit_violations(world, knot, meshes, tlas, instances, eps=1e-5):
    """Checks the skinned knot's refit BLAS and the refit TLAS (device
    tensors) on the host: every reachable node contains its triangles or
    children (TLAS leaves their instance's world AABB from the refit mesh
    bounds), and each root equals the bounds of what it holds within
    1e-4. Returns the count of violations of each kind."""
    from voidin_tpu_torch.rt import bvh as bvh_mod

    nodes = world.meshes.bvh_nodes[knot]
    skin = world.skins[0]
    base = world.meshes.mesh_info[knot]["bvh_index"]
    bmin = meshes.bvh_min.cpu().numpy()[base:base + len(nodes)]
    bmax = meshes.bvh_max.cpu().numpy()[base:base + len(nodes)]
    pos = meshes.tri_pos.cpu().numpy().reshape(-1, 3, 3)[
        skin.base_tri:skin.base_tri + skin.rest_pos.shape[0]]
    bad = dict(blas=0, blas_root=0, tlas=0, tlas_root=0)
    stack = [0]
    while stack:
        n = stack.pop()
        lo = int(nodes["left_first"][n])
        if nodes["count"][n] > 0:
            tris = pos[lo:lo + int(nodes["count"][n])].reshape(-1, 3)
            bad["blas"] += int(not ((bmin[n] <= tris.min(0) + eps).all()
                                    and (bmax[n] >= tris.max(0) - eps).all()))
            continue
        for c in (lo, lo + 1):
            bad["blas"] += int(not ((bmin[n] <= bmin[c] + eps).all()
                                    and (bmax[n] >= bmax[c] - eps).all()))
            stack.append(c)
    flat = pos.reshape(-1, 3)
    bad["blas_root"] = int(not (np.allclose(bmin[0], flat.min(0), atol=1e-4)
                                and np.allclose(bmax[0], flat.max(0),
                                                atol=1e-4)))
    imin, imax = bvh_mod.instance_world_aabbs(
        meshes.mesh_min.cpu().numpy(), meshes.mesh_max.cpu().numpy(),
        instances.transform.cpu().numpy(), instances.mesh_id.cpu().numpy())
    tmin, tmax = tlas.tlas_min.cpu().numpy(), tlas.tlas_max.cpu().numpy()
    lr = tlas.tlas_left_right.cpu().numpy().view(np.uint32)
    inst = tlas.tlas_instance.cpu().numpy()
    for n in range(len(lr)):
        if lr[n] == 0:
            held = [(imin[inst[n]], imax[inst[n]])]
        else:
            held = [(tmin[c], tmax[c]) for c in (lr[n] & 0xFFFF, lr[n] >> 16)]
        bad["tlas"] += sum(int(not ((tmin[n] <= lo + eps).all()
                                    and (tmax[n] >= hi - eps).all()))
                           for lo, hi in held)
    bad["tlas_root"] = int(not (np.allclose(tmin[0], imin.min(0), atol=1e-4)
                                and np.allclose(tmax[0], imax.max(0),
                                                atol=1e-4)))
    return bad


def skin_phases(dev, card):
    """The skinned frame: config 5 with its knot a skin of 2 joints
    (config5_world(skinned=True)) bent by knot_joint_mats, raytraced
    shadows, no TAA: 12 frames at 1920x1080 through Renderer.render
    (overflow 0, no shadow ray at the step limit, K1 and the shadow kernel
    launched once a frame), the last pose's refit BLAS and TLAS valid and
    tight (refit_violations), then the scene at 320x184 on the card against
    the port's CPU render (mean 5e-3). Returns the median ms/frame."""
    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.passes.raster import RasterConfig
    from voidin_tpu_torch.scene import skin as skin_mod

    world = config5_world(pt, skinned=True)
    knot = world.skins[0].mesh_id
    scene = world.device(dev, with_tlas=True)
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 17,
                       pair_capacity=1 << 19)
    cam = pt.Camera(**CONFIG5_CAMERA, aspect=WIDTH / HEIGHT)
    r = Renderer(scene, cfg, enable_taa=False, enable_rt_shadows=True)
    reset_launches()
    out, times, mem = run_frames(r, cam, "skinned config 5", knot_joint_mats)
    expect_launches("skinned config 5", dict(k1=FRAMES, shadow_trace=FRAMES))
    ms = float(np.median(times[2:]))
    n_inst = int((scene.instances.mesh_id == knot).sum())
    print(f"skinned config 5 {WIDTH}x{HEIGHT} (the knot a 2-joint skin of "
          f"{world.skins[0].rest_pos.shape[0]} triangles, {n_inst} "
          f"instances; rt shadows): median {ms:.3f} ms/frame over frames "
          f"3-{FRAMES} ({card}); {mem}; shadow rays {int(r.aux['rt_rays'])}, "
          f"exhausted {int(r.aux['rt_exhausted'])}; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    jm = torch.from_numpy(knot_joint_mats(FRAMES - 1)).to(dev)
    meshes = skin_mod.apply_skins(scene.meshes, scene.skins, jm)
    tlas = skin_mod.refit_tlas(scene.tlas, meshes, scene.instances)
    bad = refit_violations(world, knot, meshes, tlas, scene.instances)
    moved = float((meshes.bvh_max - scene.meshes.bvh_max).abs().max())
    print(f"skinned config 5, last pose's refits on the card: violations "
          f"{bad}; BLAS AABBs moved up to {moved:.4f} from the rest pose",
          flush=True)
    if any(bad.values()) or not moved > 0:
        fail("the skinned knot's refit BLAS or TLAS does not hold its pose")
    del r, scene, meshes, tlas

    sw, sh = 320, 184
    scfg = RasterConfig(width=sw, height=sh, tri_capacity=1 << 17,
                        pair_capacity=1 << 17)
    imgs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        r = Renderer(config5_world(pt, skinned=True).device(
            d, with_tlas=True), scfg, enable_taa=False,
            enable_rt_shadows=True)
        for i in range(2):
            img = r.render(pt.Camera(**CONFIG5_CAMERA, aspect=sw / sh),
                           joint_mats=knot_joint_mats(i + 3))
            if int(r.aux["overflow"]) or int(r.aux["rt_exhausted"]):
                fail(f"small skinned frame overflowed on the {where}")
        imgs[where] = img.cpu().numpy()
    diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"skinned config 5 {sw}x{sh} (2 poses) on the card: mean abs diff "
          f"vs the CPU twins {diff:.3e} (budget {GOLDEN_BUDGET})", flush=True)
    if not (np.isfinite(imgs["card"]).all() and diff < GOLDEN_BUDGET):
        fail("the small skinned frame on the card disagrees with the CPU")
    return ms


def ring_phases(dev, card):
    """The ring light: the golden ring_light scene at 160x96 through the
    example's render on the card against tests/golden/ring_light.png and
    the port's CPU render (mean 5e-3); the scene at 1920x1080 for 12
    frames (K1 and K3 launched once a frame, the fused LTC kernel never; a
    finite image with variance); then K3 against its twin on that frame's
    own 5-channel uvs (max abs diff <= 1e-6), timed. Returns (K3's ring
    row, its launches on the ring path, the median ms/frame)."""
    import torch

    from voidin_tpu_torch.examples import ring_light
    from voidin_tpu_torch.ops import lut_fetch as lf

    imgs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        imgs[where] = ring_light.render(ring_light.ring_world().device(d),
                                        160, 96).cpu().numpy()
    gold_diff = float(np.abs(np.clip(imgs["card"], 0, 1)
                             - golden_rgb("ring_light")).mean())
    cpu_diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"golden ring_light 160x96 on the card: mean abs diff vs "
          f"tests/golden/ring_light.png {gold_diff:.6f} (budget "
          f"{GOLDEN_BUDGET}), vs the CPU twins {cpu_diff:.3e}", flush=True)
    if not (np.isfinite(imgs["card"]).all() and gold_diff < GOLDEN_BUDGET
            and cpu_diff < GOLDEN_BUDGET):
        fail("golden ring_light render disagrees")

    scene = ring_light.ring_world().device(dev)
    caps = dict(tri_capacity=1 << 16, pair_capacity=1 << 19)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, img = [], None
    for _ in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = ring_light.render(scene, WIDTH, HEIGHT, **caps)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    got_l = expect_launches("ring light", dict(k1=FRAMES, k3=FRAMES))
    out = img.cpu().numpy()
    ms = float(np.median(times[2:]))
    print(f"ring light {WIDTH}x{HEIGHT}: median {ms:.3f} ms/frame over "
          f"frames 3-{FRAMES} ({card}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    if out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all() \
            or not out.std() > 0:
        fail("the ring light image is bad")

    seen, real = [], lf.lut_fetch

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    lf.lut_fetch = capture
    try:
        ring_light.render(scene, WIDTH, HEIGHT, **caps)
    finally:
        lf.lut_fetch = real
    (tables, uv), kwargs = seen[0]
    got = lf.lut_fetch(tables, uv, **kwargs)
    want = lf.lut_fetch_reference(tables, uv, **kwargs)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    row = dict(path="shade_ring_light's ltc_matrix, once a frame",
               max_abs_err=err, tables=len(tables),
               ms=time_cuda(lambda: lf.lut_fetch(tables, uv, **kwargs), 50),
               device_ms=device_ms(lambda: lf.lut_fetch(tables, uv, **kwargs),
                                   50, "lut_fetch_kernel"),
               frame_ms=ms)
    print(f"K3 lut_fetch on the ring frame's own uvs ({len(tables)} tables, "
          f"{uv.shape[0]}x{uv.shape[1]}): max abs diff to its twin {err}, "
          f"call {fmt_ms(row['ms'])}, device {fmt_ms(row['device_ms'])} "
          f"({card})", flush=True)
    if not err <= K3_TOL:
        fail(f"K3 disagrees with its twin on the ring uvs beyond {K3_TOL}")
    return row, got_l["k3"], ms


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              flush=True)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework.renderer import Renderer, build_world
    from voidin_tpu_torch import native
    from voidin_tpu_torch.ops import _build
    from voidin_tpu_torch.passes import cull, raster, shading
    from voidin_tpu_torch.passes.raster import RasterConfig

    if "jax" in sys.modules or "voidin_tpu" in sys.modules:
        fail("the port pulled in jax or the JAX package")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"host BVH builder: {native.builder()} (ready in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=CAP,
                       pair_capacity=CAP)
    masked_cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=CAP,
                              pair_capacity=MASKED_PAIR_CAP)
    world, moving = build_world(10_000, seed=0)
    masked_world, masked_moving = build_world(10_000, seed=0)
    add_foliage(masked_world, N_FOLIAGE, seed=1)
    rows, ns_k, masked_k, masked_scene = kernel_phases(
        dev, card, world, masked_world, cfg, masked_cfg)
    ltc_rect_phases(dev, card, rows, world, masked_scene, cfg, masked_cfg)
    block_cfg = dataclasses.replace(cfg, backend="xla",
                                    tile_tri_capacity=ns_k)
    slim_cfg = dataclasses.replace(cfg, slim_rec=True)

    # --- golden scene: card vs golden image and vs the CPU twins --------
    gw, gh = 160, 96
    gcfg = RasterConfig(width=gw, height=gh, tri_capacity=1 << 16,
                        pair_capacity=1 << 17)
    gcam = dict(position=[0, 2, 0], pitch=-18.0, aspect=gw / gh)
    imgs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        r = Renderer(golden_scene(pt).device(d), gcfg, enable_taa=False)
        imgs[where] = r.render(pt.Camera(**gcam)).cpu().numpy()
        if int(r.aux["overflow"]):
            fail("golden scene overflowed")
    want = golden_rgb("deferred")
    gold_diff = float(np.abs(np.clip(imgs["card"], 0, 1) - want).mean())
    cpu_diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"golden deferred 160x96 on the card: mean abs diff vs "
          f"tests/golden/deferred.png {gold_diff:.6f} (budget "
          f"{GOLDEN_BUDGET}), vs the CPU twins {cpu_diff:.3e}", flush=True)
    if not (np.isfinite(imgs["card"]).all() and gold_diff < GOLDEN_BUDGET
            and cpu_diff < GOLDEN_BUDGET):
        fail("golden scene render disagrees")

    # --- the masked scene, small: card vs the CPU twins ------------------
    sw, sh = 320, 184
    scfg = RasterConfig(width=sw, height=sh, tri_capacity=1 << 15,
                        pair_capacity=1 << 15)
    small, small_moving = build_world(1000, seed=0)
    add_foliage(small, 300, seed=1)
    imgs, cuts = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        r = Renderer(small.device(d), scfg, moving_ids=small_moving)
        for _ in range(3):
            img = r.render(pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                                     aspect=sw / sh))
            if int(r.aux["overflow"]):
                fail(f"small masked scene overflowed on the {where}")
        imgs[where] = img.cpu().numpy()
        cuts[where] = int(r.aux["alpha_cut"])
    small_diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"masked scene 320x184 (build_world(1000) + 300 cards, 3 TAA "
          f"frames) on the card: mean abs diff vs the CPU twins "
          f"{small_diff:.3e} (budget {GOLDEN_BUDGET}); cut winners card "
          f"{cuts['card']} CPU {cuts['cpu']}", flush=True)
    if not (np.isfinite(imgs["card"]).all() and small_diff < GOLDEN_BUDGET
            and cuts["card"] > 0):
        fail("small masked scene on the card disagrees with the CPU")

    # --- the masked scene, small, on the block path: card vs CPU ---------
    small_cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                          aspect=sw / sh)
    rec, starts, counts = frame_records(small.device(dev), scfg,
                                        cam=small_cam)
    sbcfg = dataclasses.replace(scfg, backend="xla", pair_capacity=1 << 16,
                                tile_tri_capacity=block_capacity(counts))
    del rec, starts, counts
    imgs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        r = Renderer(small.device(d), sbcfg, moving_ids=small_moving)
        reset_launches()
        for _ in range(3):
            img = r.render(small_cam)
            if int(r.aux["overflow"]):
                fail(f"small masked block-path scene overflowed on the "
                     f"{where}")
        if where == "card":
            small_block_launches = expect_launches(
                "small masked block path", dict(k2_track2=3, ltc_rect=3))
        imgs[where] = img.cpu().numpy()
    small_diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"masked scene 320x184 on the block path (K "
          f"{sbcfg.tile_tri_capacity}, 3 TAA frames) on the card: mean abs "
          f"diff vs the CPU twins {small_diff:.3e} (budget "
          f"{GOLDEN_BUDGET})", flush=True)
    if not (np.isfinite(imgs["card"]).all() and small_diff < GOLDEN_BUDGET):
        fail("small masked block-path scene on the card disagrees with the "
             "CPU")

    # --- the north-star frame through the Renderer ----------------------
    r = Renderer(world.device(dev), cfg, moving_ids=moving)
    reset_launches()
    out, times, mem = run_frames(r, north_star_camera(pt), "north-star")
    ns_launches = expect_launches("north-star", dict(
        k1=FRAMES, ltc_rect=FRAMES))
    ns_ms = float(np.median(times[2:]))
    print(f"north-star frame {WIDTH}x{HEIGHT}: median {ns_ms:.3f} ms/frame "
          f"over frames 3-{FRAMES} ({card}); {mem}; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    ns_img = out
    del r

    # --- the block-path north-star frame ---------------------------------
    # One VisBuffer of each path at the first frame's camera: both take
    # the max of the same baked planes, so depth is bit-identical; ids may
    # differ only where depths tie.
    scene = world.device(dev)
    uniform = north_star_camera(pt).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, uniform)
    vis = {c.backend: raster.rasterize(scene.meshes, scene.instances, draws,
                                       uniform, c, materials=scene.materials)
           for c in (cfg, block_cfg)}
    same_depth = torch.equal(vis["pallas"].depth, vis["xla"].depth)
    id_differ = int((vis["pallas"].tri_id != vis["xla"].tri_id).sum())
    print(f"block path vs pair path, one VisBuffer: depth bit-identical "
          f"{same_depth}, ids differ at {id_differ} of {WIDTH * HEIGHT} "
          f"pixels (depth ties); overflow {int(vis['pallas'].overflow)} / "
          f"{int(vis['xla'].overflow)}", flush=True)
    if not same_depth or int(vis["xla"].overflow):
        fail("the block path's depth differs from the pair path's")
    del scene, vis
    r = Renderer(world.device(dev), block_cfg, moving_ids=moving)
    reset_launches()
    out, times, mem = run_frames(r, north_star_camera(pt), "block-path")
    block_launches = expect_launches("block-path", dict(
        k2=FRAMES, ltc_rect=FRAMES))
    block_ms = float(np.median(times[2:]))
    print(f"block-path north-star frame {WIDTH}x{HEIGHT} (backend xla, K "
          f"{ns_k}): median {block_ms:.3f} ms/frame over frames 3-{FRAMES} "
          f"({card}) vs pair path {ns_ms:.3f}; {mem}; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    del r

    # --- the slim north-star frames, without and with the payload --------
    slim_imgs, slim_ms = {}, {}
    for payload in (False, True):
        label = "slim + payload" if payload else "slim"
        r = Renderer(world.device(dev), dataclasses.replace(
            slim_cfg, kernel_payload=payload), moving_ids=moving)
        reset_launches()
        slim_imgs[payload], times, mem = run_frames(
            r, north_star_camera(pt), label)
        got = expect_launches(label, dict(
            k1_payload=FRAMES if payload else 0,
            k1=0 if payload else FRAMES, ltc_rect=FRAMES))
        if payload:
            payload_launches = got
        slim_ms[payload] = float(np.median(times[2:]))
        print(f"{label} north-star frame {WIDTH}x{HEIGHT}: median "
              f"{slim_ms[payload]:.3f} ms/frame over frames 3-{FRAMES} "
              f"({card}); {mem}", flush=True)
        del r
    same = np.array_equal(slim_imgs[False], slim_imgs[True])
    slim_diff = float(np.abs(slim_imgs[True] - ns_img).mean())
    print(f"slim + payload frame identical to the slim frame: {same}; mean "
          f"abs diff to the default north-star frame {slim_diff:.3e} "
          f"(budget {GOLDEN_BUDGET}); ms/frame default {ns_ms:.3f}, slim "
          f"{slim_ms[False]:.3f}, slim + payload {slim_ms[True]:.3f}",
          flush=True)
    if not same or not slim_diff < GOLDEN_BUDGET:
        fail("the slim + payload frame strays")
    del world

    # --- the masked frame through the Renderer ---------------------------
    r = Renderer(masked_scene, masked_cfg, moving_ids=masked_moving)
    if not r.config.alpha_mask:
        fail("the Renderer did not switch the alpha mask on")
    reset_launches()
    out, times, mem = run_frames(r, north_star_camera(pt), "masked")
    masked_launches = expect_launches("masked", dict(
        k1_track2=FRAMES, ltc_rect=FRAMES))
    masked_ms = float(np.median(times[2:]))
    print(f"masked frame {WIDTH}x{HEIGHT} (north star + {N_FOLIAGE} foliage "
          f"cards): "
          f"median {masked_ms:.3f} ms/frame over frames 3-{FRAMES} ({card}) "
          f"vs north star {ns_ms:.3f}; {mem}; image mean {out.mean():.4f} "
          f"std {out.std():.4f}", flush=True)
    del r, masked_scene

    # --- the bf16 LUT fetch against f32, frame by frame ------------------
    # tests/test_ltc.py:429-432 holds a bf16 frame of its golden scene
    # (TAA off) within max 1e-2 and mean 2e-4 of the f32 frame: that pair
    # on that scene, then the masked 1080p frame (where the K3 bf16
    # launches are counted) within the mean budget, its max printed.
    def bf16_pair(make_scene, rcfg, cam):
        frames = {}
        for bf16 in (False, True):
            shading.LTC_LUT_BF16 = bf16
            try:
                r = Renderer(make_scene(), rcfg, enable_taa=False)
                reset_launches()
                frames[bf16] = r.render(cam).cpu().numpy()
            finally:
                shading.LTC_LUT_BF16 = False
            if int(r.aux["overflow"]):
                fail("bf16 comparison frame overflowed")
        diff = np.abs(frames[True].astype(np.float64) - frames[False])
        if not np.isfinite(frames[True]).all():
            fail("the bf16 LUT frame is not finite")
        return diff

    diff = bf16_pair(lambda: golden_scene(pt).device(dev), gcfg,
                     pt.Camera(**gcam))
    print(f"golden 160x96 with LTC_LUT_BF16: max abs diff to the f32 frame "
          f"{diff.max():.3e} (budget {BF16_BUDGET}), mean {diff.mean():.3e} "
          f"(budget {BF16_MEAN_BUDGET})", flush=True)
    if not (diff.max() < BF16_BUDGET and diff.mean() < BF16_MEAN_BUDGET):
        fail("the bf16 LUT golden frame strays from the f32 frame")
    diff = bf16_pair(lambda: masked_world.device(dev), masked_cfg,
                     north_star_camera(pt))
    bf16_launches = expect_launches("masked bf16 frame", dict(
        k1_track2=1, ltc_rect_bf16=1))
    worst = np.unravel_index(np.argmax(diff), diff.shape)
    print(f"masked {WIDTH}x{HEIGHT} with LTC_LUT_BF16: max abs diff to the "
          f"f32 frame {diff.max():.3e} at {tuple(int(i) for i in worst)}, "
          f"{int((diff >= BF16_BUDGET).sum())} values >= {BF16_BUDGET}, "
          f"mean {diff.mean():.3e} (budget {BF16_MEAN_BUDGET})", flush=True)
    if not diff.mean() < BF16_MEAN_BUDGET:
        fail("the bf16 LUT masked frame strays from the f32 frame")

    rows["shadow_trace"], rt_launches = rt_phases(dev, card)
    rows["closest_hit"], closest_launches = closest_phases(dev, card)
    skin_phases(dev, card)
    rows["lut_fetch"]["ring"], ring_k3_launches, _ = ring_phases(dev, card)

    path_launches = dict(
        fine_raster_pairs=ns_launches["k1"],
        fine_raster_pairs_track2=masked_launches["k1_track2"],
        fine_raster_pairs_payload=payload_launches["k1_payload"],
        fine_raster_blocks=block_launches["k2"],
        fine_raster_blocks_track2=small_block_launches["k2_track2"],
        lut_fetch=ring_k3_launches,
        lut_fetch_bf16=bf16_launches["k3_bf16"],
        ltc_rect=ns_launches["ltc_rect"],
        ltc_rect_bf16=bf16_launches["ltc_rect_bf16"],
        shadow_trace=rt_launches,
        closest_hit=closest_launches,
    )
    meta = dict(
        fine_raster_pairs=("voidin_tpu_torch/csrc/fine_raster.cu",
                           "voidin_tpu/ops/fine_raster.py:113"),
        fine_raster_pairs_track2=("voidin_tpu_torch/csrc/fine_raster.cu",
                                  "voidin_tpu/ops/fine_raster.py:214"),
        fine_raster_pairs_payload=("voidin_tpu_torch/csrc/fine_raster.cu",
                                   "voidin_tpu/ops/fine_raster.py:222"),
        fine_raster_blocks=("voidin_tpu_torch/csrc/fine_raster.cu",
                            "voidin_tpu/ops/fine_raster.py:390"),
        fine_raster_blocks_track2=("voidin_tpu_torch/csrc/fine_raster.cu",
                                   "voidin_tpu/passes/raster.py:957"),
        lut_fetch=("voidin_tpu_torch/csrc/lut_fetch.cu",
                   "voidin_tpu/ops/lut_fetch.py:43"),
        lut_fetch_bf16=("voidin_tpu_torch/csrc/lut_fetch.cu",
                        "voidin_tpu/ops/lut_fetch.py:59"),
        ltc_rect=("voidin_tpu_torch/csrc/ltc_rect.cu",
                  "voidin_tpu/ops/lut_fetch.py:43"),
        ltc_rect_bf16=("voidin_tpu_torch/csrc/ltc_rect.cu",
                       "voidin_tpu/ops/lut_fetch.py:59"),
        # no TPU kernel: the JAX package's stackless traversal in plain jnp
        shadow_trace=("voidin_tpu_torch/csrc/shadow_trace.cu",
                      "voidin_tpu/rt/traverse.py:616"),
        closest_hit=("voidin_tpu_torch/csrc/closest_hit.cu",
                     "voidin_tpu/rt/traverse.py:889"),
    )
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=path_launches[name], **rows[name])
        for name, (src, rep) in meta.items()
    ]
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, the "
          f"kernels' build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def golden_scene(pt):
    """tests/test_golden.py's deferred scene on the port's World."""
    from voidin_tpu_torch.core import mathx

    w = pt.World()
    w.lights.add_point_light([0, 2.5, 0], 14.0, [1.0, 0.95, 0.9])
    w.add_area_light(
        [1, 1, 1], 6.0, (4.0, 4.0),
        np.asarray(mathx.from_translation([0, 6, 2])
                   @ mathx.from_rotation_x(np.float32(-np.pi / 4))),
    )
    red = w.materials.add(albedo=w.textures.add(
        np.array([[[200, 60, 50, 255]]], np.uint8), srgb=True))
    grey = w.materials.add(albedo=w.textures.add(
        np.array([[[150, 150, 150, 255]]], np.uint8), srgb=True))
    for i in range(5):
        a = 2 * np.pi * i / 5
        t = mathx.from_translation(
            [2.2 * np.cos(a), 0.5, -6 + 2.2 * np.sin(a)])
        w.instances.add(np.asarray(t), 3, red if i % 2 else grey)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1, -6])
                   @ mathx.from_scale(30.0)), 0, grey)
    return w


VERTICAL_PLANE_MESH = 1  # a 1x1 quad in XY facing -Z, in both packages
GROUND_Y = -3.0  # the north-star field's ground plane (build_world)
NEAR_CARDS = 4


def foliage_textures(seed):
    """The four texture kinds of an alpha-tested foliage material: a 256^2
    RGBA cut-out albedo (a leaf lattice, round holes of alpha 0 in 32-texel
    cells: 34% of its texels cut), a 256^2 tangent-space normal map, a
    256^2 metallic-roughness map and a 64^2 emissive map, as uint8."""
    rng = np.random.default_rng(seed)
    n = 256
    yy, xx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5,
                         indexing="ij")
    hole = (yy % 32 - 16) ** 2 + (xx % 32 - 16) ** 2 < 10.5 ** 2
    vein = rng.integers(0, 48, (n, n))
    albedo = np.stack([40 + vein, 100 + vein + 40 * ((xx // 64) % 2),
                       30 + vein // 2, np.where(hole, 0, 255)], -1)
    nx = 0.4 * np.sin(2 * np.pi * xx / 32)
    ny = 0.4 * np.cos(2 * np.pi * yy / 64)
    nz = np.sqrt(1.0 - nx ** 2 - ny ** 2)
    normal = (np.stack([nx, ny, nz], -1) * 0.5 + 0.5) * 255 + 0.5
    mr = np.stack([60 + 160 * (yy / n), rng.integers(0, 255, (n, n)),
                   255 * ((xx // 16 + yy // 16) % 2), np.full((n, n), 255)],
                  -1)
    ey, ex = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    glow = ((ex // 8 + ey // 8) % 3 == 0)[..., None]
    emissive = np.where(glow, [[[70, 120, 30]]], [[[0, 0, 0]]])
    return dict(albedo=albedo.astype(np.uint8),
                normal=normal.astype(np.uint8), mr=mr.astype(np.uint8),
                emissive=emissive.astype(np.uint8))


def add_foliage(world, n_cards, seed):
    """Alpha-masked foliage over the north-star field, on either package's
    World: two materials with a cut-out albedo, a normal map, a
    metallic-roughness map and (the first) an emissive map, and `n_cards`
    vertical cards (scale 1-4, random yaw, standing on the ground) spread
    over the 400 x 400 field; the first NEAR_CARDS of them stand 6-16 m
    in front of the north-star camera. Cards face +Z (toward that camera)
    within +-60 degrees: the quad is one-sided. Returns the albedo's
    texture id."""
    rng = np.random.default_rng(seed)
    tex = foliage_textures(seed)
    albedo = world.textures.add(tex["albedo"], srgb=True)
    normal = world.textures.add(tex["normal"])
    mr = world.textures.add(tex["mr"])
    emissive = world.textures.add(tex["emissive"], srgb=True)
    leaf = world.materials.add(albedo=albedo, normal=normal,
                               metallic_roughness=mr, emissive=emissive)
    leaf_dark = world.materials.add(base_color=(0.6, 0.7, 0.6, 1.0),
                                    albedo=albedo, normal=normal,
                                    metallic_roughness=mr)
    for i in range(n_cards):
        if i < NEAR_CARDS:
            x, z = rng.uniform(-6, 6), 30.0 - rng.uniform(6, 16)
        else:
            x, z = rng.uniform(-200, 200), rng.uniform(-200, 200)
        s = rng.uniform(1.0, 4.0)
        yaw = np.pi + rng.uniform(-np.pi / 3, np.pi / 3)
        c, sn = np.cos(yaw) * s, np.sin(yaw) * s
        t = np.array([[c, 0, sn, x], [0, s, 0, GROUND_Y + s / 2],
                      [-sn, 0, c, z], [0, 0, 0, 1]], np.float32)
        world.instances.add(t, VERTICAL_PLANE_MESH,
                            leaf if i % 2 == 0 else leaf_dark)
    return albedo


def _mesh_module(pkg):
    """The scene.mesh module of either package (voidin_tpu_torch or the
    JAX package), for building the same scene on both."""
    import importlib

    return importlib.import_module(pkg.__name__ + ".scene.mesh")


# The camera of voidin_tpu/framework/presets.py:303 (config 5).
CONFIG5_CAMERA = dict(position=[0.0, 4.0, 3.0], pitch=-22.0)


def config5_world(pkg, skinned=False):
    """The raytraced-shadows scene of voidin_tpu/framework/presets.py:284-322
    (config 5) on `pkg`'s World: 40 instances of the 96x16 torus knot and
    the res-4 sphere on a ring, a 50x ground plane, one point light. The
    scene is its own. The preset's traversal choice (rt_packet 128 +
    rt_threaded) has no counterpart: the port's one kernel gives the hits
    that all of JAX's traversals give. `skinned` registers the knot as a
    skin of 2 joints (knot_skin)."""
    from voidin_tpu_torch.core import mathx

    mesh = _mesh_module(pkg)
    w = pkg.World()
    knot_mesh = mesh.make_torus_knot(segments=96, sides=16)
    knot = w.meshes.add(knot_mesh)
    if skinned:
        knot_skin(pkg, w, knot, knot_mesh)
    sphere = w.meshes.add(mesh.make_uv_sphere(1.0, 4))
    mat = w.materials.add()
    rng = np.random.default_rng(11)
    for i in range(40):
        a = 2 * np.pi * i / 40
        r = 3 + (i % 5)
        t = mathx.from_translation(
            [r * np.cos(a), 0.5 + (i % 3) * 1.2, -8 + r * np.sin(a)]
        ) @ mathx.from_scale(float(rng.uniform(0.5, 1.0)))
        w.instances.add(np.asarray(t), knot if i % 2 else sphere, mat)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1.0, -8])
                   @ mathx.from_scale(50.0)), 0, mat)
    w.lights.add_point_light([5, 9, 0], 35.0, [0.7, 0.68, 0.6])
    return w


def staircase_case(pkg, n=44):
    """(world, origins, directions) of a tree deeper than the closest-hit
    stack on `pkg`'s World: n res-10 spheres, sphere k at -2^(n - k) along
    axis k % 3, so at every level the TLAS builder splits the farthest
    sphere off as the left child, and a walk down the chain of right
    children (popped first) leaves one entry a level on the stack; the
    nearest sphere's BLAS adds its own depth. The three rays pass the
    origin's neighbourhood and need 55 entries (rt/traverse.py STACK is
    48): their pushes overflow."""
    from voidin_tpu_torch.core import mathx

    mesh = _mesh_module(pkg)
    w = pkg.World()
    for k in range(n):
        v = [0.0, 0.0, 0.0]
        v[k % 3] = -float(2.0 ** (n - k))
        w.instances.add(np.asarray(mathx.from_translation(v)),
                        mesh.SPHERE_10_MESH, 0)
    o = np.array([[-2.0, 5.0, 0.1], [0.1, 5.0, 0.1], [-1.9, -5.0, 0.2]],
                 np.float32)
    d = np.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
                 np.float32)
    return w, o, d


def knot_skin(pkg, world, knot, knot_mesh):
    """Registers mesh `knot` of `world` (`pkg`'s) as a skin of 2 joints
    with weights by height, as tests/test_skin.py _strip_mesh binds its
    strip: the lowest vertices to joint 0, the highest to joint 1, a
    linear blend between. Returns the skin's joint offset."""
    import importlib

    skin = importlib.import_module(pkg.__name__ + ".scene.skin")
    y = np.asarray(knot_mesh.vertices)[:, 1]
    s = ((y - y.min()) / (y.max() - y.min())).astype(np.float32)
    joints = np.zeros((len(y), 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((len(y), 4), np.float32)
    weights[:, 0], weights[:, 1] = 1.0 - s, s
    info = world.meshes.mesh_info[knot]
    off = world.allocate_joints(2)
    world.skins.append(skin.build_skin_data(
        knot_mesh, world.meshes.indices[knot], joints, weights,
        base_tri=info["base_index"] // 3, mesh_id=knot, joint_offset=off,
        n_joints=2, nodes=world.meshes.bvh_nodes[knot],
        bvh_base=info["bvh_index"]))
    return off


def knot_joint_mats(frame):
    """(2, 4, 4) f32 joint matrices of the skinned knot at `frame`: joint 0
    at rest, joint 1 bent about z around the knot's centre by an angle
    that changes every frame."""
    from voidin_tpu_torch.core import mathx

    rot = mathx.from_rotation_z(np.float32(0.8 * np.sin(0.9 * frame + 0.4)))
    return np.stack([np.eye(4, dtype=np.float32),
                     np.asarray(rot, np.float32)])


SHADOW_EDGE_CASES = ("box", "single", "max_leaf", "empty")


def _octahedron(mesh):
    """A unit octahedron: 6 vertices, 8 triangles (MAX_LEAF), outward
    winding."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1]], np.float32)
    idx = []
    for x in (0, 1):
        for y in (2, 3):
            for z in (4, 5):
                tri = [x, y, z]
                n = np.cross(v[y] - v[x], v[z] - v[x])
                if n @ (v[x] + v[y] + v[z]) < 0:
                    tri = [x, z, y]
                idx += tri
    return mesh.Mesh(v, v.copy(), np.tile([[1, 0, 0, -1]], (6, 1)),
                     np.zeros((6, 2)), np.array(idx, np.int32))


def shadow_edge_case(pkg, kind, seed=0):
    """(world, origins (R, 3), directions (R, 3), active (R,)) of one
    adversarial shadow-ray set on `pkg`'s World, rays as float32 numpy.

    "box": a cube of half-extent 1 at the origin, a translated one, a
    scaled one, a sphere and a ground plane; rays lying in the cube's face
    planes (a direction component exactly 0), rays at the world cube
    corners, edge midpoints (shared by two triangles) and face centres
    (the diagonal shared edge) with t = 1 landing exactly on the corner
    (t_max, no hit), t = 0.5 and t = 2, direction components of 0 and
    +-1e-21, an all-zero direction, random rays; a quarter of the rays
    inactive. "single": one torus-knot instance (the TLAS root is a
    leaf), random rays. "max_leaf": a pool built without BVH, no builtin
    meshes, whose leaves hold all of a mesh's triangles: octahedra of 8
    (MAX_LEAF) and a quad of 2, rays at their corners and random.
    "empty": the box scene and no rays."""
    from voidin_tpu_torch.core import mathx

    rng = np.random.default_rng([seed, zlib.crc32(kind.encode())])
    mesh = _mesh_module(pkg)
    w = pkg.World()
    o, d = [], []

    def at_points(points, n_dirs=4):
        for p in points:
            for _ in range(n_dirs):
                off = rng.integers(-8, 9, 3) / 4.0
                off[1] = abs(off[1]) + 0.5
                for f in (1.0, 2.0, 0.5):
                    o.append(p + off)
                    d.append(-off * f)

    def random_rays(n, lo=-4.0, hi=4.0):
        o.extend(rng.uniform(lo, hi, (n, 3)))
        d.extend(rng.uniform(-6.0, 6.0, (n, 3)))

    if kind in ("box", "empty"):
        cube = w.meshes.add(mesh.make_cube_mesh(2.0))
        w.instances.add(np.eye(4, dtype=np.float32), cube, 0)
        w.instances.add(np.asarray(mathx.from_translation([3.0, 0, 0])),
                        cube, 0)
        w.instances.add(np.asarray(mathx.from_translation([0, 3.0, 0])
                                   @ mathx.from_scale(0.5)), cube, 0)
        w.instances.add(np.asarray(mathx.from_translation([-3.0, 0, 0])),
                        mesh.SPHERE_1_MESH, 0)
        w.instances.add(np.asarray(mathx.from_translation([0, -2.0, 0])
                                   @ mathx.from_scale(8.0)),
                        mesh.HORIZONTAL_PLANE_MESH, 0)
        if kind == "empty":
            z = np.zeros((0, 3), np.float32)
            return w, z, z, np.zeros(0, bool)
        g = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0])
        for a in g:
            for b in g:
                for face in (1.0, -1.0):
                    for dv in ([0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                               [0, 1, 1], [0, -2, 1]):
                        o.append([face, a, b])
                        d.append(np.array(dv) * 3.0)
                        o.append([a, b, face])
                        d.append(np.array(dv)[[1, 2, 0]] * 3.0)
        corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                            for z in (-1, 1)], np.float64)
        mids = np.array([[x, y, 0] for x in (-1, 1) for y in (-1, 1)]
                        + [[x, 0, z] for x in (-1, 1) for z in (-1, 1)]
                        + [[0, y, z] for y in (-1, 1) for z in (-1, 1)],
                        np.float64)
        centres = np.concatenate([np.eye(3), -np.eye(3)])
        pts = np.concatenate([corners, mids, centres])
        at_points(np.concatenate([pts, pts + [3.0, 0, 0]]))
        for tiny in (0.0, 1e-21, -1e-21):
            for x in (-3.0, -1.0, 0.0, 0.5, 1.0, 3.0):
                for z in (-1.0, 0.0, 1.0):
                    o.append([x, 5.0, z])
                    d.append([tiny, -8.0, -tiny])
                    o.append([x, 0.5, -5.0])
                    d.append([tiny, 0.0, 9.0])
        o.append([0.5, 0.5, 0.5])
        d.append([0.0, 0.0, 0.0])
        random_rays(600)
    elif kind == "single":
        knot = w.meshes.add(mesh.make_torus_knot(segments=24, sides=6))
        w.instances.add(np.eye(4, dtype=np.float32), knot, 0)
        random_rays(800, -3.0, 3.0)
    elif kind == "max_leaf":
        w.meshes = mesh.MeshPool(with_builtins=False, build_bvh=False)
        octa = w.meshes.add(_octahedron(mesh))
        quad = w.meshes.add(mesh.make_plane_mesh(4.0, 4.0))
        for x in (-2.5, 0.0, 2.5):
            w.instances.add(np.asarray(mathx.from_translation([x, 0, 0])),
                            octa, 0)
        w.instances.add(np.asarray(mathx.from_translation([0, -1.5, 0])),
                        quad, 0)
        pts = np.array([[x + dx, dy, dz] for x in (-2.5, 0.0, 2.5)
                        for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                                           (0.5, 0.5, 0), (0, 0.5, 0.5))])
        at_points(pts, 2)
        random_rays(600)
    else:
        raise ValueError(kind)
    origins = np.asarray(o, np.float32)
    dirs = np.asarray(d, np.float32)
    active = rng.uniform(size=len(origins)) >= 0.25
    return w, origins, dirs, active


if __name__ == "__main__":
    main()
