"""Chip smoke test of the PyTorch + CUDA port (voidin_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a) and, at the
first scene, the host's native library (native/bvh_builder.cpp and
native/texture_packer.cpp, the host C++ compiler), then:
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
     exhausted); then config 5 (config5_preset, 1920x1080, TLAS, no TAA),
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
     timed, with the walk's profile (closest_walk_profile); every set
     again at max_steps 1, 2, 3, 8 and 2048, the rays in order and in
     pixel tiles (closest_paths_check); the example module at its own
     size (512x288);
 12. the skinned frame (skin_phases): config 5 with its knot a 2-joint
     skin (weights by height) bent by a new pose each frame, raytraced
     shadows, 12 frames at 1920x1080 (overflow 0, rt_exhausted 0, K1 and
     the shadow kernel once a frame), the last pose's refit BLAS and TLAS
     valid and tight on the card, and the scene at 320x184 on the card
     against the CPU twins (mean 5e-3);
 13. the ring light (ring_phases): the golden ring_light scene at 160x96
     on the card against tests/golden/ring_light.png and the CPU twins
     (mean 5e-3), 12 frames of it at 1920x1080 (K1 and the fused LTC ring
     kernel once a frame, K3 and the fused rect kernel never), the fused
     ring kernel and its bf16 variant against their twin on that frame's
     own fields (differing words and max abs diff printed, within 1e-5 of
     the largest term), timed beside its bound (ltc_ring_bound), and one
     bf16 ring frame (mean within RING_BF16_MEAN of the f32 frame);
 14. the BASELINE presets (preset_phases): configs 1, 2 (1,000 instances,
     a 3-level LOD chain), 3, 4 (skinned clapping arms, TAA, moving
     instances), 6 (104 textures, 32 knots) and 7 (detail 1.0) of
     voidin_tpu_torch/framework/presets.py at 1920x1080, wired as
     bench.py:458-501 wires them (the preset's capacities, flags and
     moving instances; config 4 posed by clapper_joint_mats at the
     Renderer's time), 12 frames each: overflow 0, K1 base once a frame,
     the fused LTC kernel once a frame on the presets with area lights
     (3, 4, 6, 7) and never on 1 and 2, every other kernel never; on
     config 4 the last pose's refit BLAS of both arms valid and tight and
     frames 0 and 6 different; before each run, K1 base and the fused LTC
     kernel held against their twins (every word equal) on the inputs
     the preset's first frame hands them, with K1's fullest tile printed
     (hold_path_kernels); each preset's host build times, sizes and draws
     printed. Config 5 is phases 10-12's scene, the preset itself
     (config5_preset);
 15. scene import and snapshots (import_phases): write_import_scene's
     glTF (.glb: a textured box with an embedded palette PNG instanced
     under a translated parent, a 2-joint skinned strip with a rotation
     animation, a floor without indices) and OBJ (.obj + .mtl) files
     imported through the port, 12 frames at 1920x1080 posed by
     GltfAnimator (overflow 0, K1 and the fused LTC kernel once a frame;
     both held against their twins on the first frame's inputs first),
     the scene (.gltf with data URIs) at 320x184 on the card against the
     CPU twins (mean 5e-3); config 7 saved with save_scene, loaded onto
     the card with load_scene and rendered once against a frame of the
     scene it was saved from (mean <= 1e-6; max abs diff and word
     equality printed);
 16. the app layer (app_phases): examples/model.py through App at its
     1280x1024 (K1 base and the fused LTC kernel held against their
     twins on the App's first frame, every word equal), 12 App.step frames
     (overflow 0, K1 base and the fused LTC kernel once a frame, every
     other kernel never), 12 Renderer.render frames alone on the same
     camera path, 12 App.step frames again; App.resize(1920, 1080)
     (Example.resize called, peak memory printed) and the same three runs
     at full width; App.run(12, record_path=<tmp>/clip.mp4, hud=True), its
     route printed (ffmpeg or the MJPEG-AVI), the AVI read back
     (avi_frames: RIFF / hdrl / movi / idx1, 12 '00dc' chunks) and every
     frame decoded by io/jpeg.py within mean abs 0.01 of the frame the
     recorder was handed; profile_frame on the north star at 1920x1080
     (every row > 0, the fine raster row beside K1's device ms); run_web
     on 127.0.0.1 at a free port (a 1080p PNG decoded, the stats, a held
     key moves the camera).
 17. the row-sharded frame, debug_bounds and area_light_scale
     (shard_phases): the north star at 1920x1088 (136 tile rows; 1080
     rows split into no whole slabs; pair capacity 2^21, where each slab
     bins at the JAX package's local_pair_capacity, 1/N of it), 12 TAA
     frames unsharded, then on meshes naming the card 2 and 4 times (and
     on 2 and 4 cards where that many are visible): every frame word for
     word the unsharded one, overflow 0, K1 and the fused LTC kernel once
     per slab and frame, each slab's launches of one more frame equal to
     their twins on the slab's own inputs (per-slab K1 device ms
     printed); config 5
     raytraced on 2 slabs, word for word; debug_bounds (a checked frame
     equal to the unchecked one, a corrupted tri_id raising resolve.rec,
     a corrupted TLAS child raising rt. with no shadow launch, the card
     usable after); area_light_scale=2 (the fused kernel on the
     (544, 960) fields equal to its twin, the frame within
     tests/test_ltc.py's budgets of full resolution, 12 frames timed).
 18. the host path of texture upload and image import (host_phases): the
     native texture packer in use (it fails on the numpy fallback);
     configs 6 and 7 at phase 14's sizes packed by each packer (host ms
     of TexturePool.host_arrays and of World.device(), the words where
     the two pools differ,
     held to tests/test_io.py:154-165's gate); every image fixture of
     tests/data/torch_images (progressive, CMYK, YCCK, 4:1:1 and 4:4:0,
     lossless, arithmetic-coded and block-smoothed JPEGs, Adam7 and
     16-bit PNGs; WebP lossy, lossless, with alpha and animated, the
     512x512 lossy WebP; GIF, BMP and baseline TIFF) decoded to its stored
     PIL pixels (lossy JPEG within 1 level, every other file word for
     word), with its host ms and ms per megapixel, the
     512x512 progressive files (Huffman and arithmetic) split by scan
     kind; a 512x512 RGB lossless file at predictors 1 and 7 decoded to
     its source samples word for word, timed. No kernel runs in it.
 19. the import scene of phase 15 with its embedded image a lossless, an
     arithmetic-coded progressive and a block-smoothed progressive JPEG
     fixture and an opaque lossy WebP taken through EXT_texture_webp
     (image_import_phases): each decoded within its bound of PIL's
     stored pixels (lossless word for word) and found in the imported
     texture pool, K1 base and the fused LTC kernel held against their
     twins on its first frame's inputs, then 12 frames at 1920x1080
     (overflow 0, both kernels once a frame).
Phases 5-8, 10-17 and 19 print the median ms/frame of frames 3-12 (CUDA
events) and the peak device memory of the 12 frames. Every path run sets
the launch counts to 0 just before it and checks them just after. Prints
the kernel table as one JSON line (each row also with device_ms, K3's with
its 1-table shape under one_table, the fused ring kernel's with the ring
frame's ms/frame and differing words,
the shadow kernel's with its scale-2 rays under scale2, the closest-hit
kernel's with config 5's rays under config5, K1's and the fused LTC
kernel's with each preset's, the import scenes' and the App's inputs
under paths, the fused kernel's also on area_light_scale 2's; their launches
count phase 16's App frames and phases 17's and 19's runs too),
then the card line, then the
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
RING_REL_TOL = 1e-5  # tests/test_torch_ring_light.py REL_TOL
# The bf16 ring frame's mean sRGB distance to the f32 frame: a sanity bound
# on the bf16 path (a wrong table or weight moves it by ~1e-1). The ring
# exceeds tests/test_ltc.py's golden-scene budgets (mean 2e-4, max 1e-2):
# its bf16 frame measured mean 2.86e-4, max 3.02e-2 at 1080p on an H100
# and 2.67e-4, 6.19e-3 at 320x184 on the CPU.
RING_BF16_MEAN = 1e-3
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
    from voidin_tpu_torch.ops import ltc_ring as lg
    from voidin_tpu_torch.ops import lut_fetch as lf
    from voidin_tpu_torch.ops import shadow_trace as st

    return dict(k1=(fr, "LAUNCHES"), k1_track2=(fr, "LAUNCHES_TRACK2"),
                k1_payload=(fr, "LAUNCHES_PAYLOAD"),
                k2=(fr, "LAUNCHES_BLOCKS"),
                k2_track2=(fr, "LAUNCHES_BLOCKS_TRACK2"),
                k3=(lf, "LAUNCHES"), k3_bf16=(lf, "LAUNCHES_BF16"),
                ltc_rect=(lr, "LAUNCHES"),
                ltc_rect_bf16=(lr, "LAUNCHES_BF16"),
                ltc_ring=(lg, "LAUNCHES"),
                ltc_ring_bf16=(lg, "LAUNCHES_BF16"),
                shadow_trace=(st, "LAUNCHES"),
                shadow_pack=(st, "LAUNCHES_PACK"),
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


def run_frames(renderer, cam, label, joint_mats=None, keep=None,
               shape=(HEIGHT, WIDTH, 3)):
    """FRAMES frames through Renderer.render, each timed with CUDA events
    and checked: overflow 0, something visible; `joint_mats(i)` poses
    frame i's skins; the images of the frames `keep` names go into it
    (frame -> host image); the last image must have `shape`. Returns (last
    image, per-frame ms, the peak device memory over the frames and the
    part of it above what was resident before, as text)."""
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
        if keep is not None and i in keep:
            keep[i] = img.cpu().numpy()
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
    if out.shape != shape or not np.isfinite(out).all():
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


def kernel_calls(render):
    """The arguments of every call of K1 base (fine_raster_pairs) and of
    the fused LTC kernel (ltc_rect_terms) while `render()` draws one
    frame: {counter name: [(args, kwargs), ...]}, a kernel that the frame
    did not call left out."""
    from voidin_tpu_torch.ops import fine_raster as fr
    from voidin_tpu_torch.ops import ltc_rect as lr

    wrapped = dict(k1=(fr, "fine_raster_pairs"),
                   ltc_rect=(lr, "ltc_rect_terms"))
    reals = {k: getattr(m, a) for k, (m, a) in wrapped.items()}
    seen = {}

    def keeper(key):
        def call(*args, **kwargs):
            seen.setdefault(key, []).append((args, kwargs))
            return reals[key](*args, **kwargs)
        return call

    for k, (m, a) in wrapped.items():
        setattr(m, a, keeper(k))
    try:
        render()
    finally:
        for k, (m, a) in wrapped.items():
            setattr(m, a, reals[k])
    return seen


def main_path_inputs(render):
    """The arguments of the first call of K1 base and of the fused LTC
    kernel while `render()` draws one frame (kernel_calls): {counter
    name: (args, kwargs)}."""
    return {k: calls[0] for k, calls in kernel_calls(render).items()}


def hold_k1_call(label, args, kw, card):
    """One recorded launch of K1 base (its arguments `args`, `kw`) against
    its twin: every output word equal, timed as kernel_phases times K1.
    Prints its records and fullest tile; returns its row."""
    import torch

    from voidin_tpu_torch.ops import fine_raster as fr

    counts = args[2]
    got = fr.fine_raster_pairs(*args, **kw)
    ref = fr.fine_raster_pairs_reference(*args, **kw)
    torch.cuda.synchronize()
    differ = [words_differ(a, b) for a, b in zip(got, ref)]
    r = timed_row(
        lambda: fr.fine_raster_pairs(*args, **kw),
        "fine_raster_pairs_kernel", 10,
        lambda: fr.fine_raster_pairs_reference(*args, **kw), 1,
        k1_bound(counts, 2), float((got[0] - ref[0]).abs().max()))
    r.update(records=int(counts.sum()), max_records=int(counts.max()),
             differing_words=sum(differ))
    print(f"{label}, K1 on its own records ({kw or 'base'}): "
          f"{r['records']} records over {counts.numel()} tiles, the "
          f"fullest tile {r['max_records']}; per-tile counts "
          f"{count_histogram(counts)}; differing words (depth, id) "
          f"{differ}; {timing(r)} ({card})", flush=True)
    if any(differ):
        fail(f"{label}: K1 disagrees with its twin on its own records")
    return r


def hold_ltc_call(label, args, kw, card):
    """One recorded launch of the fused LTC kernel against its twin:
    every output word equal, timed as ltc_rect_phases times it; returns
    its row."""
    import torch

    from voidin_tpu_torch.ops import ltc_rect as lr

    got = lr.ltc_rect_terms(*args, **kw)
    ref = lr.ltc_rect_terms_reference(*args, **kw)
    torch.cuda.synchronize()
    differ = [words_differ(a, b) for a, b in zip(got, ref)]
    n_px, n_lights = args[3].numel(), args[4].shape[0]
    r = timed_row(
        lambda: lr.ltc_rect_terms(*args, **kw), "ltc_rect", 10,
        lambda: lr.ltc_rect_terms_reference(*args, **kw), 1,
        ltc_rect_bound(n_px, n_lights),
        max(float((a - b).abs().max()) for a, b in zip(got, ref)))
    r.update(lights=n_lights, differing_words=sum(differ))
    print(f"{label}, fused LTC on its own {tuple(args[3].shape)} shade "
          f"fields ({n_lights} lights, {kw}): differing words (diff, spec) "
          f"{differ}; max abs diff {r['max_abs_err']}; {timing(r)} "
          f"({card})", flush=True)
    if any(differ):
        fail(f"{label}: the fused LTC kernel disagrees with its twin on "
             f"its own shade fields")
    return r


def hold_path_kernels(label, render, want, card):
    """K1 base and the fused LTC kernel against their twins on the inputs
    that one frame of `render()` hands them (main_path_inputs): every
    output word equal, as kernel_phases and ltc_rect_phases hold them on
    the north-star frame; `want` names the counters of the kernels that
    the frame must call. Returns {kernel row name: its row on this
    path}."""
    seen = main_path_inputs(render)
    if set(seen) != set(want):
        fail(f"{label}: the frame called {sorted(seen)}, expected "
             f"{sorted(want)}")
    rows = {}
    if "k1" in seen:
        rows["fine_raster_pairs"] = hold_k1_call(label, *seen["k1"], card)
    if "ltc_rect" in seen:
        rows["ltc_rect"] = hold_ltc_call(label, *seen["ltc_rect"], card)
    return rows


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


def frame_shadow_rays(pt, scene, cfg, cam, scale, joint_mats=None):
    """The shadow-ray kernel's arguments as shade_raytraced hands them over
    in one frame of `scene` at `cam` (TAA off; a skinned scene posed by
    `joint_mats`): (args, kwargs)."""
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
                 rt_shadow_scale=scale).render(cam, joint_mats=joint_mats)
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


TAIL_RAYS = 1024  # the longest walks that shadow_walk_profile times alone


def shadow_walk_profile(args, kwargs, label, card):
    """What sets the shadow kernel's time on one ray set: the node visits a
    ray (the twin's walk: max, 99.9th percentile, mean over the active
    rays), the kernel's device time on every active ray, on the TAIL_RAYS
    rays with the most visits alone, on the one with the most alone and on
    no active ray (the launch over every lane), and the kernel's registers
    and resident blocks. Returns
    the numbers as a dict."""
    import torch

    from voidin_tpu_torch.ops import shadow_trace as st
    from voidin_tpu_torch.rt import traverse

    n = args[4].shape[0]
    dev = args[4].device
    act = kwargs.get("active")
    if act is None:
        act = torch.ones(n, dtype=torch.bool, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    traverse.occluded_reference(*args, **kwargs, visits_out=visits)
    v = visits[act].double()
    top = torch.topk(torch.where(act, visits, -1), min(TAIL_RAYS, n)).indices
    tail = torch.zeros(n, dtype=torch.bool, device=dev)
    tail[top] = True
    tail &= act
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    longest = torch.zeros(n, dtype=torch.bool, device=dev)
    longest[top[0]] = True
    ms = {}
    for what, mask in (("all", act), ("tail", tail), ("none", none),
                       ("longest", longest)):
        kw = dict(kwargs, active=mask)
        ms[what] = device_ms(lambda: st.occluded(*args, **kw), 20,
                             "shadow_trace")
    out = dict(visits_max=int(v.max()),
               visits_p999=float(torch.quantile(v.float().cpu(), 0.999)),
               visits_mean=float(v.mean()),
               tail_visits_min=int(visits[top].min()),
               device_ms_all=ms["all"], device_ms_tail=ms["tail"],
               device_ms_none=ms["none"], device_ms_longest=ms["longest"],
               **st.kernel_attributes(args[1], args[2].shape[0]))
    print(f"shadow_trace walk profile ({label}): node visits a ray max "
          f"{out['visits_max']}, 99.9th percentile {out['visits_p999']:.1f}, "
          f"mean {out['visits_mean']:.2f}; device ms on every active ray "
          f"{fmt_ms(ms['all'])}, on the {TAIL_RAYS} longest walks alone "
          f"(>= {out['tail_visits_min']} visits) {fmt_ms(ms['tail'])}, on "
          f"no active ray {fmt_ms(ms['none'])}, on the longest walk alone "
          f"{fmt_ms(ms['longest'])}; registers "
          f"{out['registers']}, local {out['local_bytes']} B, "
          f"{out['blocks_per_sm']} blocks of {out['threads']} an SM, shared "
          f"{out['shared_bytes']} B ({card})", flush=True)
    return out


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
    p = config5_preset(pt)
    world = p.world
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
    scene = world.device(dev, with_tlas=p.with_tlas)
    cam = p.camera
    out_rows, launches, frame_ms = {}, None, {}
    for scale in (1, 2):
        label = f"config 5 scale {scale}"
        r = preset_renderer(dataclasses.replace(p, rt_shadow_scale=scale),
                            scene, WIDTH, HEIGHT)
        cfg = r.config
        reset_launches()
        out, times, mem = run_frames(r, cam, label)
        got = expect_launches(label, dict(k1=FRAMES, shadow_trace=FRAMES,
                                          shadow_pack=FRAMES))
        if scale == 1:
            launches = got
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
        row.update(walk=shadow_walk_profile(args, kwargs,
                                            f"config 5, scale {scale}", card))
        row.update(lanes=n_lanes, rays=n_rays, hits=int(got.hit.sum()),
                   node_visits=counts.node_visits,
                   instance_entries=counts.instance_entries,
                   triangle_tests=counts.triangle_tests,
                   frame_ms=frame_ms[scale])
        out_rows[scale] = row
        if scale == 1:
            pack_row = shadow_pack_check(args, card)
        print(f"shadow_trace (config 5, scale {scale}): {n_rays} active rays "
              f"of {n_lanes} lanes, hits "
              f"{row['hits']}, differing hits {differ}, exhausted kernel "
              f"{int(got.exhausted)} twin {int(want.exhausted)}; {counts}; "
              f"{timing(row)}; launches a frame 1 ({card})", flush=True)
        if differ or int(got.exhausted) or int(want.exhausted):
            fail(f"shadow_trace disagrees with its twin on the config-5 "
                 f"rays at scale {scale}")
        if scale == 2:
            shadow_step_limits(args, kwargs, card)
    row = dict(out_rows[1], scale2=out_rows[2])
    return row, pack_row, launches


def shadow_pack_check(args, card):
    """The packing kernel (ops/shadow_trace.py pack_rows) against its twin,
    rt/traverse.py pack_shadow_rows, on one frame's tables: every word of
    the four outputs, timed as kernel_phases times the others; it moves
    each input and output byte once."""
    import torch

    from voidin_tpu_torch.ops import shadow_trace as st
    from voidin_tpu_torch.rt import traverse

    tables = args[:4]
    got = st.pack_rows(*tables)
    want = traverse.pack_shadow_rows(*tables)
    torch.cuda.synchronize()
    differ = sum(words_differ(getattr(got, f), getattr(want, f))
                 for f in ("top", "blas", "tris"))
    n_bytes = 4 * sum(t.numel() for t in (*tables[:1], *tables[2:],
                                          want.top, want.blas, want.tris))
    row = timed_row(lambda: st.pack_rows(*tables), "pack_shadow_rows", 50,
                    lambda: traverse.pack_shadow_rows(*tables), 50,
                    bound_ms(n_bytes, 6 * tables[3].shape[0]),
                    float(differ > 0))
    print(f"pack_shadow_rows (config 5 tables: {tables[1]} TLAS, "
          f"{want.blas.shape[0]} BLAS, {want.tris.shape[0]} triangle rows): "
          f"{differ} words differ from the twin; {timing(row)} ({card})",
          flush=True)
    if differ:
        fail("pack_shadow_rows disagrees with its twin")
    return row


STEP_LIMITS = (1, 8, 32)


def shadow_step_limits(args, kwargs, card):
    """The kernel against its twin on one ray set cut at small step limits:
    the same hits and the same count of rays still walking."""
    for steps in STEP_LIMITS:
        kw = dict(kwargs, max_steps=steps)
        got, want, _, differ = shadow_trace_check(args, kw)
        print(f"shadow_trace at max_steps {steps}: differing hits {differ}, "
              f"exhausted kernel {int(got.exhausted)} twin "
              f"{int(want.exhausted)}, dropped pushes kernel "
              f"{int(got.overflow)} twin {int(want.overflow)} ({card})",
              flush=True)
        if differ or int(got.exhausted) != int(want.exhausted) \
                or int(got.overflow) or int(want.overflow):
            fail(f"shadow_trace disagrees with its twin at max_steps {steps}")


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


def twin_kwargs(kwargs):
    """closest_hit's keyword arguments without the kernel's `width`."""
    return {k: v for k, v in kwargs.items() if k != "width"}


def closest_hit_check(args, kwargs):
    """The closest-hit kernel against its twin on one ray set (the twin
    takes `kwargs` but the kernel's `width`): (kernel result, twin result,
    twin walk counts, {output: differing words or count difference})."""
    import torch

    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.rt import traverse

    got = ch.closest_hit(*args, **kwargs)
    want, counts = traverse.closest_hit_reference(*args, **twin_kwargs(
        kwargs))
    torch.cuda.synchronize()
    return got, want, counts, dict(
        t=words_differ(got.t, want.t),
        visits=int((got.visits != want.visits).sum()),
        overflow=abs(int(got.overflow) - int(want.overflow)),
        exhausted=abs(int(got.exhausted) - int(want.exhausted)))


CLOSEST_STEP_LIMITS = (1, 2, 3, 8, 2048)
# rows of the edge sets' rays for the kernel's tile order: ragged tiles
EDGE_WIDTH = 37


def closest_paths_check(args, kwargs, width, label, card, twins=None):
    """The closest-hit kernel with both of its thread orders, the rays in
    order and in pixel tiles of rows of `width` (ops/closest_hit.py
    closest_hit's width), against its twin at each of CLOSEST_STEP_LIMITS:
    every t word, visit count and counter equal. `twins` may hold the
    twin's result at some limits already. Prints one line; fails on a
    difference."""
    import torch

    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.rt import traverse

    twins = dict(twins or {})
    parts = []
    for steps in CLOSEST_STEP_LIMITS:
        kw = dict(kwargs, max_steps=steps)
        if steps not in twins:
            twins[steps] = traverse.closest_hit_reference(*args, **kw)[0]
        want = twins[steps]
        for order, w in (("in order", None), ("in tiles", width)):
            got = ch.closest_hit(*args, **kw, width=w)
            torch.cuda.synchronize()
            differ = dict(
                t=words_differ(got.t, want.t),
                visits=int((got.visits != want.visits).sum()),
                overflow=int(got.overflow) - int(want.overflow),
                exhausted=int(got.exhausted) - int(want.exhausted))
            if any(differ.values()):
                fail(f"closest_hit (rays {order}) disagrees with its twin on "
                     f"{label} at max_steps {steps}: {differ}")
        parts.append(f"{steps}: overflow {int(want.overflow)} exhausted "
                     f"{int(want.exhausted)}")
    print(f"closest_hit step limits ({label}), rays in order and in tiles "
          f"of rows of {width}, equal to the twin: {'; '.join(parts)} "
          f"({card})", flush=True)


def closest_walk_profile(args, kwargs, visits, counts, label, card):
    """What sets the closest-hit kernel's time on one ray set: the pops a
    ray (`visits`, the kernel's, equal to the twin's: max, 99.9th
    percentile, mean), the share of pops whose box the ray misses (the
    twin's `counts`), the kernel's device time on every ray, on the
    TAIL_RAYS rays with the most pops alone, on the one with the most alone
    and on no active ray (the launch over every lane), and the kernel's
    registers and resident blocks. Returns the numbers as a dict."""
    import torch

    from voidin_tpu_torch.ops import closest_hit as ch

    n = visits.shape[0]
    dev = visits.device
    v = visits.double()
    top = torch.topk(visits, min(TAIL_RAYS, n)).indices
    masks = dict(tail=torch.zeros(n, dtype=torch.bool, device=dev),
                 none=torch.zeros(n, dtype=torch.bool, device=dev),
                 longest=torch.zeros(n, dtype=torch.bool, device=dev))
    masks["tail"][top] = True
    masks["longest"][top[0]] = True
    ms = dict(all=device_ms(lambda: ch.closest_hit(*args, **kwargs), 20,
                            "closest_hit"))
    for what, mask in masks.items():
        kw = dict(kwargs, active=mask)
        ms[what] = device_ms(lambda: ch.closest_hit(*args, **kw), 20,
                             "closest_hit")
    out = dict(pops_max=int(v.max()),
               pops_p999=float(torch.quantile(v.float().cpu(), 0.999)),
               pops_mean=float(v.mean()),
               missed_share=counts.missed_pops / max(counts.node_visits, 1),
               tail_pops_min=int(visits[top].min()),
               device_ms_all=ms["all"], device_ms_tail=ms["tail"],
               device_ms_none=ms["none"], device_ms_longest=ms["longest"],
               **ch.kernel_attributes())
    print(f"closest_hit walk profile ({label}): pops a ray max "
          f"{out['pops_max']}, 99.9th percentile {out['pops_p999']:.1f}, "
          f"mean {out['pops_mean']:.2f}; pops that miss their box "
          f"{counts.missed_pops} of {counts.node_visits} "
          f"({100 * out['missed_share']:.1f}%); device ms on every ray "
          f"{fmt_ms(ms['all'])}, on the {TAIL_RAYS} longest walks alone "
          f"(>= {out['tail_pops_min']} pops) {fmt_ms(ms['tail'])}, on the "
          f"longest walk alone {fmt_ms(ms['longest'])}, on no active ray "
          f"{fmt_ms(ms['none'])}; registers {out['registers']}, local "
          f"{out['local_bytes']} B, {out['blocks_per_sm']} blocks of "
          f"{out['threads']} an SM, shared {out['shared_bytes']} B ({card})",
          flush=True)
    return out


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
        closest_paths_check(args, kwargs, EDGE_WIDTH, f"edge set {kind}",
                            card, {2048: want})
    world, o, d = staircase_case(pt)
    args = traverse.scene_rays(world.device(dev, with_tlas=True)) + tuple(
        torch.from_numpy(a).to(dev) for a in (o, d))
    got, want, counts, differ = closest_hit_check(args, {})
    print(f"closest_hit on a tree deeper than its stack: overflow kernel "
          f"{int(got.overflow)} twin {int(want.overflow)}, differing "
          f"{differ} ({card})", flush=True)
    if any(differ.values()) or not int(got.overflow) > 0:
        fail("closest_hit disagrees with its twin where the stack overflows")
    closest_paths_check(args, {}, 1, "the staircase", card, {2048: want})

    rows, launches = {}, None
    c5 = config5_preset(pt)
    for label, world, camera in (
            ("bvh_trace scene", bvh_trace.trace_world(), None),
            ("config 5", c5.world, dict(position=c5.camera.position,
                                        yaw=c5.camera.yaw,
                                        pitch=c5.camera.pitch))):
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
        kwargs = dict(t_max=bvh_trace.T_MAX, width=WIDTH)
        got, want, counts, differ = closest_hit_check(args, kwargs)
        path_differ = words_differ(res.t.reshape(-1), got.t)
        row = timed_row(lambda: ch.closest_hit(*args, **kwargs),
                        "closest_hit_kernel", 20,
                        lambda: traverse.closest_hit_reference(
                            *args, **twin_kwargs(kwargs)), 1,
                        closest_bound(len(o), counts, *args[:4]),
                        float((got.t - want.t).abs().max()))
        hits = int((got.t < bvh_trace.T_MAX).sum())
        row.update(rays=len(o), hits=hits, node_visits=counts.node_visits,
                   instance_entries=counts.instance_entries,
                   triangle_tests=counts.triangle_tests,
                   missed_pops=counts.missed_pops,
                   max_visits=int(got.visits.max()),
                   instances=int(scene.instances.count),
                   tlas_nodes=int(scene.tlas.tlas_min.shape[0]))
        row.update(walk=closest_walk_profile(args, kwargs, got.visits,
                                             counts, label, card))
        closest_paths_check(args, twin_kwargs(kwargs), WIDTH, label, card,
                            {2048: want})
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
    """Checks the refit BLAS of the skin of mesh `knot` and the refit TLAS
    (device tensors; None for a scene without one) on the host: every
    reachable node contains its triangles or children (TLAS leaves their
    instance's world AABB from the refit mesh bounds), and each root
    equals the bounds of what it holds within 1e-4. Returns the count of
    violations of each kind."""
    from voidin_tpu_torch.rt import bvh as bvh_mod

    nodes = world.meshes.bvh_nodes[knot]
    skin = next(s for s in world.skins if s.mesh_id == knot)
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
    if tlas is None:
        return bad
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
    (config5_preset(skinned=True)) bent by knot_joint_mats, raytraced
    shadows, no TAA: 12 frames at 1920x1080 through Renderer.render
    (overflow 0, no shadow ray at the step limit, K1 and the shadow kernel
    launched once a frame), the last pose's refit BLAS and TLAS valid and
    tight (refit_violations), then the scene at 320x184 on the card against
    the port's CPU render (mean 5e-3). Returns the median ms/frame."""
    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.scene import skin as skin_mod

    p = config5_preset(pt, skinned=True)
    world = p.world
    knot = world.skins[0].mesh_id
    scene = world.device(dev, with_tlas=p.with_tlas)
    r = preset_renderer(p, scene, WIDTH, HEIGHT)
    reset_launches()
    out, times, mem = run_frames(r, p.camera, "skinned config 5",
                                 knot_joint_mats)
    expect_launches("skinned config 5", dict(k1=FRAMES, shadow_trace=FRAMES,
                                             shadow_pack=FRAMES))
    ms = float(np.median(times[2:]))
    n_inst = int((scene.instances.mesh_id == knot).sum())
    print(f"skinned config 5 {WIDTH}x{HEIGHT} (the knot a 2-joint skin of "
          f"{world.skins[0].rest_pos.shape[0]} triangles, {n_inst} "
          f"instances; rt shadows): median {ms:.3f} ms/frame over frames "
          f"3-{FRAMES} ({card}); {mem}; shadow rays {int(r.aux['rt_rays'])}, "
          f"exhausted {int(r.aux['rt_exhausted'])}; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    args, kwargs = frame_shadow_rays(pt, scene, r.config, p.camera, 1,
                                     knot_joint_mats(FRAMES - 1))
    got, want, counts, differ = shadow_trace_check(args, kwargs)
    print(f"shadow_trace (skinned config 5, last pose): "
          f"{int(kwargs['active'].sum())} active rays, hits "
          f"{int(got.hit.sum())}, differing hits {differ}, exhausted kernel "
          f"{int(got.exhausted)} twin {int(want.exhausted)}; {counts} "
          f"({card})", flush=True)
    if differ or int(got.exhausted) or int(want.exhausted):
        fail("shadow_trace disagrees with its twin on the skinned frame")
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
    imgs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = dataclasses.replace(config5_preset(pt, True, sw / sh),
                                pair_capacity=1 << 17)
        r = preset_renderer(p, p.world.device(d, with_tlas=p.with_tlas),
                            sw, sh)
        for i in range(2):
            img = r.render(p.camera, joint_mats=knot_joint_mats(i + 3))
            if int(r.aux["overflow"]) or int(r.aux["rt_exhausted"]):
                fail(f"small skinned frame overflowed on the {where}")
        imgs[where] = img.cpu().numpy()
    diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"skinned config 5 {sw}x{sh} (2 poses) on the card: mean abs diff "
          f"vs the CPU twins {diff:.3e} (budget {GOLDEN_BUDGET})", flush=True)
    if not (np.isfinite(imgs["card"]).all() and diff < GOLDEN_BUDGET):
        fail("the small skinned frame on the card disagrees with the CPU")
    return ms


def ltc_ring_bound(n_px):
    """The fused ring kernel must read each pixel's nor, rd, pos (12 B
    each) and the two (64, 64, 4) tables once, and write spec and diff (4 B
    each). Its FP32 operations, counted from csrc/ltc_ring.cu with add,
    sub, mul, div, sqrt, rcp, floor, min, max, atan2, cos and an f64
    multiply or subtract one each: per pixel 194 (n . v and its clamp 7,
    the matrix uv 6, the 5-channel fetch 59, the basis 30, the two
    mat3_mat3 90, the spec difference and product 2), then three disk
    evaluations of 319 (the corners in cosine space 54, the ellipse's
    centre and axes 18, the side test 14, the Gram terms 15, the skew test
    5, the aligned branch 12, the third axis and its flip 14, the centre's
    coordinates 18, the scaled a, b 4, the cubic's coefficients 13, the
    cubic 71, the average direction 30, the form factor 20, the uv 6, the
    1-channel fetch 23, the product 2). The eigen branch costs ~67 more
    and atan2 and cos tens of instructions each: counted at the cheaper
    branch and one operation each, the bound stays a lower bound."""
    return bound_ms(n_px * (36 + 8) + 2 * 64 * 64 * 4 * 4,
                    n_px * (194 + 3 * 319))


def ring_phases(dev, card):
    """The ring light: the golden ring_light scene at 160x96 through the
    example's render on the card against tests/golden/ring_light.png and
    the port's CPU render (mean 5e-3); the scene at 1920x1080 for 12
    frames (K1 and the fused LTC ring kernel launched once a frame, K3 and
    the fused rect kernel never; a finite image with variance); the fused
    ring kernel and its bf16 variant against their twin on that frame's
    own fields (differing words counted, max abs diff <= 1e-5 of the
    largest term), timed beside its bound; one bf16 frame (K1 and the bf16
    ring kernel once) within RING_BF16_MEAN of the f32 frame on the mean,
    its max printed. Returns ({kernel row name: its row}, {counter: launches on the
    ring path}, the median ms/frame)."""
    import torch

    from voidin_tpu_torch.examples import ring_light
    from voidin_tpu_torch.ops import ltc_ring as lg
    from voidin_tpu_torch.passes import shading

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
    got_l = expect_launches("ring light", dict(k1=FRAMES, ltc_ring=FRAMES))
    out = img.cpu().numpy()
    ms = float(np.median(times[2:]))
    print(f"ring light {WIDTH}x{HEIGHT}: median {ms:.3f} ms/frame over "
          f"frames 3-{FRAMES} ({card}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    if out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all() \
            or not out.std() > 0:
        fail("the ring light image is bad")

    seen, real = [], lg.ltc_ring_terms

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    lg.ltc_ring_terms = capture
    try:
        ring_light.render(scene, WIDTH, HEIGHT, **caps)
    finally:
        lg.ltc_ring_terms = real
    args, kwargs = seen[0]
    n_px = args[0].shape[0] * args[0].shape[1]
    rows = {}
    for name, bf16 in (("ltc_ring", False), ("ltc_ring_bf16", True)):
        kw = dict(kwargs, bf16=bf16)
        got = lg.ltc_ring_terms(*args, **kw)
        ref = lg.ltc_ring_terms_reference(*args, **kw)
        torch.cuda.synchronize()
        differ = [words_differ(a, b) for a, b in zip(got, ref)]
        # background pixels (no depth) are NaN in kernel and twin alike:
        # their words are compared above, the values where both are finite
        fin = [torch.isfinite(a) & torch.isfinite(b) for a, b in zip(got, ref)]
        scale = max(max(float(b[f].abs().max()) for b, f in zip(ref, fin)),
                    1.0)
        r = timed_row(
            lambda: lg.ltc_ring_terms(*args, **kw), "ltc_ring_kernel", 10,
            lambda: lg.ltc_ring_terms_reference(*args, **kw), 1,
            ltc_ring_bound(n_px),
            max(float((a[f] - b[f]).abs().max())
                for a, b, f in zip(got, ref, fin)))
        nan_apart = sum(int((torch.isnan(a) != torch.isnan(b)).sum())
                        for a, b in zip(got, ref))
        r.update(differing_words=sum(differ), frame_ms=ms,
                 non_finite=sum(int((~f).sum()) for f in fin))
        print(f"fused LTC ring kernel ({name}) on the ring frame's own "
              f"{tuple(args[0].shape[:2])} fields: differing words (spec, "
              f"diff) {differ} of {n_px} each ({r['non_finite']} non-finite "
              f"values, NaN apart at {nan_apart}); max abs diff "
              f"{r['max_abs_err']} (largest term {scale:.4f}); {timing(r)} "
              f"({card})", flush=True)
        if nan_apart or not r["max_abs_err"] <= RING_REL_TOL * scale:
            fail(f"{name} disagrees with its twin beyond {RING_REL_TOL} of "
                 f"the largest term")
        rows[name] = r

    frames = {}
    for bf16 in (False, True):
        shading.LTC_LUT_BF16 = bf16
        try:
            reset_launches()
            frames[bf16] = ring_light.render(scene, WIDTH, HEIGHT,
                                             **caps).cpu().numpy()
        finally:
            shading.LTC_LUT_BF16 = False
    bf16_l = expect_launches("ring light bf16 frame", dict(
        k1=1, ltc_ring_bf16=1))
    diff = np.abs(frames[True].astype(np.float64) - frames[False])
    print(f"ring light {WIDTH}x{HEIGHT} with LTC_LUT_BF16: max abs diff to "
          f"the f32 frame {diff.max():.3e}, mean {diff.mean():.3e} (bound "
          f"{RING_BF16_MEAN})", flush=True)
    if not (np.isfinite(frames[True]).all()
            and diff.mean() < RING_BF16_MEAN):
        fail("the bf16 ring frame strays from the f32 frame")
    launches = dict(ltc_ring=got_l["ltc_ring"],
                    ltc_ring_bf16=bf16_l["ltc_ring_bf16"], k1=got_l["k1"])
    return rows, launches, ms


# Phase 14: config -> (the preset's arguments at full size, the kernels
# besides K1 base that its frame launches once: the fused LTC kernel where
# the scene has rect area lights). Config 5 is phase 10's scene.
PRESET_RUNS = {
    1: ({}, ()),
    2: (dict(n_instances=1000), ()),
    3: ({}, ("ltc_rect",)),
    4: ({}, ("ltc_rect",)),
    6: (dict(n_textures=104, n_knots=32), ("ltc_rect",)),
    7: (dict(detail=1.0), ("ltc_rect",)),
}


def preset_renderer(p, scene, width, height, mesh=None):
    """A Renderer for preset `p` wired as bench.py:458-501 wires it: the
    preset's capacities, cull / TAA / raytraced-shadow flags and moving
    instances; row-sharded over `mesh` where given."""
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.passes.raster import RasterConfig

    cfg = RasterConfig(width=width, height=height,
                       tri_capacity=p.tri_capacity,
                       pair_capacity=p.pair_capacity,
                       tile_tri_capacity=p.tile_tri_capacity)
    return Renderer(scene, cfg, enable_cull=p.enable_cull,
                    enable_taa=p.enable_taa,
                    enable_rt_shadows=p.enable_rt_shadows,
                    rt_shadow_scale=p.rt_shadow_scale,
                    moving_ids=np.asarray(p.moving_ids, np.int32),
                    mesh=mesh)


def preset_phases(dev, card):
    """The BASELINE presets of PRESET_RUNS at 1920x1080 through the
    Renderer, FRAMES frames each (config 4 posed by clapper_joint_mats at
    the Renderer's time): overflow 0, a finite last image with variance,
    K1 base once a frame and the fused LTC kernel once a frame where the
    preset has area lights, nothing else; on config 4 the last pose's
    refit BLAS valid and tight for both arms and frames 0 and 6 different.
    Before its run, each preset's first frame holds K1 base and the fused
    LTC kernel against their twins on the inputs it hands them
    (hold_path_kernels). Prints each preset's host build times, sizes,
    draws, median ms/frame and peak memory. Returns (the launches of the
    presets' runs by counter, {kernel row name: {preset: its row on that
    preset's inputs}})."""
    import torch

    from voidin_tpu_torch.framework import presets
    from voidin_tpu_torch.scene import skin as skin_mod

    launches, paths = {}, {}
    for n, (kwargs, extra) in PRESET_RUNS.items():
        label = f"config {n}"
        t0 = time.perf_counter()
        p = presets.PRESETS[n](WIDTH / HEIGHT, **kwargs)
        t_world = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        scene = p.world.device(dev, with_tlas=p.with_tlas)
        torch.cuda.synchronize()
        t_device = (time.perf_counter() - t0) * 1e3
        w = p.world
        sizes = dict(triangles=w.meshes._index_count // 3,
                     instances=len(w.instances), meshes=len(w.meshes),
                     texture_slots=len(w.textures),
                     texture_bytes=int(scene.textures.quads.numel()),
                     skins=len(w.skins))
        print(f"{label}: World {t_world:.1f} ms, World.device() "
              f"{t_device:.1f} ms on the host; {sizes}; capacities tri "
              f"{p.tri_capacity} pair {p.pair_capacity}; cull "
              f"{p.enable_cull} TAA {p.enable_taa} moving "
              f"{len(p.moving_ids)}", flush=True)
        for k, row in hold_path_kernels(
                label, lambda: preset_renderer(p, scene, WIDTH, HEIGHT).render(
                    p.camera, joint_mats=p.animator(0.0) if p.animator
                    else None), ("k1",) + extra, card).items():
            paths.setdefault(k, {})[label] = row
        r = preset_renderer(p, scene, WIDTH, HEIGHT)
        joint_mats = None
        if p.animator is not None:
            def joint_mats(_i, r=r, p=p):
                return p.animator(r.time)
        keep = {0: None, 6: None} if w.skins else None
        reset_launches()
        out, times, mem = run_frames(r, p.camera, label, joint_mats, keep)
        want = dict(k1=FRAMES, **{k: FRAMES for k in extra})
        got = expect_launches(label, want)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        ms = float(np.median(times[2:]))
        print(f"{label} {WIDTH}x{HEIGHT}: median {ms:.3f} ms/frame over "
              f"frames 3-{FRAMES} ({card}); {mem}; draws "
              f"{int(r.aux['draw_count'])} of {sizes['instances']} "
              f"instances; image mean {out.mean():.4f} std "
              f"{out.std():.4f}", flush=True)
        if w.skins:
            jm = torch.from_numpy(p.animator(r.time - 1.0 / 60.0)).to(dev)
            meshes = skin_mod.apply_skins(scene.meshes, scene.skins, jm)
            bad = [refit_violations(w, s.mesh_id, meshes, None,
                                    scene.instances) for s in w.skins]
            moved = float(np.abs(keep[6] - keep[0]).mean())
            print(f"{label}, last pose's refit BLAS of its {len(w.skins)} "
                  f"skins on the card: violations {bad}; frames 0 and 6 "
                  f"differ by mean {moved:.3e}", flush=True)
            if any(any(b.values()) for b in bad) or not moved > 0:
                fail(f"{label}: the skinned arms' refit BLAS is invalid or "
                     f"they do not move")
        del r, scene, p, w
        torch.cuda.empty_cache()
    return launches, paths


def import_phases(dev, card):
    """Scene import and snapshots: write_import_scene's glTF (.glb) and OBJ
    files imported through the port (import_world), FRAMES frames at
    1920x1080 posed by GltfAnimator (overflow 0, K1 base and the fused LTC
    kernel once a frame), the same scene (.gltf with data URIs) at 320x184
    on the card against the CPU twins (mean 5e-3); then config 7 saved with
    save_scene, loaded onto the card with load_scene and rendered once
    against one frame of the scene it was saved from (mean <= 1e-6; the
    max abs diff and whether every word is equal printed). Before the
    1080p run, its first frame holds K1 base and the fused LTC kernel
    against their twins on its own inputs (hold_path_kernels). Returns
    (the launches of the import run by counter, {kernel row name:
    {"import": its row on the import scene's inputs}})."""
    import tempfile

    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework import presets
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.io.gltf import GltfAnimator
    from voidin_tpu_torch.io.snapshot import load_scene, save_scene
    from voidin_tpu_torch.passes.raster import RasterConfig

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_import_scene(tmp)
        t0 = time.perf_counter()
        world, doc = import_world(pt, paths, "glb")
        t_import = (time.perf_counter() - t0) * 1e3
        small = {where: import_world(pt, paths, "gltf")[0].device(d)
                 for where, d in (("card", dev),
                                  ("cpu", torch.device("cpu")))}
    animator = GltfAnimator(doc)
    print(f"import scene: {os.path.basename(paths['glb'])} "
          f"({len(doc.mesh_ids)} primitives, {len(doc.material_ids)} "
          f"materials, {len(world.skins)} skin, animation "
          f"{animator.duration} s) + {os.path.basename(paths['obj'])}: "
          f"{len(world.meshes)} meshes, {len(world.instances)} instances, "
          f"{len(world.textures)} texture slots, imported in "
          f"{t_import:.1f} ms on the host", flush=True)
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 16,
                       pair_capacity=1 << 19)
    scene = world.device(dev)
    cam = pt.Camera(**IMPORT_CAMERA, aspect=WIDTH / HEIGHT)
    paths = {k: {"import": row} for k, row in hold_path_kernels(
        "import", lambda: Renderer(scene, cfg).render(
            cam, joint_mats=import_joint_mats(animator, 0)),
        ("k1", "ltc_rect"), card).items()}
    r = Renderer(scene, cfg)
    reset_launches()
    out, times, mem = run_frames(r, cam, "import",
                                 lambda i: import_joint_mats(animator, i))
    got = expect_launches("import", dict(k1=FRAMES, ltc_rect=FRAMES))
    ms = float(np.median(times[2:]))
    print(f"import scene {WIDTH}x{HEIGHT}: median {ms:.3f} ms/frame over "
          f"frames 3-{FRAMES} ({card}); {mem}; image mean {out.mean():.4f} "
          f"std {out.std():.4f}", flush=True)
    del r, scene

    sw, sh = 320, 184
    scfg = RasterConfig(width=sw, height=sh, tri_capacity=1 << 16,
                        pair_capacity=1 << 17)
    imgs = {}
    for where, scene in small.items():
        r = Renderer(scene, scfg)
        for i in range(3):
            img = r.render(pt.Camera(**IMPORT_CAMERA, aspect=sw / sh),
                           joint_mats=import_joint_mats(animator, i + 4))
            if int(r.aux["overflow"]):
                fail(f"small import scene overflowed on the {where}")
        imgs[where] = img.cpu().numpy()
    diff = float(np.abs(imgs["card"] - imgs["cpu"]).mean())
    print(f"import scene (.gltf, data URIs) {sw}x{sh}, 3 TAA frames, on the "
          f"card: mean abs diff vs the CPU twins {diff:.3e} (budget "
          f"{GOLDEN_BUDGET})", flush=True)
    if not (np.isfinite(imgs["card"]).all() and diff < GOLDEN_BUDGET
            and imgs["card"].std() > 0):
        fail("the small import scene on the card disagrees with the CPU")

    p = presets.config7_sponza_geometry(WIDTH / HEIGHT)
    scene = p.world.device(dev)
    frames = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config7.npz")
        t0 = time.perf_counter()
        save_scene(path, scene, p.camera)
        t_save = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded, cam = load_scene(path, dev)
        t_load = (time.perf_counter() - t0) * 1e3
    for label, sc in (("saved", scene), ("loaded", loaded)):
        r = preset_renderer(p, sc, WIDTH, HEIGHT)
        frames[label] = r.render(cam if label == "loaded" else p.camera)
        if int(r.aux["overflow"]):
            fail(f"the {label} config-7 snapshot frame overflowed")
    a, b = frames["saved"], frames["loaded"]
    diff = (a - b).abs()
    same = words_differ(a, b) == 0
    print(f"snapshot of config 7: {size / 2**20:.1f} MiB, saved in "
          f"{t_save:.0f} ms, loaded onto the card in {t_load:.0f} ms; one "
          f"frame of the loaded scene vs the saved one: max abs diff "
          f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}, every "
          f"word equal {same}", flush=True)
    if not float(diff.mean()) <= 1e-6:
        fail("the loaded snapshot renders another frame")
    return got, paths

APP_SIZE = (1280, 1024)  # the model example's window (model.rs)


class _AppSteps:
    """App.step behind run_frames' Renderer interface (the App moves its
    own camera)."""

    def __init__(self, app):
        self.app = app

    def render(self, cam, joint_mats=None):
        return self.app.step()

    @property
    def aux(self):
        return self.app.renderer.aux


class _CameraPath:
    """Renderer.render alone on the App's camera path: the camera
    advanced by one fixed step before each frame, as App.step does."""

    def __init__(self, renderer):
        self.renderer = renderer

    def render(self, cam, joint_mats=None):
        from voidin_tpu_torch.framework.app import FIXED_TIME_STEP

        cam.update(FIXED_TIME_STEP)
        return self.renderer.render(cam, dt=FIXED_TIME_STEP)

    @property
    def aux(self):
        return self.renderer.aux


def app_run_pair(app, label, card):
    """FRAMES App.step frames, FRAMES frames of a Renderer alone over the
    App's scene on the same camera path, then FRAMES App.step frames
    again (the Renderer's run between the App's, as the card's frame times
    drift); each App run's launches counted: K1 base and the fused LTC
    kernel once a frame, nothing else. Returns (the App runs' launches,
    the App's median ms over both runs' frames 3-12, the Renderer's)."""
    import copy

    import torch

    from voidin_tpu_torch.framework.renderer import Renderer

    w, h = app.config.width, app.config.height
    launches, app_times = {}, []
    r = Renderer(app.renderer.scene, app.config,
                 moving_ids=app.renderer.moving_ids.cpu().numpy())
    for run in ("App", "Renderer", "App"):
        name = (f"{label}, Renderer.render alone" if run == "Renderer"
                else label)
        cam = copy.deepcopy(app.state.camera)
        reset_launches()
        if run == "App":
            out, times, mem = run_frames(_AppSteps(app), None, name,
                                         shape=(h, w, 3))
            app_times += times[2:]
        else:
            _, times, _ = run_frames(_CameraPath(r), cam, name,
                                     shape=(h, w, 3))
            r_ms = float(np.median(times[2:]))
        got = expect_launches(name, dict(k1=FRAMES, ltc_rect=FRAMES))
        if run == "App":
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
    del r
    torch.cuda.empty_cache()
    app_ms = float(np.median(app_times))
    print(f"{label} {w}x{h}: App.step median {app_ms:.3f} ms/frame over "
          f"frames 3-{FRAMES} of two runs, Renderer.render alone "
          f"{r_ms:.3f} between them (the App's own host cost "
          f"{app_ms - r_ms:+.3f}) ({card}); {mem}; image mean "
          f"{out.mean():.4f} std {out.std():.4f}", flush=True)
    return launches, app_ms, r_ms


def record_phase(app, card, path, step_ms):
    """App.run(FRAMES, record_path=path, hud=True): prints the route the
    recorder took and the run's ms/frame beside `step_ms` (App.step
    without recording); on the AVI route reads the file back
    (avi_frames: the RIFF / hdrl / movi / idx1 layout, FRAMES '00dc'
    chunks that idx1 points at) and decodes every frame with the port's
    decoder against the frame the recorder was handed (mean abs <= 0.01).
    Returns the run's launches."""
    import torch

    from voidin_tpu_torch.io.jpeg import decode_jpeg

    pushed, step_times = [], []
    real_push, real_step = app.recorder.push, app.step

    def push(frame):
        pushed.append(np.array(frame, np.float32))
        real_push(frame)

    def step():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = real_step()
        end.record()
        end.synchronize()
        step_times.append(start.elapsed_time(end))
        if int(app.renderer.aux["overflow"]):
            fail("App.run frame overflowed")
        return img

    app.recorder.push, app.step = push, step
    reset_launches()
    t0 = time.perf_counter()
    try:
        app.run(FRAMES, record_path=path, hud=True)
    finally:
        app.step = real_step
    wall = (time.perf_counter() - t0) * 1e3
    got = expect_launches("App.run with recording",
                          dict(k1=FRAMES, ltc_rect=FRAMES))
    out = app.recorder.out_path
    route = "MJPEG-AVI (no ffmpeg)" if out.endswith(".avi") else "ffmpeg"
    size = os.path.getsize(out)
    print(f"App.run({FRAMES}, record_path={os.path.basename(path)}, "
          f"hud=True) at {app.config.width}x{app.config.height}: route "
          f"{route} -> {os.path.basename(out)} ({size:,} bytes); App.step "
          f"median {float(np.median(step_times[2:])):.3f} ms/frame over "
          f"frames 3-{FRAMES} while recording, the run's wall time "
          f"{wall / FRAMES:.3f} ms/frame (the recorder's drain included), "
          f"against {step_ms:.3f} ms/frame without recording ({card})",
          flush=True)
    if len(pushed) != FRAMES or size <= 0:
        fail(f"the recorder was handed {len(pushed)} frames")
    if route != "ffmpeg":
        with open(out, "rb") as f:
            frames = avi_frames(f.read())
        if len(frames) != FRAMES:
            fail(f"the AVI holds {len(frames)} frames, not {FRAMES}")
        t0 = time.perf_counter()
        diffs = []
        for data, want in zip(frames, pushed):
            got_img = decode_jpeg(data, "clip.avi frame") / 255.0
            if got_img.shape != want.shape:
                fail(f"decoded frame shape {got_img.shape}")
            diffs.append(np.abs(got_img - np.clip(want, 0, 1)))
        t_dec = (time.perf_counter() - t0) * 1e3 / FRAMES
        means = [float(d.mean()) for d in diffs]
        print(f"AVI read back: {FRAMES} '00dc' frames of "
              f"{min(map(len, frames)):,}-{max(map(len, frames)):,} bytes, "
              f"decoded by io/jpeg.py in {t_dec:.0f} ms each on the host; "
              f"mean abs diff to the frames handed to the recorder "
              f"{max(means):.4f} at most (budget 0.01), max abs diff "
              f"{max(float(d.max()) for d in diffs):.4f}", flush=True)
        if not max(means) <= 0.01:
            fail("the AVI's frames stray from the recorded frames")
    return got


def web_phase(app, card):
    """run_web on 127.0.0.1 at a free port over the App: GET a frame
    (decode_png: the App's size), GET the stats, hold W for three frames
    and check that the camera moved, then Esc. Returns the launches of
    its frames (K1 base and the fused LTC kernel once a frame)."""
    import json as _json
    import threading
    import urllib.request

    from voidin_tpu_torch.framework.webviewer import run_web
    from voidin_tpu_torch.io.image import decode_png

    def get(url):
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.read()

    def post(url, obj):
        req = urllib.request.Request(url, data=_json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    pos0 = np.array(app.state.camera.position, np.float64)
    ready = threading.Event()
    result = {}
    reset_launches()
    t = threading.Thread(target=lambda: result.update(frames=run_web(
        app, host="127.0.0.1", port=0, max_frames=200, fps_cap=1000.0,
        ready=ready)), daemon=True)
    t.start()
    if not ready.wait(60):
        fail("the web viewer did not come up")
    base = f"http://127.0.0.1:{ready.port}"
    try:
        t0 = time.perf_counter()
        png = get(base + "/frame.png")
        t_png = (time.perf_counter() - t0) * 1e3
        img = decode_png(png)
        stats = _json.loads(get(base + "/stats"))
        post(base + "/input", {"type": "down", "key": "w"})
        f0 = _json.loads(get(base + "/stats"))["frame"]
        deadline = time.perf_counter() + 60
        while _json.loads(get(base + "/stats"))["frame"] < f0 + 3:
            if time.perf_counter() > deadline:
                fail("the web viewer stopped rendering")
            time.sleep(0.01)
        post(base + "/input", {"type": "up", "key": "w"})
    finally:
        post(base + "/input", {"type": "down", "key": "escape"})
        t.join(120)
    if t.is_alive():
        fail("the web viewer did not stop on Esc")
    n = result["frames"]
    got = expect_launches("web viewer", dict(k1=n, ltc_rect=n))
    moved = float(np.linalg.norm(np.asarray(app.state.camera.position)
                                 - pos0))
    h, w = app.config.height, app.config.width
    print(f"web viewer on {base}: {n} frames; /frame.png {len(png):,} "
          f"bytes, decoded {img.shape}, first response in {t_png:.0f} ms; "
          f"stats frame {stats['frame']}; W held -> camera moved "
          f"{moved:.4f} ({card})", flush=True)
    if img.shape[:2] != (h, w) or not img[..., :3].std() > 0:
        fail(f"the web viewer served a frame of shape {img.shape}")
    if not moved > 1e-3:
        fail("the web viewer's key did not move the camera")
    return got


def app_phases(dev, card, k1_device_ms):
    """Phase 16: the app layer on the card. examples/model.py's App at its
    1280x1024 (K1 base and the fused LTC kernel held against their twins
    on the App's first frame first, hold_path_kernels), App.step frames
    beside Renderer.render frames on the same camera path (app_run_pair);
    App.resize(1920, 1080) (Example.resize called, the
    peak memory after it printed) and the pair again; App.run with
    recording (record_phase); profile_frame on the north star at
    1920x1080 (every row > 0; the fine raster row beside K1's device ms
    from phase 2); the web viewer (web_phase). Returns (the launches of
    the App's runs by counter, {kernel row name: {"App (model)": its row
    on the App's first-frame inputs}})."""
    import tempfile

    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.examples import model
    from voidin_tpu_torch.framework.profiler import (print_table,
                                                     profile_frame)
    from voidin_tpu_torch.framework.renderer import build_world
    from voidin_tpu_torch.passes.raster import RasterConfig

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    app = model.make_app(*APP_SIZE, dev)
    print(f"App (examples/model.py) at {APP_SIZE[0]}x{APP_SIZE[1]}: "
          f"{len(app.world.instances)} instances, {len(app.moving_ids)} "
          f"moving, built in {(time.perf_counter() - t0) * 1e3:.0f} ms on "
          f"the host", flush=True)
    paths = {k: {"App (model)": row} for k, row in hold_path_kernels(
        "App (model) first frame", app.step, ("k1", "ltc_rect"),
        card).items()}
    got, small_ms, _ = app_run_pair(app, "App (model)", card)
    add(got)

    resized = []
    real_resize = app.example.resize
    app.example.resize = lambda a, w, h: (resized.append((w, h)),
                                          real_resize(a, w, h))
    torch.cuda.reset_peak_memory_stats()
    app.resize(WIDTH, HEIGHT)
    print(f"App.resize({WIDTH}, {HEIGHT}): Example.resize called with "
          f"{resized}; peak device memory through the resize "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, resident "
          f"after it {torch.cuda.memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    if resized != [(WIDTH, HEIGHT)] or app.renderer.config.width != WIDTH:
        fail("App.resize did not reach the Example or the Renderer")
    got, full_ms, _ = app_run_pair(app, "App (model) resized", card)
    add(got)

    with tempfile.TemporaryDirectory() as tmp:
        add(record_phase(app, card, os.path.join(tmp, "clip.mp4"), full_ms))
        if app.recorder.out_path.endswith(".mp4"):  # ffmpeg took it
            add(record_phase(app, card, os.path.join(tmp, "clip.avi"),
                             full_ms))
    print(f"App (model) ms/frame: {APP_SIZE[0]}x{APP_SIZE[1]} "
          f"{small_ms:.3f}, {WIDTH}x{HEIGHT} {full_ms:.3f} ({card})",
          flush=True)

    world, _ = build_world(10_000, seed=0)
    scene = world.device(dev)
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=CAP,
                       pair_capacity=CAP)
    rows = profile_frame(scene, north_star_camera(pt).uniform(), cfg)
    print(f"profile_frame, north star {WIDTH}x{HEIGHT} ({card}):",
          flush=True)
    print_table(rows)
    fine = dict(rows)["fine raster (cuda)"]
    print(f"profiler row 'fine raster (cuda)' {fine:.4f} ms (CUDA events "
          f"around one call, wrapper included) beside K1's device time "
          f"from phase 2 {fmt_ms(k1_device_ms)}", flush=True)
    if not all(ms > 0 for _, ms in rows):
        fail("a profiler row is not > 0")
    del scene, world
    torch.cuda.empty_cache()

    add(web_phase(app, card))
    return launches, paths


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
    print(f"host BVH builder and texture packer: {native.builder()}, "
          f"{native.packer()} (ready in "
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

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done",
              flush=True)

    stamp("phase 2 (the kernels against their twins)")
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

    stamp("phases 3-4 (golden and small scenes)")
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

    stamp("phases 5-9 (the 1080p frames)")
    rows["shadow_trace"], rows["shadow_pack"], rt_launches = rt_phases(dev,
                                                                      card)
    stamp("phase 10 (raytraced shadows)")
    rows["closest_hit"], closest_launches = closest_phases(dev, card)
    stamp("phase 11 (closest hit)")
    skin_phases(dev, card)
    stamp("phase 12 (skinned)")
    ring_rows, ring_launches, _ = ring_phases(dev, card)
    rows.update(ring_rows)
    stamp("phase 13 (ring light)")
    preset_launches, preset_paths = preset_phases(dev, card)
    stamp("phase 14 (presets)")
    import_launches, import_paths = import_phases(dev, card)
    stamp("phase 15 (import, snapshots)")
    app_launches, app_paths = app_phases(
        dev, card, rows["fine_raster_pairs"]["device_ms"])
    stamp("phase 16 (the app layer)")
    shard_launches, als_row = shard_phases(dev, card)
    stamp("phase 17 (the sharded frame, debug_bounds, area_light_scale)")
    host_phases(dev, card)
    stamp("phase 18 (texture packer, image decoding)")
    jpeg_launches, jpeg_paths = image_import_phases(dev, card)
    stamp("phase 19 (the import scene with lossless, arithmetic and "
          "smoothed JPEGs and a WebP)")
    for name in ("fine_raster_pairs", "ltc_rect"):
        rows[name]["paths"] = {**preset_paths.get(name, {}),
                               **import_paths.get(name, {}),
                               **app_paths.get(name, {}),
                               **jpeg_paths.get(name, {})}
    rows["ltc_rect"]["paths"][
        f"area_light_scale 2 ({WIDTH}x{SHARD_HEIGHT})"] = als_row

    path_launches = dict(
        fine_raster_pairs=(ns_launches["k1"] + preset_launches["k1"]
                           + import_launches["k1"] + app_launches["k1"]
                           + shard_launches["k1"] + jpeg_launches["k1"]
                           + ring_launches["k1"]),
        fine_raster_pairs_track2=masked_launches["k1_track2"],
        fine_raster_pairs_payload=payload_launches["k1_payload"],
        fine_raster_blocks=block_launches["k2"],
        fine_raster_blocks_track2=small_block_launches["k2_track2"],
        lut_fetch=ns_launches["k3"],
        lut_fetch_bf16=bf16_launches["k3_bf16"],
        ltc_rect=(ns_launches["ltc_rect"] + preset_launches["ltc_rect"]
                  + import_launches["ltc_rect"]
                  + app_launches["ltc_rect"] + shard_launches["ltc_rect"]
                  + jpeg_launches["ltc_rect"]),
        ltc_rect_bf16=bf16_launches["ltc_rect_bf16"],
        ltc_ring=ring_launches["ltc_ring"],
        ltc_ring_bf16=ring_launches["ltc_ring_bf16"],
        shadow_trace=(rt_launches["shadow_trace"]
                      + shard_launches["shadow_trace"]),
        shadow_pack=(rt_launches["shadow_pack"]
                     + shard_launches["shadow_pack"]),
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
        ltc_ring=("voidin_tpu_torch/csrc/ltc_ring.cu",
                  "voidin_tpu/ops/lut_fetch.py:43"),
        ltc_ring_bf16=("voidin_tpu_torch/csrc/ltc_ring.cu",
                       "voidin_tpu/ops/lut_fetch.py:59"),
        # no TPU kernel: the JAX package's stackless traversal in plain jnp
        shadow_trace=("voidin_tpu_torch/csrc/shadow_trace.cu",
                      "voidin_tpu/rt/traverse.py:616"),
        # no TPU kernel: the threaded table the JAX walk packs in plain jnp
        shadow_pack=("voidin_tpu_torch/csrc/shadow_trace.cu",
                     "voidin_tpu/rt/traverse.py:858"),
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


# --- phase 17: the row-sharded frame and the Renderer options -------------
# 1080 rows are 135 tile rows, which no slab count above 1 divides: the
# sharded north star runs at 1088 rows (136 tile rows), its unsharded
# frame at the same size as the reference.
SHARD_HEIGHT = 1088
SHARD_COUNTS = (2, 4)
# A slab bins its extras at local_pair_capacity (pair capacity / N, the
# JAX package's rule), which assumes the extras spread over the slabs;
# the north star's sit mostly in the horizon's slab (at 2^19, 2 slabs
# overflowed by 27,153 pairs), so every run of phase 17 bins with 2^21.
SHARD_PAIR_CAP = 1 << 21
SHARD_RT_FRAMES = 3
ALS_Q99_BUDGET = 0.12  # tests/test_ltc.py:401 (mean: GOLDEN_BUDGET)


def hold_slab_kernels(label, calls, card):
    """Each slab's K1 and fused LTC launch of one sharded frame (the
    kernel_calls of that frame) against its twin on the slab's own
    inputs (hold_k1_call, hold_ltc_call). Returns [K1 device ms per
    slab]."""
    k1_ms = [hold_k1_call(f"{label}, slab {d}", *call, card)["device_ms"]
             for d, call in enumerate(calls["k1"])]
    for d, call in enumerate(calls["ltc_rect"]):
        hold_ltc_call(f"{label}, slab {d}", *call, card)
    return k1_ms


def shard_phases(dev, card, cards_only=False):
    """Phase 17: the row-sharded frame (parallel/sharding.py),
    debug_bounds and area_light_scale on the card.

    1. The north star at 1920x1088 (pair capacity SHARD_PAIR_CAP),
       FRAMES frames with TAA and moving instances: unsharded, then on
       meshes naming the card 2 and 4 times (and on 2 and 4 real cards
       where that many are visible): every
       sharded frame word for word the unsharded one, overflow 0, K1 and
       the fused LTC kernel launched once per slab and frame; then each
       slab's K1 and fused LTC launch of one more frame against their
       twins on the slab's own inputs (hold_slab_kernels).
    2. Config 5 (raytraced shadows) at 1920x1088 on 2 slabs,
       SHARD_RT_FRAMES frames: word for word its unsharded frames, the
       shadow kernel once per slab and frame.
    3. debug_bounds: the checked north-star frame word for word the
       unchecked one; a corrupted tri_id raises resolve.rec; a corrupted
       TLAS child raises rt. with the shadow kernel not launched; a
       checked frame after those errors is still the clean frame.
    4. area_light_scale=2 on the north star: the fused kernel once, on
       the (544, 960) subsampled fields, equal to its twin there; the
       frame within tests/test_ltc.py's budgets of the full-resolution
       frame; FRAMES frames timed.

    `cards_only` (tools/torch_shard_probe.py --cards-only, a host with
    several cards): part 1 alone, unsharded and on the real cards.
    Returns (the launches of the main-path runs by counter, the fused
    kernel's row on area_light_scale 2's inputs, None with cards_only)."""
    import torch

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.core import checks
    from voidin_tpu_torch.framework.renderer import Renderer, build_world
    from voidin_tpu_torch.ops import shadow_trace as st
    from voidin_tpu_torch.parallel import sharding as sh
    from voidin_tpu_torch.passes import cull, raster, resolve
    from voidin_tpu_torch.passes.raster import RasterConfig

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    H = SHARD_HEIGHT
    shape = (H, WIDTH, 3)
    cfg = RasterConfig(width=WIDTH, height=H, tri_capacity=CAP,
                       pair_capacity=SHARD_PAIR_CAP)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                    aspect=WIDTH / H)
    world, moving = build_world(10_000, seed=0)
    n_cards = torch.cuda.device_count()
    runs = [("unsharded", None, 1)]
    runs += [(f"{n} slabs on one card", sh.make_mesh(devices=[dev] * n), n)
             for n in SHARD_COUNTS if not cards_only]
    runs += [(f"{n} slabs on {n} cards", sh.make_mesh(n), n)
             for n in SHARD_COUNTS if n_cards >= n]
    print(f"phase 17, the sharded north star {WIDTH}x{H}: runs "
          f"{[label for label, _, _ in runs]} ({n_cards} card(s) visible; "
          f"a run on N real cards only where N are)", flush=True)
    base, ms = None, {}
    for label, mesh, n in runs:
        r = Renderer(world.device(dev), cfg, moving_ids=moving, mesh=mesh)
        keep = dict.fromkeys(range(FRAMES))
        reset_launches()
        out, times, mem = run_frames(r, cam, f"sharded north star, {label}",
                                     keep=keep, shape=shape)
        add(expect_launches(f"sharded north star, {label}", dict(
            k1=n * FRAMES, ltc_rect=n * FRAMES)))
        ms[label] = float(np.median(times[2:]))
        line = (f"sharded north star {WIDTH}x{H}, {label}: median "
                f"{ms[label]:.3f} ms/frame over frames 3-{FRAMES} ({card}); "
                f"{mem}")
        if mesh is None:
            base = keep
            print(line, flush=True)
            continue
        differ = [words_differ(torch.from_numpy(keep[i]),
                               torch.from_numpy(base[i]))
                  for i in range(FRAMES)]
        print(f"{line}; words differing from the unsharded frames {differ}",
              flush=True)
        if any(differ):
            fail(f"sharded north star, {label}: the frames differ from the "
                 f"unsharded frames")
        calls = kernel_calls(lambda: r.render(cam))
        if {k: len(v) for k, v in calls.items()} != dict(k1=n, ltc_rect=n):
            fail(f"{label}: one frame called {calls.keys()} other than once "
                 f"per slab")
        k1_ms = hold_slab_kernels(f"sharded north star, {label}", calls,
                                  card)
        print(f"sharded north star, {label}: per-slab K1 device ms "
              f"{[fmt_ms(t) for t in k1_ms]} ({card})", flush=True)
        del r
    del base
    print("sharded north star ms/frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()) + f" ({card})", flush=True)
    if cards_only:
        return launches, None

    # --- config 5 with raytraced shadows on 2 slabs -----------------------
    p = config5_preset(pt, aspect=WIDTH / H)
    imgs = {}
    for label, mesh, n in (("unsharded", None, 1),
                           ("2 slabs", sh.make_mesh(devices=[dev] * 2), 2)):
        r = preset_renderer(p, p.world.device(dev, with_tlas=p.with_tlas),
                            WIDTH, H, mesh=mesh)
        reset_launches()
        for _ in range(SHARD_RT_FRAMES):
            img = r.render(p.camera)
            if int(r.aux["overflow"]) or int(r.aux["rt_exhausted"]):
                fail(f"config 5 sharded, {label}: overflow or exhausted rays")
        add(expect_launches(f"config 5 {WIDTH}x{H}, {label}", dict(
            k1=n * SHARD_RT_FRAMES, shadow_trace=n * SHARD_RT_FRAMES,
            shadow_pack=n * SHARD_RT_FRAMES)))
        imgs[label] = img
    differ = words_differ(imgs["2 slabs"], imgs["unsharded"])
    print(f"config 5 {WIDTH}x{H} raytraced, 2 slabs: words differing from "
          f"the unsharded frame {differ} (after {SHARD_RT_FRAMES} frames)",
          flush=True)
    if differ:
        fail("the sharded config 5 frame differs from the unsharded frame")
    del imgs

    # --- debug_bounds -----------------------------------------------------
    checked = dataclasses.replace(cfg, debug_bounds=True)

    def frame(c, scene=None, **kw):
        r = Renderer(scene or world.device(dev), c, enable_taa=False, **kw)
        return r.render(cam)

    clean = frame(cfg)
    got = frame(checked)
    differ = words_differ(got, clean)
    print(f"debug_bounds north star {WIDTH}x{H}: words differing from the "
          f"unchecked frame {differ}", flush=True)
    if differ:
        fail("the checked frame differs from the unchecked frame")
    scene = world.device(dev)
    u = cam.uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, u)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, u, cfg,
                           materials=scene.materials)
    vis.tri_id = torch.where(vis.tri_id >= 0, vis.tri_id + 10_000_000,
                             vis.tri_id)
    try:
        with checks.bounds(True):
            resolve.resolve_gbuffer(scene, vis, cfg)
        fail("a corrupted tri_id did not raise")
    except IndexError as e:
        print(f"debug_bounds, corrupted tri_id: IndexError {e}", flush=True)
        if "resolve.rec" not in str(e):
            fail("the corrupted tri_id raised another check")
    del scene, vis
    c5 = p.world.device(dev, with_tlas=True)
    c5.tlas.tlas_left_right[0] = 0x7FFF7FFF  # both children at 32767
    reset_launches()
    try:
        frame(dataclasses.replace(checked, tri_capacity=p.tri_capacity,
                                  pair_capacity=p.pair_capacity),
              scene=c5, enable_rt_shadows=True)
        fail("a corrupted TLAS child did not raise")
    except IndexError as e:
        print(f"debug_bounds, corrupted TLAS child (config 5, raytraced): "
              f"IndexError {e}; shadow kernel launches {st.LAUNCHES}",
              flush=True)
        if not str(e).startswith("rt.") or st.LAUNCHES:
            fail("the corrupted TLAS raised another check or launched")
    del c5
    differ = words_differ(frame(checked), clean)
    print(f"debug_bounds: a checked frame after those errors differs from "
          f"the clean frame in {differ} words", flush=True)
    if differ:
        fail("the card is not usable after the bounds errors")

    # --- area_light_scale = 2 ---------------------------------------------
    calls = kernel_calls(lambda: frame(cfg, area_light_scale=2))
    (args, kw), = calls["ltc_rect"]
    if tuple(args[3].shape) != (-(-H // 2), WIDTH // 2):
        fail("area_light_scale 2: the fused LTC kernel's fields are not "
             "the subsampled grid")
    row = hold_ltc_call("area_light_scale 2", args, kw, card)
    full = frame(cfg).cpu().numpy()
    half = frame(cfg, area_light_scale=2).cpu().numpy()
    diff = np.abs(full - half)
    q99 = float(np.quantile(diff, 0.99))
    print(f"area_light_scale 2 vs 1, north star {WIDTH}x{H}: mean abs diff "
          f"{diff.mean():.3e} (budget {GOLDEN_BUDGET}), 0.99 quantile "
          f"{q99:.3e} (budget {ALS_Q99_BUDGET})", flush=True)
    if not (diff.mean() < GOLDEN_BUDGET and q99 < ALS_Q99_BUDGET):
        fail("area_light_scale 2 strays from the full-resolution frame")
    r = Renderer(world.device(dev), cfg, moving_ids=moving,
                 area_light_scale=2)
    reset_launches()
    out, times, mem = run_frames(r, cam, "area_light_scale 2", shape=shape)
    add(expect_launches("area_light_scale 2", dict(k1=FRAMES,
                                                   ltc_rect=FRAMES)))
    print(f"area_light_scale 2 north star {WIDTH}x{H}: median "
          f"{float(np.median(times[2:])):.3f} ms/frame over frames "
          f"3-{FRAMES} ({card}) vs {ms['unsharded']:.3f} at full "
          f"resolution; {mem}", flush=True)
    del r, world
    torch.cuda.empty_cache()
    return launches, row


# --- phase 18: the host path of texture upload and image import ----------
FIXTURE_DIR = os.path.join("tests", "data", "torch_images")
FIXTURE_PIXELS = ".rgba.png"
# tests/test_io.py:154-165's gate between the native and numpy packers:
# levels 0-3 exact in each level's own texels, every word within 3 steps
PACKER_STEPS = 3


def pack_both(pool):
    """(native quads, numpy quads, native ms, numpy ms) of one TexturePool's
    host_arrays, by the host's clock; numpy under VOIDIN_NATIVE=0."""
    t0 = time.perf_counter()
    native_q = pool.host_arrays()["quads"]
    t_native = (time.perf_counter() - t0) * 1e3
    os.environ["VOIDIN_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        numpy_q = pool.host_arrays()["quads"]
        t_numpy = (time.perf_counter() - t0) * 1e3
    finally:
        del os.environ["VOIDIN_NATIVE"]
    return native_q, numpy_q, t_native, t_numpy


def device_ms_both(world, dev):
    """Host ms of World.device(dev) on the native packer and on numpy (the
    packer of the port before the native one), by the host's clock."""
    import torch

    from voidin_tpu_torch import native

    out = []
    for packer in ("native", "numpy"):
        real = native.pack_texture
        if packer == "numpy":
            native.pack_texture = lambda *a, **k: None
        try:
            t0 = time.perf_counter()
            world.device(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        finally:
            native.pack_texture = real
    return out


def packer_gate(label, pool, native_q, numpy_q):
    """Fails unless the two pools meet PACKER_STEPS' gate; returns the
    number of words where they differ."""
    from voidin_tpu_torch.scene import texture

    T = len(pool.images)
    a = native_q.reshape(T, -1, 32).astype(np.int16)
    b = numpy_q.reshape(T, -1, 32).astype(np.int16)
    sizes = texture._mip_sizes(int(round(np.sqrt((3 * a.shape[1] + 1) / 4))))
    fine = sum(s * s for s in sizes[:4])
    if not np.array_equal(a[:, :fine, :16], b[:, :fine, :16]):
        fail(f"{label}: the native and numpy pools differ at mip levels 0-3")
    diff = np.abs(a - b)
    if diff.max() > PACKER_STEPS:
        fail(f"{label}: the native and numpy pools differ by {diff.max()} "
             f"steps (gate {PACKER_STEPS})")
    return int((diff > 0).sum())


def fixture_bound(name):
    """The largest difference from PIL's pixels a fixture's decode may
    have: one level for lossy JPEG, in a JPEG file or a JPEG-in-TIFF one
    (libjpeg's IDCT and upsampling differ from the port's by a rounding),
    none for every other file."""
    lossy_jpeg = (name.endswith(".jpg") and not name.startswith("lossless")
                  or name.startswith(("f8_jpeg", "f8_ojpeg")))
    return 1 if lossy_jpeg else 0


def decode_fixture(path):
    """(decoded RGBA, stored PIL pixels, median ms of 3 decodes) of one
    fixture through io/image.load_image."""
    from voidin_tpu_torch.io.image import load_image

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = load_image(path)
        times.append((time.perf_counter() - t0) * 1e3)
    return got, load_image(path + FIXTURE_PIXELS), float(np.median(times))


def progressive_split(path):
    """Host ms of one decode of a progressive JPEG by scan kind (DC or AC,
    first or refinement scans, io/jpeg.py _decode_scan), the rest (markers,
    IDCT, upsampling, colour) under "rest"."""
    from voidin_tpu_torch.io import image, jpeg

    split = {}
    real = jpeg._decode_scan

    def timed(fr, comps, spectral, *args):
        ss, _, ah, _ = spectral
        kind = ("DC" if ss == 0 else "AC") + (" refine" if ah else " first")
        t0 = time.perf_counter()
        real(fr, comps, spectral, *args)
        split[kind] = split.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
    jpeg._decode_scan = timed
    try:
        t0 = time.perf_counter()
        image.load_image(path)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        jpeg._decode_scan = real
    split["rest"] = total - sum(split.values())
    return {k: round(v, 1) for k, v in split.items()}


def host_phases(dev, card):
    """Phase 18: the native texture packer must be the one in use (no
    numpy fallback here); configs 6 and 7 at phase 14's sizes pack their
    TexturePool through each packer (host ms of host_arrays and of
    World.device on the card, the words where the pools differ, held to
    PACKER_STEPS' gate); the lzma module must import (LZMA-in-TIFF);
    every committed image fixture decodes to its stored PIL pixels (PNG
    and TIFF word for word, JPEG and JPEG-in-TIFF within 1 level,
    fixture_bound), with its host ms and ms per megapixel (the 512x512
    ZSTD, LZMA, G4 and JPEG-in-TIFF files among them), the 512x512
    progressive files by scan kind; then lossless_round_trip."""
    from voidin_tpu_torch import native
    from voidin_tpu_torch.framework import presets

    if native.packer() != "native":
        fail("the native texture packer did not build on this host")
    try:
        import lzma
    except ImportError:
        lzma = None
    print(f"phase 18: the standard library's lzma module (LZMA-in-TIFF) "
          f"{'imports' if lzma else 'is missing'} on the card's host",
          flush=True)
    if lzma is None:
        fail("no lzma module: LZMA-compressed TIFF cannot be decoded")
    print(f"phase 18: texture packer {native.packer()} "
          f"({os.path.basename(native.library_path())}); host ms on the "
          f"card's host ({card})", flush=True)
    for n in (6, 7):
        p = presets.PRESETS[n](WIDTH / HEIGHT, **PRESET_RUNS[n][0])
        pool = p.world.textures
        native_q, numpy_q, t_native, t_numpy = pack_both(pool)
        differ = packer_gate(f"config {n}", pool, native_q, numpy_q)
        d_native, d_numpy = device_ms_both(p.world, dev)
        print(f"phase 18, config {n}: {len(pool.images)} texture slots, "
              f"{native_q.size} pool bytes; host_arrays native "
              f"{t_native:.1f} ms, numpy {t_numpy:.1f} ms; World.device() "
              f"native {d_native:.1f} ms, numpy {d_numpy:.1f} ms; {differ} "
              f"words differ (gate: levels 0-3 exact, <= {PACKER_STEPS} "
              f"steps)", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(root, FIXTURE_DIR)
    paths = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if not f.endswith(FIXTURE_PIXELS))
    if not paths:
        fail(f"no image fixtures in {directory}")
    for path in paths:
        name = os.path.basename(path)
        got, want, ms = decode_fixture(path)
        tol = fixture_bound(name)
        if got.shape != want.shape:
            fail(f"{name}: decoded {got.shape}, PIL's pixels {want.shape}")
        diff = np.abs(got.astype(np.int16) - want)
        if diff.max() > tol:
            fail(f"{name}: {int((diff > 0).sum())} values differ from PIL's,"
                 f" max {diff.max()} (bound {tol})")
        mp = got.shape[0] * got.shape[1] / 1e6
        print(f"phase 18, {name}: {got.shape[1]}x{got.shape[0]} decoded in "
              f"{ms:.1f} ms ({ms / mp:.1f} ms per megapixel), "
              f"{int((diff > 0).sum())} values differ from PIL's (bound "
              f"{tol})", flush=True)
        if name.endswith("_512.jpg"):
            print(f"phase 18, {name} by scan kind (host ms): "
                  f"{progressive_split(path)}", flush=True)
    lossless_round_trip()


LOSSLESS_SIZE = 512


def lossless_round_trip():
    """Lossless decode rate: the 512x512 smooth image of the 512x512
    fixtures as RGB lossless JPEG at 4:4:4, point transform 0, restarts
    every 8 rows, written here by tests/torch_image_writers.py, at
    predictors 1 (row cumulative sums) and 7 (anti-diagonal steps): each
    decode must give the source samples word for word (the card's host
    has no PIL to compare with); prints host ms and ms per megapixel."""
    from tests.torch_image_writers import lossless_jpeg_bytes
    from tools.torch_image_fixtures import smooth_image
    from voidin_tpu_torch.io.image import decode_image

    img = smooth_image(LOSSLESS_SIZE, LOSSLESS_SIZE)
    for predictor in (1, 7):
        data = lossless_jpeg_bytes([img[..., i] for i in range(3)],
                                   predictor=predictor, restart_rows=8)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = decode_image(data, f"lossless predictor {predictor}")
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got[..., :3], img):
            fail(f"the lossless {LOSSLESS_SIZE}x{LOSSLESS_SIZE} file at "
                 f"predictor {predictor} does not decode to its source")
        ms = float(np.median(times))
        print(f"phase 18, lossless {LOSSLESS_SIZE}x{LOSSLESS_SIZE} RGB 4:4:4 "
              f"predictor {predictor} ({len(data)} B): decoded in "
              f"{ms:.1f} ms ({ms / (LOSSLESS_SIZE ** 2 / 1e6):.1f} ms per "
              f"megapixel), every sample its source's", flush=True)


# --- phase 19: the import scene with the JPEG kinds of F6 and a WebP -----
IMAGE_IMPORTS = (("lossless", "lossless_420_restart.jpg"),
                 ("arithmetic progressive", "arith_progressive_420_512.jpg"),
                 ("block-smoothed progressive", "smooth_cut3.jpg"),
                 ("EXT_texture_webp", "webp_lossy.webp"))


def image_import_phases(dev, card):
    """Phase 19: the import scene of phase 15 four times, its embedded
    image a lossless, an arithmetic-coded progressive and a block-smoothed
    progressive JPEG fixture, and an opaque lossy WebP that each texture
    takes through EXT_texture_webp (a WebP with alpha would make the
    material alpha-tested: K1 track2). For each: the decoded image
    equals PIL's stored pixels (fixture_bound: the lossy JPEGs within 1
    level, the rest word for word),
    the imported texture pool holds it, K1 base and the fused LTC kernel
    equal their twins on the first frame's inputs (hold_path_kernels),
    and FRAMES frames at WIDTHxHEIGHT render with overflow 0, one K1 and
    one fused LTC launch a frame. Returns (the launches by counter summed
    over the four runs, {kernel row name: {"import <kind>": row}})."""
    import tempfile

    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.io.gltf import GltfAnimator
    from voidin_tpu_torch.io.image import load_image
    from voidin_tpu_torch.passes.raster import RasterConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=1 << 16,
                       pair_capacity=1 << 19)
    cam = pt.Camera(**IMPORT_CAMERA, aspect=WIDTH / HEIGHT)
    launches, paths = {}, {}
    for kind, name in IMAGE_IMPORTS:
        path = os.path.join(root, FIXTURE_DIR, name)
        with open(path, "rb") as f:
            data = f.read()
        got, want, ms = decode_fixture(path)
        tol = fixture_bound(name)
        diff = np.abs(got.astype(np.int16) - want)
        if got.shape != want.shape or diff.max() > tol:
            fail(f"phase 19, {name}: the decoded image strays from PIL's "
                 f"pixels (bound {tol})")
        with tempfile.TemporaryDirectory() as tmp:
            files = write_import_scene(tmp, image=data)
            t0 = time.perf_counter()
            world, doc = import_world(pt, files, "glb")
            t_import = (time.perf_counter() - t0) * 1e3
        if not any(i.shape == got.shape and (i == got).all()
                   for i in world.textures.images):
            fail(f"phase 19, {name}: the texture pool lacks the image")
        animator = GltfAnimator(doc)
        scene = world.device(dev)
        label = f"import {kind}"
        for k, row in hold_path_kernels(
                label, lambda: Renderer(scene, cfg).render(
                    cam, joint_mats=import_joint_mats(animator, 0)),
                ("k1", "ltc_rect"), card).items():
            paths.setdefault(k, {})[label] = row
        r = Renderer(scene, cfg)
        reset_launches()
        out, times, mem = run_frames(r, cam, label,
                                     lambda i: import_joint_mats(animator, i))
        got_launches = expect_launches(label, dict(k1=FRAMES,
                                                   ltc_rect=FRAMES))
        for k, n in got_launches.items():
            launches[k] = launches.get(k, 0) + n
        print(f"phase 19, {label} ({name}, {got.shape[1]}x{got.shape[0]}, "
              f"decoded in {ms:.1f} ms, {int((diff > 0).sum())} values "
              f"differ from PIL's, bound {tol}; scene imported in "
              f"{t_import:.1f} ms) {WIDTH}x{HEIGHT}: median "
              f"{float(np.median(times[2:])):.3f} ms/frame over frames "
              f"3-{FRAMES} ({card}); {mem}; image mean {out.mean():.4f} "
              f"std {out.std():.4f}", flush=True)
        del r, scene
    return launches, paths


def avi_frames(data):
    """The JPEG bytes of an MJPEG-AVI's frames in idx1 order, after
    checking the layout io/avi.py writes: RIFF 'AVI ' holding the rest of
    the file; LIST 'hdrl' first, whose avih dwTotalFrames is the idx1
    entry count; LIST 'movi' of '00dc' chunks; idx1 last, each entry a
    key frame whose offset (counted from the 'movi' fourcc) points at a
    '00dc' chunk of the entry's size inside movi. Raises ValueError."""
    import struct

    def check(ok, what):
        if not ok:
            raise ValueError(f"AVI layout: {what}")

    check(data[:4] == b"RIFF" and data[8:12] == b"AVI ", "no RIFF AVI")
    check(struct.unpack("<I", data[4:8])[0] == len(data) - 8, "RIFF size")
    check(data[12:16] == b"LIST" and data[20:24] == b"hdrl", "no hdrl")
    hdrl_end = 20 + struct.unpack("<I", data[16:20])[0]
    check(data[24:28] == b"avih", "no avih")
    n_frames = struct.unpack("<I", data[48:52])[0]
    check(data[hdrl_end:hdrl_end + 4] == b"LIST"
          and data[hdrl_end + 8:hdrl_end + 12] == b"movi", "no movi")
    movi = hdrl_end + 8
    movi_end = movi + struct.unpack("<I", data[hdrl_end + 4:hdrl_end + 8])[0]
    check(data[movi_end:movi_end + 4] == b"idx1", "idx1 not after movi")
    n_idx = struct.unpack("<I", data[movi_end + 4:movi_end + 8])[0]
    check(n_idx == 16 * n_frames and movi_end + 8 + n_idx == len(data),
          f"idx1 of {n_idx} bytes for {n_frames} frames")
    frames = []
    for i in range(n_frames):
        e = movi_end + 8 + 16 * i
        fourcc, flags, off, size = struct.unpack("<4sIII", data[e:e + 16])
        at = movi + off
        check(fourcc == b"00dc" and flags & 0x10, f"idx1 entry {i}")
        check(data[at:at + 4] == b"00dc" and at + 8 + size <= movi_end
              and struct.unpack("<I", data[at + 4:at + 8])[0] == size,
              f"frame {i} at offset {off}")
        frames.append(data[at + 8:at + 8 + size])
    return frames


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


def config5_preset(pkg, skinned=False, aspect=WIDTH / HEIGHT):
    """`pkg`'s raytraced-shadows preset (config 5,
    voidin_tpu/framework/presets.py:284-322): 40 instances of the 96x16
    torus knot and the res-4 sphere on a ring, a 50x ground plane, one
    point light, its camera, capacities and flags. The preset's traversal
    choice (rt_packet 128 + rt_threaded) has no counterpart: the port's
    one kernel gives the hits that all of JAX's traversals give. `skinned`
    registers the knot as a skin of 2 joints (knot_skin)."""
    import importlib

    presets = importlib.import_module(pkg.__name__ + ".framework.presets")
    p = presets.config5_raytraced_shadows(aspect)
    if skinned:
        # the preset puts the knot on its odd instances
        knot_skin(pkg, p.world, p.world.instances.mesh_ids[1],
                  _mesh_module(pkg).make_torus_knot(segments=96, sides=16))
    return p


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



# --- the import scene (phase 15): glTF and OBJ files written here --------

# The camera of the import scene: the glTF boxes and the skinned strip at
# z = -6 to -7, the OBJ pyramid to the right.
IMPORT_CAMERA = dict(position=[0.0, 0.6, -1.5], pitch=-8.0)


def palette_png(index, palette, alpha=None):
    """The bytes of an 8-bit palette PNG (colour type 3) of `index` (H, W)
    into `palette` (P, 3) uint8, with `alpha` (P,) as its tRNS chunk."""
    import struct

    from voidin_tpu_torch.io.image import _SIGNATURE, _chunk

    h, w = index.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          index.astype(np.uint8)], axis=1)
    out = (_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
           + _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if alpha is not None:
        out += _chunk(b"tRNS", np.asarray(alpha, np.uint8).tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def _quat(axis, angle):
    """glTF (x, y, z, w) quaternion of `angle` radians about `axis`."""
    a = np.asarray(axis, np.float64) * np.sin(angle / 2)
    return [float(a[0]), float(a[1]), float(a[2]), float(np.cos(angle / 2))]


def import_gltf_document():
    """(glTF JSON, binary buffer, image bytes) of the import scene:
    - mesh 0, a textured box (24 vertices: positions and normals
      interleaved in one buffer view with byteStride 24, normalized
      uint16 uvs, float tangents, uint16 indices; an embedded palette PNG
      with a tRNS chunk as its base colour), instanced twice under a
      translated parent node (one child by TRS, one by matrix);
    - mesh 1, a vertical strip of 9 rows skinned to 2 joints (uint8
      joints, normalized uint8 weights by height, normalized uint8 uvs,
      uint32 indices) whose node carries a translation the skin ignores;
      its elbow joint turns about z by a LINEAR rotation channel over 2 s;
    - mesh 2, a floor quad of 6 vertices without indices, uvs or tangents,
      with the same image as emissive (sRGB) and normal (linear) map."""
    from voidin_tpu_torch.scene import mesh as mesh_mod

    blob, views, accessors = bytearray(), [], []

    def view(data, stride=None):
        while len(blob) % 4:
            blob.append(0)
        v = dict(buffer=0, byteOffset=len(blob), byteLength=len(data))
        if stride:
            v["byteStride"] = stride
        blob.extend(data)
        views.append(v)
        return len(views) - 1

    def accessor(v, ctype, count, kind, offset=0, normalized=False):
        a = dict(bufferView=v, componentType=ctype, count=count, type=kind)
        if offset:
            a["byteOffset"] = offset
        if normalized:
            a["normalized"] = True
        accessors.append(a)
        return len(accessors) - 1

    f32, u8, u16, u32 = 5126, 5121, 5123, 5125
    box = mesh_mod.make_cube_mesh(1.0)
    nv = len(box.vertices)
    pn = view(np.concatenate([box.vertices, box.normals], axis=1)
              .astype(np.float32).tobytes(), stride=24)
    box_prim = dict(attributes=dict(
        POSITION=accessor(pn, f32, nv, "VEC3"),
        NORMAL=accessor(pn, f32, nv, "VEC3", offset=12),
        TANGENT=accessor(view(box.tangents.tobytes()), f32, nv, "VEC4"),
        TEXCOORD_0=accessor(view(np.round(box.uvs * 65535).astype(np.uint16)
                                 .tobytes()), u16, nv, "VEC2",
                            normalized=True)),
        indices=accessor(view(box.indices.astype(np.uint16).tobytes()), u16,
                         len(box.indices), "SCALAR"),
        material=0)

    rows = 9
    ys = np.linspace(-1.0, 1.4, rows, dtype=np.float32)
    strip = np.stack([np.tile([-0.3, 0.3], rows), np.repeat(ys, 2),
                      np.full(2 * rows, -6.0)], -1).astype(np.float32)
    tris = [[2 * r, 2 * r + 1, 2 * r + 2] for r in range(rows - 1)] + [
        [2 * r + 1, 2 * r + 3, 2 * r + 2] for r in range(rows - 1)]
    w1 = np.round(np.linspace(0, 255, rows)).astype(np.uint8).repeat(2)
    joints = np.zeros((2 * rows, 4), np.uint8)
    joints[:, 1] = 1
    weights = np.zeros((2 * rows, 4), np.uint8)
    weights[:, 0], weights[:, 1] = 255 - w1, w1
    uv8 = np.stack([np.tile([0, 255], rows),
                    np.round(np.linspace(0, 255, rows)).repeat(2)],
                   -1).astype(np.uint8)
    strip_prim = dict(attributes=dict(
        POSITION=accessor(view(strip.tobytes()), f32, 2 * rows, "VEC3"),
        NORMAL=accessor(view(np.tile(np.float32([0, 0, 1]), (2 * rows, 1))
                             .tobytes()), f32, 2 * rows, "VEC3"),
        TEXCOORD_0=accessor(view(uv8.tobytes()), u8, 2 * rows, "VEC2",
                            normalized=True),
        JOINTS_0=accessor(view(joints.tobytes()), u8, 2 * rows, "VEC4"),
        WEIGHTS_0=accessor(view(weights.tobytes()), u8, 2 * rows, "VEC4",
                           normalized=True)),
        indices=accessor(view(np.asarray(tris, np.uint32).tobytes()), u32,
                         3 * len(tris), "SCALAR"),
        material=1)
    # joint 0 at (0, -1, -6), joint 1 (the elbow) 1.2 above it: their
    # inverse binds, column-major
    ibm = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    ibm[0, :3, 3] = [0.0, 1.0, 6.0]
    ibm[1, :3, 3] = [0.0, -0.2, 6.0]
    ibm_acc = accessor(view(np.transpose(ibm, (0, 2, 1)).tobytes()), f32, 2,
                       "MAT4")
    times = accessor(view(np.float32([0.0, 1.0, 2.0]).tobytes()), f32, 3,
                     "SCALAR")
    quats = accessor(view(np.float32([_quat([0, 0, 1], 0.0),
                                      _quat([0, 0, 1], 1.05),
                                      _quat([0, 0, 1], 0.0)]).tobytes()),
                     f32, 3, "VEC4")

    floor = np.float32([[-8, -1.2, -12], [-8, -1.2, 2], [8, -1.2, 2],
                        [-8, -1.2, -12], [8, -1.2, 2], [8, -1.2, -12]])
    floor_prim = dict(attributes=dict(
        POSITION=accessor(view(floor.tobytes()), f32, 6, "VEC3"),
        NORMAL=accessor(view(np.tile(np.float32([0, 1, 0]), (6, 1))
                             .tobytes()), f32, 6, "VEC3")),
        material=2)

    yy, xx = np.mgrid[0:16, 0:16]
    image = palette_png((xx // 4 + yy // 4) % 2 + 2 * (yy >= 8),
                        [[210, 60, 40], [240, 220, 180], [40, 90, 200],
                         [90, 200, 120]], alpha=[255, 230, 255, 200])
    m2 = np.eye(4, dtype=np.float32) * 0.8
    m2[3, 3] = 1.0
    m2[:3, 3] = [2.0, 0.3, 0.5]
    doc = dict(
        asset=dict(version="2.0"),
        scene=0,
        scenes=[dict(nodes=[0, 3, 5, 6])],
        nodes=[
            dict(name="parent", translation=[0.0, 0.0, -7.0],
                 children=[1, 2]),
            dict(mesh=0, translation=[-2.0, 0.5, 0.0],
                 rotation=_quat([0, 1, 0], 0.5), scale=[1.2, 1.2, 1.2]),
            dict(mesh=0, matrix=[float(v) for v in m2.T.reshape(-1)]),
            dict(name="hinge", translation=[0.0, -1.0, -6.0], children=[4]),
            dict(name="elbow", translation=[0.0, 1.2, 0.0]),
            dict(mesh=1, skin=0, translation=[5.0, 5.0, 5.0]),
            dict(mesh=2),
        ],
        meshes=[dict(primitives=[box_prim]), dict(primitives=[strip_prim]),
                dict(primitives=[floor_prim])],
        skins=[dict(joints=[3, 4], inverseBindMatrices=ibm_acc)],
        animations=[dict(
            channels=[dict(sampler=0, target=dict(node=4, path="rotation"))],
            samplers=[dict(input=times, output=quats,
                           interpolation="LINEAR")])],
        materials=[
            dict(pbrMetallicRoughness=dict(baseColorTexture=dict(index=0))),
            dict(pbrMetallicRoughness=dict(
                baseColorFactor=[0.9, 0.5, 0.3, 1.0])),
            dict(pbrMetallicRoughness=dict(
                baseColorFactor=[0.6, 0.7, 0.6, 1.0]),
                emissiveTexture=dict(index=0), normalTexture=dict(index=1)),
        ],
        textures=[dict(source=0), dict(source=0)],
        accessors=accessors,
        bufferViews=views,
    )
    return doc, bytes(blob), image


IMPORT_OBJ = """# a pyramid in two material groups, the sides by negative indices
mtllib pyramid.mtl
o pyramid
v -0.5 0.0 -0.5
v 0.5 0.0 -0.5
v 0.5 0.0 0.5
v -0.5 0.0 0.5
v 0.0 0.9 0.0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vt 0.5 0.5
vn 0 -1 0
g base
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
g sides
usemtl green
f -4/2 -5/1 -1/5
f -3/3 -4/2 -1/5
f -2/4 -3/3 -1/5
f -5/1 -2/4 -1/5
"""
IMPORT_MTL = """newmtl red
Kd 0.8 0.2 0.2
newmtl green
Kd 0.2 0.7 0.3
"""


def write_import_scene(directory, image=None):
    """Writes the import scene into `directory`: scene.glb (the glTF of
    import_gltf_document with its buffer and image in the BIN chunk),
    scene.gltf (the same with both as data URIs), pyramid.obj and
    pyramid.mtl. `image`: the bytes of a JPEG or WebP to embed in place of
    the scene's palette PNG; a WebP is each texture's source through the
    EXT_texture_webp extension (no core source). Returns their paths by
    kind (glb, gltf, obj)."""
    import base64
    import struct

    doc, blob, image_png = import_gltf_document()
    image = image_png if image is None else image
    mime = "image/jpeg" if image[:2] == b"\xff\xd8" else "image/png"
    if image[:4] == b"RIFF" and image[8:12] == b"WEBP":
        mime = "image/webp"
        doc = dict(doc, extensionsUsed=["EXT_texture_webp"],
                   extensionsRequired=["EXT_texture_webp"],
                   textures=[dict(extensions=dict(EXT_texture_webp=dict(
                       source=t.get("source", 0)))) for t in doc["textures"]])
    paths = {k: os.path.join(directory, f"scene.{k}")
             for k in ("glb", "gltf")}
    paths["obj"] = os.path.join(directory, "pyramid.obj")

    # .gltf: the buffer and the image as data URIs
    text = dict(doc, buffers=[dict(
        byteLength=len(blob), uri="data:application/octet-stream;base64,"
        + base64.b64encode(blob).decode())], images=[dict(
            uri=f"data:{mime};base64," + base64.b64encode(image).decode())])
    with open(paths["gltf"], "w") as f:
        json.dump(text, f)

    # .glb: the image in a buffer view of the BIN chunk
    body = bytearray(blob)
    while len(body) % 4:
        body.append(0)
    views = doc["bufferViews"] + [dict(buffer=0, byteOffset=len(body),
                                       byteLength=len(image))]
    body.extend(image)
    while len(body) % 4:
        body.append(0)
    js = json.dumps(dict(doc, bufferViews=views,
                         buffers=[dict(byteLength=len(body))],
                         images=[dict(bufferView=len(views) - 1,
                                      mimeType=mime)])).encode()
    js += b" " * (-len(js) % 4)
    glb = (struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(body), 0x004E4942) + bytes(body))
    with open(paths["glb"], "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, 12 + len(glb)) + glb)

    with open(paths["obj"], "w") as f:
        f.write(IMPORT_OBJ)
    with open(os.path.join(directory, "pyramid.mtl"), "w") as f:
        f.write(IMPORT_MTL)
    return paths


def import_world(pkg, paths, kind="glb"):
    """`pkg`'s World of the import scene: the glTF file of `kind` (glb or
    gltf) imported and instanced (GltfDocument.add_to_world, its skin
    bound), the OBJ pyramid's groups instanced at one transform, a point
    light and a rect area light. Returns (world, GltfDocument)."""
    import importlib

    from voidin_tpu_torch.core import mathx

    gltf = importlib.import_module(pkg.__name__ + ".io.gltf")
    obj = importlib.import_module(pkg.__name__ + ".io.obj")
    w = pkg.World()
    doc = gltf.GltfDocument.import_file(w, paths[kind])
    doc.add_to_world(w)
    place = np.asarray(mathx.from_translation([1.8, -1.2, -4.5])
                       @ mathx.from_rotation_y(np.float32(0.4))
                       @ mathx.from_scale(1.2), np.float32)
    for mesh_id, mat_id in obj.import_obj(w, paths["obj"]):
        w.instances.add(place, mesh_id, mat_id)
    w.lights.add_point_light([2.0, 3.0, -3.0], 15.0, [1.0, 0.95, 0.9])
    w.add_area_light([1, 1, 1], 5.0, (4.0, 3.0), np.asarray(
        mathx.from_translation([0, 4.5, -3.0])
        @ mathx.from_rotation_x(np.float32(-np.pi / 3))))
    return w, doc


def import_joint_mats(animator, frame):
    """The import scene's joint matrices at `frame`: its one skin sampled
    by `animator` (a GltfAnimator of either package) at 0.15 s a frame."""
    return animator.joint_matrices(0, 0.15 * frame)


if __name__ == "__main__":
    main()
