"""Chip smoke test of the PyTorch + CUDA port (voidin_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a), then:
  1. prints torch's version and the card's name and power limit;
  2. K1 (fine raster) against its PyTorch twin on the records of the
     north-star frame itself: depth and id must be identical;
  3. K3 (LTC LUT fetch) against its twin on 5 random 64x64 tables at
     1920x1080 random uvs plus the corner uvs: max abs diff <= 1e-6;
  4. the golden deferred scene at 160x96 on the card against the checked-in
     golden image (tests/golden/deferred.png, mean abs diff < 5e-3, the
     golden tests' budget) and against the port's CPU render;
  5. the north-star frame: build_world(10_000, seed=0) at 1920x1080 with
     raster capacities 2^19, moving instances and TAA, for 12 frames
     through Renderer.render; overflow 0 on every frame, a finite image
     with variance, and K1 / K3 launched 1 / 5 times per frame. Prints the
     median ms/frame of frames 3-12 (CUDA events).
Prints the kernel table as one JSON line, then the card line, then the
result line {"ok": true, "device": {...}}. Exits non-zero on any failure
and when no CUDA device is available.
"""

import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

FRAMES = 12
WIDTH, HEIGHT = 1920, 1080
CAP = 1 << 19
K3_TOL = 1e-6
GOLDEN_BUDGET = 5e-3


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


def read_png_rgb(path):
    """(H, W, 3) uint8 from an 8-bit RGB/RGBA non-interlaced PNG."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    i, idat = 8, b""
    while i < len(data):
        n = struct.unpack(">I", data[i:i + 4])[0]
        kind = data[i + 4:i + 8]
        body = data[i + 8:i + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype, _c, _f, interlace = struct.unpack(
                ">IIBBBBB", body)
            assert depth == 8 and ctype in (2, 6) and interlace == 0
            bpp = 3 if ctype == 2 else 4
        elif kind == b"IDAT":
            idat += body
        i += 12 + n
    raw = zlib.decompress(idat)
    stride = w * bpp
    img = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride,
                             y * (stride + 1) + 1).astype(np.int32)
        out = np.zeros(stride, np.int32)
        for x in range(stride):
            a = out[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if f == 0:
                p = 0
            elif f == 1:
                p = a
            elif f == 2:
                p = b
            elif f == 3:
                p = (a + b) // 2
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[x] = (line[x] + p) & 0xFF
        img[y] = out
        prev = out
    return img.reshape(h, w, bpp)[..., :3].astype(np.uint8)


def time_cuda(fn, reps):
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


def north_star_camera(pt):
    return pt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                     aspect=WIDTH / HEIGHT)


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              flush=True)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework.renderer import Renderer, build_world
    from voidin_tpu_torch.ops import _build
    from voidin_tpu_torch.ops import fine_raster as fr
    from voidin_tpu_torch.ops import lut_fetch as lf
    from voidin_tpu_torch.passes import cull, raster
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

    # --- north-star scene and its first frame's binned records ----------
    t0 = time.perf_counter()
    world, moving = build_world(10_000, seed=0)
    scene = world.device(dev)
    print(f"north-star scene built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = RasterConfig(width=WIDTH, height=HEIGHT, tri_capacity=CAP,
                       pair_capacity=CAP)
    cam = north_star_camera(pt)
    uniform = cam.uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, uniform)
    setup = raster.triangle_setup(scene.meshes, scene.instances, draws,
                                  uniform, cfg, materials=scene.materials)
    rec_sorted, starts, counts, ovf = raster.bin_triangles_pairs(setup, cfg)
    print(f"north-star records: draws {int(draws.count)} pair slots "
          f"{rec_sorted.shape[0]} tiles {starts.shape[0]} overflow "
          f"{int(ovf) + int(setup['setup_overflow'])}", flush=True)

    # --- K1 vs twin -----------------------------------------------------
    kd, ki = fr.fine_raster_pairs(rec_sorted, starts, counts)
    rd, ri = fr.fine_raster_pairs_reference(rec_sorted, starts, counts)
    torch.cuda.synchronize()
    k1_mismatch = int(((kd != rd) | (ki != ri)).sum())
    k1_err = float((kd - rd).abs().max())
    k1_ms = time_cuda(lambda: fr.fine_raster_pairs(rec_sorted, starts,
                                                   counts), 20)
    k1_plain_ms = time_cuda(lambda: fr.fine_raster_pairs_reference(
        rec_sorted, starts, counts), 3)
    print(f"K1 fine_raster_pairs: mismatched pixels {k1_mismatch} of "
          f"{kd.numel()}, max |depth diff| {k1_err}, kernel {k1_ms:.4f} ms, "
          f"twin {k1_plain_ms:.4f} ms ({card})", flush=True)
    if k1_mismatch:
        fail("K1 disagrees with its twin")

    # --- K3 vs twin -----------------------------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)
    tables = [torch.randn(64, 64, generator=g).to(dev) for _ in range(5)]
    uv = torch.rand(HEIGHT, WIDTH, 2, generator=g).to(dev)
    uv = uv * (63.0 / 64.0) + 0.5 / 64.0
    corners = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]],
                           device=dev) * (63.0 / 64.0) + 0.5 / 64.0
    k3_err = 0.0
    for u in (uv, corners):
        got = lf.lut_fetch(tables, u)
        want = lf.lut_fetch_reference(tables, u)
        for a, b in zip(got, want):
            k3_err = max(k3_err, float((a - b).abs().max()))
    k3_ms = time_cuda(lambda: lf.lut_fetch(tables, uv), 50)
    k3_plain_ms = time_cuda(lambda: lf.lut_fetch_reference(tables, uv), 10)
    print(f"K3 lut_fetch (5 tables, {HEIGHT}x{WIDTH}): max abs diff "
          f"{k3_err}, kernel {k3_ms:.4f} ms, twin {k3_plain_ms:.4f} ms "
          f"({card})", flush=True)
    if not k3_err <= K3_TOL:
        fail(f"K3 disagrees with its twin beyond {K3_TOL}")

    # --- golden scene: card vs golden image and vs the CPU twins --------
    gw, gh = 160, 96
    gcfg = RasterConfig(width=gw, height=gh, tri_capacity=1 << 16,
                        pair_capacity=1 << 17)
    gcam = dict(position=[0, 2, 0], pitch=-18.0, aspect=gw / gh)
    imgs = {}
    for d in (dev, torch.device("cpu")):
        r = Renderer(golden_scene(pt).device(d), gcfg, enable_taa=False)
        imgs[d.type] = r.render(pt.Camera(**gcam)).cpu().numpy()
        if int(r.aux["overflow"]):
            fail("golden scene overflowed")
    want = read_png_rgb(os.path.join(root, "tests", "golden",
                                     "deferred.png")) / 255.0
    gold_diff = float(np.abs(np.clip(imgs["cuda"], 0, 1) - want).mean())
    cpu_diff = float(np.abs(imgs["cuda"] - imgs["cpu"]).mean())
    print(f"golden deferred 160x96 on the card: mean abs diff vs "
          f"tests/golden/deferred.png {gold_diff:.6f} (budget "
          f"{GOLDEN_BUDGET}), vs the CPU twins {cpu_diff:.3e}", flush=True)
    if not (np.isfinite(imgs["cuda"]).all() and gold_diff < GOLDEN_BUDGET
            and cpu_diff < GOLDEN_BUDGET):
        fail("golden scene render disagrees")

    # --- the north-star frame through the Renderer ----------------------
    del setup, rec_sorted, starts, counts, kd, ki, rd, ri
    scene = world.device(dev)  # fresh instance transforms
    r = Renderer(scene, cfg, moving_ids=moving)
    cam = north_star_camera(pt)
    fr.LAUNCHES = 0
    lf.LAUNCHES = 0
    times, img = [], None
    for i in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = r.render(cam)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        aux = {k: int(v) for k, v in r.aux.items() if v.numel() == 1}
        print(f"frame {i}: {times[-1]:.3f} ms draws {aux['draw_count']} "
              f"overflow {aux['overflow']} coverage {aux['vis_coverage']}",
              flush=True)
        if aux["overflow"] != 0:
            fail(f"frame {i} overflowed")
        if aux["vis_coverage"] <= 0:
            fail(f"frame {i} has no visible pixel")
    k1_launches, k3_launches = fr.LAUNCHES, lf.LAUNCHES
    out = img.cpu().numpy()
    if out.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(out).all():
        fail(f"frame image bad: shape {out.shape}")
    if not out.std() > 0:
        fail("frame image has no variance")
    if k1_launches != FRAMES or k3_launches != 5 * FRAMES:
        fail(f"kernel launches K1 {k1_launches} K3 {k3_launches}, expected "
             f"{FRAMES} and {5 * FRAMES}")
    ms = float(np.median(times[2:]))
    print(f"north-star frame 1920x1080: median {ms:.3f} ms/frame over "
          f"frames 3-{FRAMES} ({card}); image mean {out.mean():.4f} std "
          f"{out.std():.4f}; launches K1 {k1_launches} K3 {k3_launches}",
          flush=True)

    kernels = [
        dict(name="fine_raster_pairs", route="cuda",
             source="voidin_tpu_torch/csrc/fine_raster.cu",
             replaces="voidin_tpu/ops/fine_raster.py:113",
             launches=k1_launches, max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms),
        dict(name="lut_fetch", route="cuda",
             source="voidin_tpu_torch/csrc/lut_fetch.cu",
             replaces="voidin_tpu/ops/lut_fetch.py:43",
             launches=k3_launches, max_abs_err=k3_err, ms=k3_ms,
             plain_ms=k3_plain_ms),
    ]
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


if __name__ == "__main__":
    main()
