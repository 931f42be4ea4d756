"""Phase 17 of chip_smoke.py alone, on the GPUs of one host.

    python3 tools/torch_shard_probe.py [--root DIR] [--cards-only] [--busy]

Builds the port's kernels, then runs chip_smoke.shard_phases: the
row-sharded north star at 1920x1088 (unsharded, 2 and 4 slabs on the
first card, and 2 and 4 cards where that many are visible; every frame
word for word the unsharded one, each slab's K1 and fused LTC launch
against its twin, per-slab K1 device ms), config 5 raytraced on 2 slabs,
the debug_bounds checks and area_light_scale=2. Prints the card line and
the launches and the area_light_scale fused-kernel row as JSON. `--root
DIR` takes voidin_tpu_torch from DIR (a parent's unpacked tree) and this
tree's chip_smoke.py. `--cards-only` (a host with 2 or 4 cards) runs
the north star alone, unsharded and on the real cards. `--busy` first
prints the device busy share of the north star unsharded and on 2 and 4
slabs of the first card (busy_share). Exits non-zero on a failed gate or
without a card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_share(render, frames=3):
    """Device busy share of `frames` calls of render(): the union of the
    CUDA kernel and copy intervals in a torch.profiler trace over the host
    wall time of the calls (each ended by a synchronize). Returns (busy
    ms, wall ms) per frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6 / frames, wall / frames


def busy_phase(cs, dev, card):
    """The north star at 1920x1088 unsharded and on 2 and 4 slabs of one
    card: device busy ms, wall ms and their ratio a frame."""
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework.renderer import Renderer, build_world
    from voidin_tpu_torch.parallel import sharding as sh
    from voidin_tpu_torch.passes.raster import RasterConfig

    world, moving = build_world(10_000, seed=0)
    cfg = RasterConfig(width=cs.WIDTH, height=cs.SHARD_HEIGHT,
                       tri_capacity=cs.CAP, pair_capacity=cs.SHARD_PAIR_CAP)
    cam = pt.Camera(position=[0.0, 2.0, 30.0], yaw=0.0, pitch=-5.0,
                    aspect=cs.WIDTH / cs.SHARD_HEIGHT)
    for n in (1, 2, 4):
        mesh = None if n == 1 else sh.make_mesh(devices=[dev] * n)
        r = Renderer(world.device(dev), cfg, moving_ids=moving, mesh=mesh)
        for _ in range(3):
            r.render(cam)
        busy, wall = busy_share(lambda: r.render(cam))
        print(f"device busy, north star {cs.WIDTH}x{cs.SHARD_HEIGHT} on {n} "
              f"slab(s): {busy:.3f} ms busy of {wall:.3f} ms wall a frame "
              f"({100 * busy / wall:.1f}%) ({card})", flush=True)
        del r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cards-only", action="store_true")
    ap.add_argument("--busy", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(2)
    import chip_smoke as cs
    from voidin_tpu_torch.ops import _build

    card = cs.card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: "
          f"{card}; package {os.path.abspath(args.root)}", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.busy:
        busy_phase(cs, torch.device("cuda:0"), card)
    t0 = time.perf_counter()
    launches, row = cs.shard_phases(torch.device("cuda:0"), card,
                                    cards_only=args.cards_only)
    print(f"phase 17 ran {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(launches=launches, ltc_rect_area_scale_2=row)))
    print(card, flush=True)


if __name__ == "__main__":
    main()
