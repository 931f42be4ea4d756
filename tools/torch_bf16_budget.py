"""Where does the bf16 LUT frame miss tests/test_ltc.py's 1e-2 max budget?

    JAX_PLATFORMS=cpu python tools/torch_bf16_budget.py [--width 320]
        [--height 184] [--field 10000] [--cards 3000]

Renders the masked scene of chip_smoke.py (build_world(field) +
add_foliage(cards, seed=1), the north-star camera, TAA off, one frame) on
the CPU through both packages, each with its LTC LUT fetch in f32 and in
bf16 (``passes.shading.LTC_LUT_BF16``), and prints for each package the
max and mean abs sRGB diff between its bf16 and f32 frames, the pixels at
or over the 1e-2 budget, and whether the two packages miss it at the same
pixels. The JAX frame is jitted (the XLA block raster, no Pallas); the
port's runs its CPU twins. Needs both packages (jax on the CPU).
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 1e-2


def frames(pkg_name, world, cfg, cam):
    """(f32 frame, bf16 frame) of one package as numpy."""
    if pkg_name == "jax":
        from voidin_tpu.framework.renderer import Renderer
        from voidin_tpu.passes import shading

        scene = world.device()
    else:
        from voidin_tpu_torch.framework.renderer import Renderer
        from voidin_tpu_torch.passes import shading

        scene = world.device("cpu")
    out = []
    for bf16 in (False, True):
        shading.LTC_LUT_BF16 = bf16
        try:
            r = Renderer(scene, cfg, enable_taa=False)
            out.append(np.asarray(r.render(cam)).astype(np.float64))
        finally:
            shading.LTC_LUT_BF16 = False
        assert int(r.aux["overflow"]) == 0, pkg_name
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=184)
    ap.add_argument("--field", type=int, default=10_000)
    ap.add_argument("--cards", type=int, default=3000)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(4)
    import bench
    import chip_smoke
    import voidin_tpu as vt
    import voidin_tpu_torch as pt
    from voidin_tpu.passes.raster import RasterConfig as JaxConfig
    from voidin_tpu_torch.framework.renderer import build_world
    from voidin_tpu_torch.passes.raster import RasterConfig

    w, h = args.width, args.height
    # chip_smoke.py's masked capacities; the JAX block path's K covers the
    # fullest tile of this small frame
    caps = dict(width=w, height=h, tri_capacity=1 << 19,
                pair_capacity=1 << 20)
    diffs = {}
    for name in ("port", "jax"):
        if name == "jax":
            world, _ = bench.build_world(args.field, seed=0)
            cfg = JaxConfig(**caps, backend="xla", tile_tri_capacity=8192)
            cam = vt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                            aspect=w / h)
        else:
            world, _ = build_world(args.field, seed=0)
            cfg = RasterConfig(**caps)
            cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0,
                            aspect=w / h)
        chip_smoke.add_foliage(world, args.cards, seed=1)
        f32, bf16 = frames(name, world, cfg, cam)
        d = np.abs(bf16 - f32)
        diffs[name] = (d, f32)
        worst = np.unravel_index(np.argmax(d), d.shape)
        over = np.argwhere(d >= BUDGET)
        print(f"{name}: bf16 vs f32 max abs diff {d.max():.4e} at "
              f"{tuple(int(i) for i in worst)}, mean {d.mean():.3e}, "
              f"{len(over)} values >= {BUDGET} at pixels "
              f"{sorted({(int(y), int(x)) for y, x, _ in over})[:12]}",
              flush=True)
    (dp, fp), (dj, fj) = diffs["port"], diffs["jax"]
    print(f"f32 frames, port vs jax: mean abs diff {np.abs(fp - fj).mean():.3e}")
    mp = (dp >= BUDGET).any(-1)
    mj = (dj >= BUDGET).any(-1)
    print(f"pixels over budget: port {int(mp.sum())}, jax {int(mj.sum())}, "
          f"both {int((mp & mj).sum())}")


if __name__ == "__main__":
    main()
