"""Kernel times of a checkout of the PyTorch + CUDA port, on one GPU.

    python3 tools/torch_kernel_times.py [--root DIR]

Runs this tree's chip_smoke.kernel_phases against the voidin_tpu_torch
package under DIR (default: this tree), so that another commit, unpacked
with `git archive` into a git-ignored directory, is measured by the same
code as this one: every kernel of that package against its twin on its
1080p inputs, with its call time (CUDA events, wrapper included), its
device time (torch.profiler, the kernel alone) and its bound; the fused
LTC kernel's phases (chip_smoke.ltc_rect_phases) where that package has
ops/ltc_rect.py. Prints the phase lines, then one JSON line {"root": DIR, "card": ..., "kernels":
{...}}. Needs a CUDA device.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose voidin_tpu_torch is measured")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from voidin_tpu_torch.framework.renderer import build_world
    from voidin_tpu_torch.ops import _build
    from voidin_tpu_torch.passes.raster import RasterConfig

    _build.load()
    card = cs.card_line()
    cfg = RasterConfig(width=cs.WIDTH, height=cs.HEIGHT, tri_capacity=cs.CAP,
                       pair_capacity=cs.CAP)
    masked_cfg = dataclasses.replace(cfg, pair_capacity=cs.MASKED_PAIR_CAP)
    world, _ = build_world(10_000, seed=0)
    masked, _ = build_world(10_000, seed=0)
    cs.add_foliage(masked, cs.N_FOLIAGE, seed=1)
    print(f"kernels of {root} ({card})", flush=True)
    dev = torch.device("cuda:0")
    rows, _, _, masked_scene = cs.kernel_phases(dev, card, world, masked, cfg,
                                                masked_cfg)
    if importlib.util.find_spec("voidin_tpu_torch.ops.ltc_rect"):
        cs.ltc_rect_phases(dev, card, rows, world, masked_scene, cfg,
                           masked_cfg)
    print(json.dumps({"root": root, "card": card, "kernels": rows}),
          flush=True)


if __name__ == "__main__":
    main()
