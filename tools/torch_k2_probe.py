"""What holds K2, the block fine raster, on the 1080p north-star blocks.

    python3 tools/torch_k2_probe.py [--root DIR] [--masked]

Bins the north-star frame (or, with --masked, the masked frame) into
(tiles, K, 16) blocks as chip_smoke.py does and prints, for the
voidin_tpu_torch package under DIR (default: this tree):
  1. how much of a tile its records cover, for the tiles of at most 64
     records and for the fuller ones: the share of records inside no pixel
     centre, the mean pixels inside per record, in how many of the
     tile's four 8x4 and four 16x2 pixel regions a record has a pixel, how
     many 8x4 regions K2's corner test lets a record into, and the tiles'
     rounds of 32 records;
  2. K2's device time (chip_smoke.device_ms) on subsets of the tiles, the
     other tiles' counts set to 0: all, the light tiles, the full tiles,
     the full tiles with their counts capped at 128, and the fullest tile
     alone.
Needs a CUDA device.
"""

import argparse
import dataclasses
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = 64


def _corner_test(blk):
    """(T, k) number of the tile's four 8x4 regions in which each record of
    `blk` (T, k, 16) passes K2's region test: every edge plane >= 0 at the
    region's corner pixel centre where it is largest."""
    import torch

    n = torch.zeros(blk.shape[:2], dtype=torch.int64, device=blk.device)
    for y0 in (0, 4):
        for x0 in (0, 8):
            ok = torch.ones_like(n, dtype=torch.bool)
            for e in (0, 3, 6):
                ax, ay, b = blk[:, :, e], blk[:, :, e + 1], blk[:, :, e + 2]
                x = torch.where(ax >= 0, x0 + 7.5, x0 + 0.5)
                y = torch.where(ay >= 0, y0 + 3.5, y0 + 0.5)
                ok &= ((ax * x + ay * y) + b) >= 0
            n += ok
    return n


def coverage(fr, blocks, counts, keep, label):
    """Coverage statistics of the valid records of the tiles in `keep`."""
    import torch

    tiles = torch.nonzero(keep & (counts > 0))[:, 0]
    px, py = fr._pixel_centres(blocks.device)
    n_rec = zero = inside_px = 0
    regions = {"8x4": 0, "16x2": 0}
    survivors = 0
    rounds = int(((counts[tiles] + 31) // 32).sum())
    lane = torch.arange(fr.TILE_PX, device=blocks.device)
    region_of = {"8x4": (lane // 16 // 4) * 2 + (lane % 16) // 8,
                 "16x2": lane // 32}
    for lo in range(0, tiles.shape[0], 64):
        t = tiles[lo:lo + 64]
        k = int(counts[t].max())
        blk = blocks[t, :k]
        valid = (torch.arange(k, device=blocks.device)[None, :]
                 < counts[t, None]) & (blk[:, :, fr.F_ID] >= 0)
        inside = fr._candidates(blk, valid, px, py) > -1.0  # (T, k, 128)
        per_rec = inside.sum(-1)[valid]
        n_rec += int(valid.sum())
        zero += int((per_rec == 0).sum())
        inside_px += int(per_rec.sum())
        survivors += int(_corner_test(blk)[valid].sum())
        for name, reg in region_of.items():
            hit = torch.stack([inside[:, :, reg == r].any(-1)
                               for r in range(4)], -1)
            regions[name] += int(hit.sum(-1)[valid].sum())
    print(f"coverage, tiles of {label} records: {tiles.shape[0]} tiles, "
          f"{n_rec} records; inside no pixel {100.0 * zero / n_rec:.1f}%; "
          f"mean pixels inside {inside_px / n_rec:.2f} of 128; regions with "
          f"a pixel inside, of 4: 8x4 {regions['8x4'] / n_rec:.2f}, 16x2 "
          f"{regions['16x2'] / n_rec:.2f}; 8x4 regions that pass the corner "
          f"test {survivors / n_rec:.2f} ({survivors} in all); rounds of 32 "
          f"records {rounds}; pixels inside in all {inside_px}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose voidin_tpu_torch is measured")
    ap.add_argument("--masked", action="store_true",
                    help="the masked frame's blocks and K2 track2")
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
    from voidin_tpu_torch.ops import fine_raster as fr
    from voidin_tpu_torch.passes.raster import RasterConfig

    _build.load()
    card = cs.card_line()
    dev = torch.device("cuda:0")
    cfg = RasterConfig(width=cs.WIDTH, height=cs.HEIGHT, tri_capacity=cs.CAP,
                       pair_capacity=cs.CAP, backend="xla",
                       tile_tri_capacity=768)
    world, _ = build_world(10_000, seed=0)
    if args.masked:
        cs.add_foliage(world, cs.N_FOLIAGE, seed=1)
        cfg = dataclasses.replace(cfg, pair_capacity=cs.MASKED_PAIR_CAP)
    print(f"K2 probe of {root}, {'masked' if args.masked else 'north-star'} "
          f"blocks ({card})", flush=True)
    blocks, counts = cs.frame_blocks(world.device(dev), cfg)
    full = counts > CUT
    coverage(fr, blocks, counts, ~full, f"<= {CUT}")
    coverage(fr, blocks, counts, full, f"> {CUT}")

    zero = torch.zeros_like(counts)
    fullest = torch.zeros_like(full)
    fullest[int(counts.argmax())] = True
    subsets = [
        ("all tiles", counts),
        (f"tiles of <= {CUT}", torch.where(full, zero, counts)),
        (f"tiles of > {CUT}", torch.where(full, counts, zero)),
        (f"tiles of > {CUT}, counts capped at 128",
         torch.where(full, counts.clamp(max=128), zero)),
        ("the fullest tile", torch.where(fullest, counts, zero)),
    ]
    for label, part in subsets:
        ms = cs.device_ms(
            lambda: fr.fine_raster_blocks(blocks, part, track2=args.masked),
            20, "fine_raster_blocks_kernel")
        print(f"K2{' track2' if args.masked else ''} on {label} "
              f"({int((part > 0).sum())} tiles, {int(part.sum())} records, "
              f"fullest {int(part.max())}): device {cs.fmt_ms(ms)}",
              flush=True)


if __name__ == "__main__":
    main()
