"""Where a frame of the PyTorch + CUDA port spends its time, on one GPU.

    python3 tools/torch_stage_split.py [--frames 10] [--presets] [--ring]

Renders the north-star frame (build_world(10_000, seed=0), 1920x1080,
capacities 2^19, moving instances, TAA), the same frame on the block path
(backend "xla", K the smallest multiple of 128 above its fullest tile)
and with slim_rec + kernel_payload, the masked frame (the north star
plus chip_smoke.add_foliage(world, 3000, seed=1), pair capacity 2^20) and
the raytraced-shadow frame of config 5 (chip_smoke.config5_preset, TLAS,
no TAA) at rt_shadow_scale 1 and 2, and config 5 with its knot a 2-joint
skin bent by a new pose each frame (config5_preset(skinned=True),
chip_smoke.knot_joint_mats) through Renderer.render, overflow 0 on
every frame, and the ring-light frame of examples/ring_light.py at
1920x1080 (its shading with the fused LTC ring kernel's call), and the
BASELINE presets 2, 4, 6 and 7 at chip_smoke.PRESET_RUNS' full sizes,
wired as chip_smoke.preset_renderer wires them (config 4 posed by its
animator; --presets renders these alone, --ring the ring-light frame
alone). The stages are the program's own frame scopes
(voidin_tpu_torch/framework/profiler.py, switched on here): each pass and
its stages (skinning and the TLAS refit; setup, binning, the fine raster
kernel and the untile; the resolve's row fetch, field evaluation and
fallback batch; the fused LTC kernel's call, the point lights, the
shadow rays' packing and walk; TAA's reprojection, history fetch and
resolve; tonemap and sRGB). Prints, per scene, each scope's device ms
(its CUDA event pair: from when the stream reaches its entry to when it
reaches its exit) and the host's syncs, a frame, the mean over the frames
after the first two, and the host-clock ms/frame. Then times the resolve
pass alone on one masked visibility buffer, three ways: as an unmasked
scene would (winner only), the lazy compacted fallback (the default) and
the dense two-pass fallback. Every number is printed with the card's name
and power limit. Needs a CUDA device.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import voidin_tpu_torch as pt  # noqa: E402
from voidin_tpu_torch.framework import renderer as renderer_mod  # noqa: E402
from voidin_tpu_torch.examples import ring_light  # noqa: E402
from voidin_tpu_torch.framework import profiler  # noqa: E402
from voidin_tpu_torch.passes import raster, resolve  # noqa: E402

# The presets split: the LOD field (2), skins with TAA and moving
# instances (4), the 108-slot texture pool (6), the unique geometry (7).
PRESET_SPLITS = (2, 4, 6, 7)


def split(label, world, moving, cfg, frames, card):
    """Renders `frames` frames of `world` at the north-star camera and
    prints each stage's median."""
    r = renderer_mod.Renderer(world.device("cuda"), cfg, moving_ids=moving)
    cam = chip_smoke.north_star_camera(pt)
    walls = []
    for i in range(frames):
        if i == 2:  # frames 1-2 warm up: drop their scopes
            profiler.collect()
        t0 = time.perf_counter()
        r.render(cam)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if int(r.aux["overflow"]):
            sys.exit(f"{label}: frame {i} overflowed")
    report(label, walls, frames, card)


def ring_split(frames, card):
    """The ring-light frame (examples/ring_light.py render) at 1920x1080,
    `frames` frames, each stage's median as split prints it."""
    scene = ring_light.ring_world().device("cuda")
    walls = []
    for i in range(frames):
        if i == 2:
            profiler.collect()
        t0 = time.perf_counter()
        with profiler.scope("frame", frame=i):
            ring_light.render(scene, chip_smoke.WIDTH, chip_smoke.HEIGHT,
                              tri_capacity=1 << 16, pair_capacity=1 << 19)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    report("ring light", walls, frames, card)


def baseline_split(n, frames, card):
    """Preset `n` at chip_smoke.PRESET_RUNS' full size, split by
    preset_split."""
    from voidin_tpu_torch.framework import presets

    preset_split(f"config {n}", presets.PRESETS[n](
        chip_smoke.WIDTH / chip_smoke.HEIGHT, **chip_smoke.PRESET_RUNS[n][0]),
        frames, card)


def preset_split(label, p, frames, card, joint_mats=None):
    """Preset `p` at 1920x1080, `frames` frames through its Renderer
    (chip_smoke.preset_renderer), frame i posed by `joint_mats(i)`, by
    default by the preset's animator at the Renderer's time (config 4's
    arms); each stage's median as split prints it."""
    r = chip_smoke.preset_renderer(
        p, p.world.device("cuda", with_tlas=p.with_tlas), chip_smoke.WIDTH,
        chip_smoke.HEIGHT)
    walls = []
    for i in range(frames):
        if i == 2:
            profiler.collect()
        t0 = time.perf_counter()
        if joint_mats is not None:
            jm = joint_mats(i)
        else:
            jm = p.animator(r.time) if p.animator else None
        r.render(p.camera, joint_mats=jm)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if int(r.aux["overflow"]):
            sys.exit(f"{label}: frame {i} overflowed")
    report(label, walls, frames, card)


def report(label, walls, frames, card):
    """Prints the frames' scopes since the last collect: each pass's
    device ms a frame with its share of the passes' sum, its stages
    indented below it, and the host's syncs a frame."""
    rows, _, n = profiler.scope_rows(profiler.collect())
    print(f"{label}: host-clock median {np.median(walls[2:]):.3f} ms/frame "
          f"over frames 3-{frames} ({card}); device ms a frame, mean of "
          f"{n} frames")
    top = sum(dev for depth, _, _, dev, *_ in rows if depth == 1)
    for depth, name, _, dev, _, syncs, _, _ in rows[1:]:
        share = f"{100 * dev / top:5.1f}%" if depth == 1 else "      "
        print(f"  {'  ' * (depth - 1) + name:34s} {dev:9.3f} ms {share} "
              f"{syncs:5.2f} syncs")
    print(f"  {'sum of passes':34s} {top:9.3f} ms")


def resolve_variants(world, cfg, card, reps):
    """The resolve pass alone on the masked frame's first visibility
    buffer: winner only, lazy fallback, dense two-pass fallback."""
    from voidin_tpu_torch.passes import cull

    scene = world.device("cuda")
    uniform = chip_smoke.north_star_camera(pt).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, uniform)
    mcfg = dataclasses.replace(cfg, alpha_mask=True)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, uniform,
                           mcfg, materials=scene.materials)
    if int(vis.overflow):
        sys.exit("the masked visibility buffer overflowed")
    plain = dataclasses.replace(vis, tri_id2=None, depth2=None)
    cases = [
        ("winner only (as unmasked)", plain, mcfg),
        ("lazy fallback (default)", vis, mcfg),
        ("dense two-pass fallback", vis,
         dataclasses.replace(mcfg, lazy_alpha_resolve=False)),
    ]
    for label, v, c in cases:
        ms = chip_smoke.time_cuda(
            lambda: resolve.resolve_gbuffer(scene, v, c), reps)
        print(f"resolve, masked {cfg.width}x{cfg.height} frame, {label}: "
              f"{ms:.3f} ms ({card})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--presets", action="store_true",
                    help="split the presets 2, 4, 6 and 7 alone")
    ap.add_argument("--ring", action="store_true",
                    help="split the ring-light frame alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = chip_smoke.card_line()
    if args.ring:
        profiler.enable()
        ring_split(args.frames, card)
        return
    if args.presets:
        profiler.enable()
        for n in PRESET_SPLITS:
            baseline_split(n, args.frames, card)
        return
    cfg = raster.RasterConfig(width=chip_smoke.WIDTH,
                              height=chip_smoke.HEIGHT,
                              tri_capacity=chip_smoke.CAP,
                              pair_capacity=chip_smoke.CAP)
    masked_cfg = dataclasses.replace(
        cfg, pair_capacity=chip_smoke.MASKED_PAIR_CAP)
    world, moving = renderer_mod.build_world(10_000, seed=0)
    masked, masked_moving = renderer_mod.build_world(10_000, seed=0)
    chip_smoke.add_foliage(masked, chip_smoke.N_FOLIAGE, seed=1)
    resolve_variants(masked, masked_cfg, card, reps=10)
    _, _, counts = chip_smoke.frame_records(world.device("cuda"), cfg)
    block_cfg = dataclasses.replace(
        cfg, backend="xla", tile_tri_capacity=chip_smoke.block_capacity(
            counts))
    slim_cfg = dataclasses.replace(cfg, slim_rec=True, kernel_payload=True)
    profiler.enable()
    for label, w, mv, c in (("north star", world, moving, cfg),
                            (f"block path (K {block_cfg.tile_tri_capacity})",
                             world, moving, block_cfg),
                            ("slim + payload", world, moving, slim_cfg),
                            ("masked", masked, masked_moving, masked_cfg)):
        split(label, w, mv, c, args.frames, card)
    for scale in (1, 2):
        preset_split(f"config 5, rt_shadow_scale {scale}",
                     dataclasses.replace(chip_smoke.config5_preset(pt),
                                         rt_shadow_scale=scale),
                     args.frames, card)
    preset_split("config 5, skinned knot",
                 chip_smoke.config5_preset(pt, skinned=True), args.frames,
                 card, joint_mats=chip_smoke.knot_joint_mats)
    ring_split(args.frames, card)
    for n in PRESET_SPLITS:
        baseline_split(n, args.frames, card)


if __name__ == "__main__":
    main()
