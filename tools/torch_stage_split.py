"""Where a frame of the PyTorch + CUDA port spends its time, on one GPU.

    python3 tools/torch_stage_split.py [--frames 10]

Renders the north-star frame (build_world(10_000, seed=0), 1920x1080,
capacities 2^19, moving instances, TAA), the same frame on the block path
(backend "xla", K the smallest multiple of 128 above its fullest tile)
and with slim_rec + kernel_payload, the masked frame (the north star
plus chip_smoke.add_foliage(world, 3000, seed=1), pair capacity 2^20) and
the raytraced-shadow frame of config 5 (chip_smoke.config5_world, TLAS,
no TAA) at rt_shadow_scale 1 and 2, and config 5 with its knot a 2-joint
skin bent by a new pose each frame (config5_world(skinned=True),
chip_smoke.knot_joint_mats) through Renderer.render, overflow 0 on
every frame, with CUDA events around each pass of render_frame (the skin
stage, apply_skins with its BLAS refit, and the TLAS refit), and the
ring-light frame of examples/ring_light.py at 1920x1080 (its shading with
K3's call and the three disk evaluations), around
the resolve's per-pixel field evaluations (the dense (H, W) pass and the
flat fallback batch), around the fused LTC kernel's call inside shade and
around the shadow-ray kernel's call inside shade_raytraced (the ray
setup and the per-light shading are the rest of that pass). Prints, per scene, the
median ms of each stage over the frames after the first two, and the
host-clock ms/frame. Then times the resolve pass alone on one masked visibility buffer, three ways: as an unmasked
scene would (winner only), the lazy compacted fallback (the default) and
the dense two-pass fallback. Every number is printed with the card's name
and power limit. Needs a CUDA device.
"""

import argparse
import collections
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
from voidin_tpu_torch.ops import fine_raster as fr  # noqa: E402
from voidin_tpu_torch.ops import lut_fetch  # noqa: E402
from voidin_tpu_torch.ops import ltc_rect  # noqa: E402
from voidin_tpu_torch.ops import shadow_trace  # noqa: E402
from voidin_tpu_torch.passes import raster, resolve  # noqa: E402

STAGES = [
    (renderer_mod.update_pass, "compute_update", "update"),
    (renderer_mod.skin_mod, "apply_skins", "skin"),
    (renderer_mod.skin_mod, "refit_blas", "  BLAS refit"),
    (renderer_mod.skin_mod, "refit_tlas", "TLAS refit"),
    (renderer_mod.cull_pass, "emit_draws", "cull + LOD"),
    (raster, "rasterize", "raster"),
    (raster, "triangle_setup", "  triangle setup"),
    (raster, "bin_triangles_pairs", "  binning"),
    (raster, "bin_triangles", "  block binning"),
    (raster, "_pair_payload_stream", "  payload stream"),
    (fr, "fine_raster_pairs", "  fine raster K1"),
    (fr, "fine_raster_blocks", "  fine raster K2"),
    (raster, "_untile_payload", "  payload untile"),
    (resolve, "resolve_gbuffer", "resolve"),
    (resolve, "_pixel_fields", "  resolve fields"),
    (renderer_mod.shading_pass, "shade", "shade"),
    (ltc_rect, "ltc_rect_terms", "  LTC rect, fused kernel"),
    (renderer_mod.shading_pass, "shade_raytraced", "shade, raytraced"),
    (shadow_trace, "occluded", "  shadow rays, kernel"),
    (renderer_mod.shading_pass, "shade_ring_light", "shade, ring light"),
    (renderer_mod.shading_pass, "ltc_matrix", "  LTC matrix"),
    (lut_fetch, "lut_fetch", "    K3 LUT fetch"),
    (renderer_mod.shading_pass, "ltc_evaluate_disk",
     "  disk evaluation, each of 3"),
    (renderer_mod.taa_pass, "taa", "taa"),
    (renderer_mod.post_pass, "postprocess", "postprocess"),
    (ring_light, "postprocess", "postprocess"),
]
EVENTS = collections.defaultdict(list)


def instrument():
    """Wrap each stage function so that every call records a CUDA event
    pair under its label; resolve's field passes are told apart by the
    shape they run on (the dense (H, W) image or the flat batch)."""
    for mod, fn_name, label in STAGES:
        fn = getattr(mod, fn_name)

        def timed(*a, _fn=fn, _label=label, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*a, **k)
            end.record()
            name = _label
            if _label == "  resolve fields":
                name += " (H, W)" if a[2].dim() == 2 else " (flat batch)"
            EVENTS[name].append((start, end))
            return out

        setattr(mod, fn_name, timed)


def split(label, world, moving, cfg, frames, card, cam=None,
          joint_mats=None, **options):
    """Renders `frames` frames with Renderer(**options) at `cam` (default
    the north-star camera), frame i posed by `joint_mats(i)`, and prints
    each stage's median."""
    EVENTS.clear()
    scene = world.device("cuda",
                         with_tlas=options.get("enable_rt_shadows", False))
    r = renderer_mod.Renderer(scene, cfg, moving_ids=moving, **options)
    cam = cam or chip_smoke.north_star_camera(pt)
    walls = []
    for i in range(frames):
        if i == 2:  # frames 1-2 warm up: drop their events
            EVENTS.clear()
        t0 = time.perf_counter()
        r.render(cam, joint_mats=None if joint_mats is None
                 else joint_mats(i))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if int(r.aux["overflow"]):
            sys.exit(f"{label}: frame {i} overflowed")
    report(label, walls, frames, card)


def ring_split(frames, card):
    """The ring-light frame (examples/ring_light.py render) at 1920x1080,
    `frames` frames, each stage's median as split prints it."""
    EVENTS.clear()
    scene = ring_light.ring_world().device("cuda")
    walls = []
    for i in range(frames):
        if i == 2:
            EVENTS.clear()
        t0 = time.perf_counter()
        ring_light.render(scene, chip_smoke.WIDTH, chip_smoke.HEIGHT,
                          tri_capacity=1 << 16, pair_capacity=1 << 19)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    report("ring light", walls, frames, card)


def report(label, walls, frames, card):
    ms = {k: float(np.median([s.elapsed_time(e) for s, e in v]))
          for k, v in EVENTS.items()}
    print(f"{label}: host-clock median {np.median(walls[2:]):.3f} ms/frame "
          f"over frames 3-{frames} ({card})")
    top = sum(v for k, v in ms.items() if not k.startswith(" "))
    order = [lab for _, _, lab in STAGES]
    for k in sorted(ms, key=lambda k: order.index(k.split(" (")[0])
                    if k.split(" (")[0] in order else len(order)):
        share = "" if k.startswith(" ") else f"{100 * ms[k] / top:5.1f}%"
        print(f"  {k:34s} {ms[k]:9.3f} ms {share}")
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = chip_smoke.card_line()
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
    instrument()
    for label, w, mv, c in (("north star", world, moving, cfg),
                            (f"block path (K {block_cfg.tile_tri_capacity})",
                             world, moving, block_cfg),
                            ("slim + payload", world, moving, slim_cfg),
                            ("masked", masked, masked_moving, masked_cfg)):
        split(label, w, mv, c, args.frames, card)
    rt_cfg = dataclasses.replace(cfg, tri_capacity=1 << 17)
    rt_cam = pt.Camera(**chip_smoke.CONFIG5_CAMERA,
                       aspect=cfg.width / cfg.height)
    for scale in (1, 2):
        split(f"config 5, rt_shadow_scale {scale}", chip_smoke.config5_world(
            pt), None, rt_cfg, args.frames, card, cam=rt_cam,
            enable_taa=False, enable_rt_shadows=True, rt_shadow_scale=scale)
    split("config 5, skinned knot", chip_smoke.config5_world(
        pt, skinned=True), None, rt_cfg, args.frames, card, cam=rt_cam,
        joint_mats=chip_smoke.knot_joint_mats, enable_taa=False,
        enable_rt_shadows=True)
    ring_split(args.frames, card)


if __name__ == "__main__":
    main()
