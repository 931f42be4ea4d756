"""Phase 20 of chip_smoke.py alone, on one GPU, and resolve op by op.

    python3 tools/torch_record_probe.py [--root DIR] [--ops N] [--skip-phase]

Builds the port's kernels, then runs chip_smoke.record_phases: the north
star at 1920x1080 under each record layout and coherent resolve
(chip_smoke.RECORD_SETS), the block path with and without
fused_resolve_rec, the masked scene's default, quad and slot frames and
the slim_rec fallback, each with its gates (overflow 0, the G-buffer
against the default frame's, K1 / K2 and the fused LTC kernel against
their twins), its median ms/frame and resolve_gbuffer's own median ms.
`--ops N` then profiles the resolve_gbuffer call of the first frame
under each set (the north star's sets, the block path, the masked
scene's lazy and two-pass fallbacks; quad and slot at phase 20's edge
capacities) with torch.profiler, three calls each, and prints the N
torch ops with the most device time a call (the kernels each launches),
the call's device busy ms (its kernels' time), kernels and wall ms
(chip_smoke.op_profile). `--root DIR`
takes voidin_tpu_torch from DIR (a parent's unpacked tree) and this
tree's chip_smoke.py. `--skip-phase` runs the profile
alone. Prints the card line last. Exits non-zero on a failed gate or
without a card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_inputs(cs, scene, cfg):
    """(scene, VisBuffer, config) that the first frame of `scene` under
    `cfg` hands resolve_gbuffer."""
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.framework.renderer import Renderer
    from voidin_tpu_torch.passes import resolve

    seen = []
    real = resolve.resolve_gbuffer

    def spy(scene_, vis, config, **kw):
        seen.append((scene_, vis, config))
        return real(scene_, vis, config, **kw)

    resolve.resolve_gbuffer = spy
    try:
        Renderer(scene, cfg).render(cs.north_star_camera(pt))
    finally:
        resolve.resolve_gbuffer = real
    return seen[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--ops", type=int, default=0)
    ap.add_argument("--skip-phase", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(2)
    import chip_smoke as cs
    from voidin_tpu_torch.framework.renderer import build_world
    from voidin_tpu_torch.ops import _build
    from voidin_tpu_torch.passes.raster import RasterConfig

    dev = torch.device("cuda:0")
    card = cs.card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: "
          f"{card}; package {os.path.abspath(args.root)}", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = RasterConfig(width=cs.WIDTH, height=cs.HEIGHT,
                       tri_capacity=cs.CAP, pair_capacity=cs.CAP)
    world, _ = build_world(10_000, seed=0)
    scene = world.device(dev)
    _, _, counts = cs.frame_records(scene, cfg)
    ns_k = cs.block_capacity(counts)
    masked_world, _ = build_world(10_000, seed=0)
    cs.add_foliage(masked_world, cs.N_FOLIAGE, seed=1)
    if not args.skip_phase:
        t0 = time.perf_counter()
        launches, _ = cs.record_phases(dev, card, masked_world, ns_k)
        print(f"phase 20 ran {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps(dict(launches=launches)))
    if args.ops:
        import dataclasses

        from voidin_tpu_torch.passes import resolve

        scenes = dict(north=scene, masked=masked_world.device(dev))
        sets = (("default", "north", {}),) + tuple(
            (label, "north", opts) for label, opts, _ in cs.RECORD_SETS) + (
            ("block path", "north",
             dict(backend="xla", tile_tri_capacity=ns_k)),
            ("masked default", "masked", {}),
            ("masked two-pass (lazy_alpha_resolve=False)", "masked",
             dict(lazy_alpha_resolve=False)))
        # each scene's first set is its default: its winner ids size the
        # quad and slot edge capacities as phase 20 sizes them
        out, sized = {}, {}
        for label, key, opts in sets:
            for opt, cap in sized.get(key, {}).items():
                if opt in opts:
                    opts = dict(opts, **cap)
            if key == "masked":
                opts = dict(opts, pair_capacity=cs.MASKED_PAIR_CAP)
            inputs = resolve_inputs(cs, scenes[key],
                                    dataclasses.replace(cfg, **opts))
            if key not in sized:
                sized[key] = cs.edge_capacities(inputs[1].tri_id)[0]
                print(f"{key}: capacities {sized[key]}", flush=True)
            out[label] = cs.op_profile(
                f"resolve, {label}",
                lambda: resolve.resolve_gbuffer(*inputs), args.ops, card)
            del inputs
        print(json.dumps(dict(resolve_ops=out)))
    print(card, flush=True)


if __name__ == "__main__":
    main()
