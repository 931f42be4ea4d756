"""Sizes a cell's raster capacities: renders `--frames` frames of the
cell's traffic (one lap of a loop) through the port's Renderer on the
card and prints, per frame and as maxima, the draws, the live triangle
work items (with the near-clipped extras), the (triangle, tile) pairs
beyond each triangle's first tile and the fullest tile, beside the
configuration's capacities.

    python3 portbench/sweep.py --workload northstar.fly --seed 1 \
        --frames 240
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args()

    import torch

    import run
    from pb import animation, configs, program, traffic
    from voidin_tpu_torch.passes import raster

    if not torch.cuda.is_available():
        run.die("no CUDA device", 2)
    cell, _ = run.load_cell(args.workload)
    config = configs.load(cell["config"])
    scene = configs.build_scene(config, args.seed)
    path = traffic.CameraPath(traffic.load(cell["traffic"]), config,
                              animation.period(scene))
    r = program.make_renderer(config, scene, "cuda")
    joints = run.joint_table(scene, path, "cuda")
    seen = {}
    real_setup, real_bin = raster.triangle_setup, raster.bin_triangles_pairs

    def setup(*a, **k):
        s = real_setup(*a, **k)
        seen["live"] = s["alive"].sum()
        seen["setup_overflow"] = s["setup_overflow"]
        return s

    def binning(setup_, cfg, *a, **k):
        out = real_bin(setup_, cfg, *a, **k)
        counts = out[2]
        seen["pairs"] = counts.sum()
        seen["fullest_tile"] = counts.max()
        seen["bin_overflow"] = out[3]
        return out

    raster.triangle_setup, raster.bin_triangles_pairs = setup, binning
    rows = []
    try:
        for f in range(args.frames):
            pos, yaw, pitch = path.pose(f)
            pose = {} if joints is None else {
                "joint_mats": joints[f % len(joints)]}
            r.render(program.camera((pos, yaw, pitch), config["width"],
                                    config["height"]), dt=path.dt, **pose)
            row = {k: int(v) for k, v in seen.items()}
            row["draws"] = int(r.aux["draw_count"])
            row["overflow"] = int(r.aux["overflow"])
            rows.append(row)
    finally:
        raster.triangle_setup, raster.bin_triangles_pairs = real_setup, \
            real_bin
    worst = {k: max(row[k] for row in rows) for k in rows[0]}
    print(json.dumps({"workload": args.workload, "frames": args.frames,
                      "max": worst, "capacities": config["raster"],
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
