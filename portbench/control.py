"""The check's two readings for a cell, on the card at the cell's size:
over each seed, the sound program's numbers (pb/check.py, as a run
compares them) and the precision control's: the plain reference put in
the program's place and computed in bfloat16 (the nearest precision
below the float32 that the configurations state), rendering the same
frames from the same inputs by the check's rules (pb/check.py
render_frames: its own TAA chain to the window's first frame, a later
frame from the program's history). The runs of run.py never run this.

    python3 portbench/control.py --workload northstar.static \
        --seeds 1,2,3 --frames 40

Per seed it renders frame 0, the traffic's warm-up frames and a short
window of --frames frames, keeps the frames a run of that seed would
compare, and prints one JSON line: seed, sound, control (each number's
largest reading over the compared frames).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell, seed, frames, device):
    import torch

    import run
    from pb import animation, check, configs, program, traffic

    config = configs.load(cell["config"])
    mix = traffic.load(cell["traffic"])
    scene = configs.build_scene(config, seed)
    path = traffic.CameraPath(mix, config, animation.period(scene))
    loop = run.Frames(program.make_renderer(config, scene, device), path,
                      config, run.joint_table(scene, path, device))
    loop.reserve([0])
    loop.one()
    for _ in range(int(mix["warmup_frames"])):
        loop.one()
    loop.reserve(check.sample_frames(seed, loop.next, frames,
                                     int(mix["check_frames"])))
    for _ in range(frames):
        loop.one()
    failed, kept = loop.failed, loop.kept
    del loop
    if device == "cuda":
        torch.cuda.empty_cache()
    sound = check.reference_numbers(config, path, scene, kept, device)
    from reference.render import Reference

    ctl = Reference(scene, config, device, dtype=torch.bfloat16)
    ctl_kept = check.render_frames(ctl, path, config, kept, scene)
    del ctl
    control = check.reference_numbers(config, path, scene, ctl_kept, device)
    worst = {}
    for tag, per_frame in (("sound", sound), ("control", control)):
        worst[tag] = {n: max(v[n] for v in per_frame.values())
                      for n in check.NUMBERS}
    return dict(seed=seed, failed=failed, frames=sorted(kept), **worst)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import run

    if args.device == "cuda" and not torch.cuda.is_available():
        run.die("no CUDA device", 2)
    cell, _ = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, seed, args.frames, args.device)
        row["workload"] = args.workload
        if args.device == "cuda":
            row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
