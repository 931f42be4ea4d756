"""The ring-light frame of a port tree on one GPU, for before / after runs.

    python3 tools/torch_ring_frame.py [--root DIR] [--frames 12]

Imports voidin_tpu_torch from DIR (default this checkout), renders the
ring_light example's scene (examples/ring_light.py render, capacities
2^16 / 2^19) at 1920x1080 for `--frames` frames and prints one JSON line:
the median ms/frame of frames 3 on (CUDA events around each render call,
which ends in a host read of the overflow count) and the median ms of its
shade_ring_light call, with the launch counts of the package's kernels
over those frames, the tree and the card's name and power limit. Run a
parent tree and this one alternately in one card call to compare them.
Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from voidin_tpu_torch.examples import ring_light
    from voidin_tpu_torch.ops import fine_raster, lut_fetch
    from voidin_tpu_torch import ops

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    counters = {"k1": (fine_raster, "LAUNCHES"),
                "k3": (lut_fetch, "LAUNCHES")}
    try:
        from voidin_tpu_torch.ops import ltc_ring
        counters["ltc_ring"] = (ltc_ring, "LAUNCHES")
    except ImportError:  # a tree from before the fused ring kernel
        pass
    shading = ring_light.shading
    real = shading.shade_ring_light
    shade_events = []

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **k)
        end.record()
        shade_events.append((start, end))
        return out

    shading.shade_ring_light = timed
    scene = ring_light.ring_world().device("cuda")
    caps = dict(tri_capacity=1 << 16, pair_capacity=1 << 19)
    for m, a in counters.values():
        setattr(m, a, 0)
    frame_ms = []
    for _ in range(args.frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ring_light.render(scene, 1920, 1080, **caps)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    shade_ms = [s.elapsed_time(e) for s, e in shade_events]
    print(json.dumps(dict(
        root=os.path.abspath(args.root), package=os.path.dirname(
            ops.__file__), frames=args.frames,
        frame_ms=float(np.median(frame_ms[2:])),
        shade_ms=float(np.median(shade_ms[2:])),
        launches={k: getattr(m, a) for k, (m, a) in counters.items()},
        card=card)), flush=True)


if __name__ == "__main__":
    main()
