"""Phase 21 of chip_smoke.py alone, on one GPU: the quad-block samplers.

    python3 tools/torch_sampler_probe.py [--root DIR]

Builds the port's kernels, then runs chip_smoke.sampler_phases: config
6's World.device() ms without and with the tap-block tables, then the
north star and config 6 at 1920x1080, 12 frames each of the default
config, tap_block, taa_quad_history (einsum select), taa_quad_history +
taa_quad_where, taa_inwindow and tap_block + taa_quad_history, at edge
capacities sized from the samplers' largest edge counts, with its gates
(every frame word for word the default's, overflow 0, K1 and the fused
LTC kernel against their twins), each set's median ms/frame, resolve
and taa ms, peak memory and op profiles. `--root DIR` takes
voidin_tpu_torch from DIR (a parent's unpacked tree) and this tree's
chip_smoke.py. Prints the launches as JSON and the card line last; exits
non-zero on a failed gate or without a card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(2)
    import chip_smoke as cs
    from voidin_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    card = cs.card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: "
          f"{card}; package {os.path.abspath(args.root)}", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches, _ = cs.sampler_phases(dev, card)
    print(f"phase 21 ran {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(launches=launches)))
    print(card, flush=True)


if __name__ == "__main__":
    main()
