"""The raytraced-shadow phases of chip_smoke.py alone, on one GPU.

    python3 tools/torch_rt_probe.py [--root DIR]

Builds the port's kernels (nvcc, printing -Xptxas -v), then runs
chip_smoke.rt_phases: the golden rt_shadows scene on the card, the
shadow-ray kernel against its twin on the adversarial ray sets, and the
config-5 frame at 1920x1080 at rt_shadow_scale 1 and 2 (12 frames each)
with the kernel against its twin on each scale's rays, timed, and the
packing kernel against its twin. Prints the card line and the rows as
JSON. `--root DIR` takes
voidin_tpu_torch from DIR (a parent's unpacked tree) and this tree's
chip_smoke.py. Exits non-zero on a failed gate or without a card.
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

    card = cs.card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: "
          f"{card}; package {os.path.abspath(args.root)}", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    row, pack_row, launches = cs.rt_phases(torch.device("cuda:0"), card)
    print(json.dumps(dict(shadow_trace=row, shadow_pack=pack_row,
                          launches=launches)))
    print(card, flush=True)


if __name__ == "__main__":
    main()
