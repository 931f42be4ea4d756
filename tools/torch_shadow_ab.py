"""The shadow-ray kernel of two port trees on one GPU, in turns.

    python3 tools/torch_shadow_ab.py --parent DIR [--turns 3] [--frames 12]
    python3 tools/torch_shadow_ab.py --one --root DIR   (one tree, one run)

Each run imports voidin_tpu_torch from one tree (this checkout, or DIR, a
parent's unpacked tree made with `git archive`), builds its kernels, and
drives config 5 (chip_smoke.config5_preset) at 1920x1080 through that
tree's Renderer at rt_shadow_scale 1 and 2: `--frames` frames each, the
median ms a frame of frames 3 on and of its shade_raytraced call (CUDA
events; the shade stage holds the shadow kernel's launch and, in a tree
with ops/shadow_trace.py pack_rows, the per-frame repack of its tables),
then the walk kernel's device ms and the repack kernel's
(chip_smoke.device_ms: torch.profiler over 20 calls) on that frame's
shadow rays. Without `--one` it runs the parent and this tree in
subprocesses, parent, this, this, parent, ... for `--turns` pairs (at
least three alternations), prints each run's JSON line and then one line
with each tree's medians and the card's name and power limit. Needs a
CUDA device.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 1920, 1080


def one_run(root, frames):
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.ops import _build
    from voidin_tpu_torch.ops import shadow_trace as st
    from voidin_tpu_torch.passes import shading as shading_pass

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.load()
    p = cs.config5_preset(pt)
    scene = p.world.device("cuda", with_tlas=p.with_tlas)
    real = shading_pass.shade_raytraced
    events = []

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **k)
        end.record()
        events.append((start, end))
        return out

    out = dict(root=os.path.abspath(root), package=os.path.dirname(
        pt.__file__))
    for scale in (1, 2):
        r = cs.preset_renderer(dataclasses.replace(p, rt_shadow_scale=scale),
                               scene, WIDTH, HEIGHT)
        shading_pass.shade_raytraced = timed
        events.clear()
        st.LAUNCHES = 0
        frame_ms = []
        try:
            for _ in range(frames):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                r.render(p.camera)
                end.record()
                torch.cuda.synchronize()
                frame_ms.append(start.elapsed_time(end))
        finally:
            shading_pass.shade_raytraced = real
        shade_ms = [s.elapsed_time(e) for s, e in events]
        launches = st.LAUNCHES
        args, kwargs = cs.frame_shadow_rays(pt, scene, r.config, p.camera,
                                            scale)
        dev_ms = cs.device_ms(lambda: st.occluded(*args, **kwargs), 20,
                              "shadow_trace")
        # the per-frame repack's kernel, where the tree has one
        pack_ms = (cs.device_ms(lambda: st.occluded(*args, **kwargs), 20,
                                "pack_shadow_rows")
                   if hasattr(st, "pack_rows") else 0.0)
        out[f"scale{scale}"] = dict(
            frame_ms=float(np.median(frame_ms[2:])),
            shade_ms=float(np.median(shade_ms[2:])), device_ms=dev_ms,
            pack_device_ms=pack_ms, launches=launches,
            rays=int(kwargs["active"].sum()))
        del r
    out["card"] = cs.card_line()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", action="store_true")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--parent")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    if args.one:
        one_run(args.root, args.frames)
        return
    if not args.parent:
        sys.exit("--parent DIR is needed")
    order = []
    for k in range(args.turns):
        pair = [("parent", args.parent), ("change", HERE)]
        order += pair if k % 2 == 0 else pair[::-1]
    runs = {"parent": [], "change": []}
    for name, root in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--root",
             root, "--frames", str(args.frames)], capture_output=True,
            text=True, check=False)
        lines = [x for x in res.stdout.splitlines() if x.startswith("{")]
        if res.returncode or not lines:
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
            sys.exit(f"the {name} run failed")
        row = json.loads(lines[-1])
        print(json.dumps(dict(tree=name, **row)), flush=True)
        runs[name].append(row)
    summary = {}
    for name, rows in runs.items():
        summary[name] = {
            f"scale{s}": {k: float(np.median([r[f"scale{s}"][k] for r in rows
                                              if r[f"scale{s}"][k]
                                              is not None] or [np.nan]))
                          for k in ("device_ms", "pack_device_ms",
                                    "frame_ms", "shade_ms")}
            for s in (1, 2)}
    print(json.dumps(dict(summary=summary, turns=args.turns,
                          card=runs["change"][0]["card"])), flush=True)


if __name__ == "__main__":
    main()
