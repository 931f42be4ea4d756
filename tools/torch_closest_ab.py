"""The closest-hit kernel of several port trees on one GPU, in turns.

    python3 tools/torch_closest_ab.py --parent DIR [--step NAME=DIR ...]
        [--turns 3] [--profile]
    python3 tools/torch_closest_ab.py --one --root DIR [--profile]
        (one tree, one run)

Each run imports voidin_tpu_torch from one tree (this checkout, or DIR, a
parent's unpacked tree made with `git archive`), builds its kernels, and
traces both scenes of chip_smoke.closest_phases at 1920x1080: the
bvh_trace example's (12 instances) and config 5's (41 instances, its
camera). For each it prints the kernel's device ms (chip_smoke.device_ms:
torch.profiler over 20 calls) and call ms (CUDA events over 20 calls),
called as examples/bvh_trace.trace calls it (with the rays' row width
where the tree's closest_hit takes one), the
wall ms of examples/bvh_trace.trace (host clock around a synchronised
call, median of 5) and its parts: the primary rays made on the host, their
copy to the card, scene_rays and the kernel's call, each synchronised. A
digest of each scene's t and visit words lets the summary check that every
tree gives the same result. With `--profile` a run also prints
chip_smoke.closest_walk_profile (pops a ray, the share of pops that miss,
device ms on the longest walks, registers and occupancy; the twin's walk
counts, ~3 s a scene). Without `--one` it runs the parent, each `--step`
tree and this tree in subprocesses, forwards then backwards in turns, for
`--turns` rounds (at least three alternations), prints each run's JSON
line and then one line with each tree's medians and the card's name and
power limit. Needs a CUDA device.
"""

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 1920, 1080
KEYS = ("device_ms", "call_ms", "trace_ms", "rays_ms", "copy_ms",
        "tables_ms", "kernel_ms")


def _wall(fn, reps=5):
    """Median host ms of `reps` calls of `fn`, each ended by a sync."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def one_run(root, profile):
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.examples import bvh_trace
    from voidin_tpu_torch.ops import _build
    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.rt import traverse

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.load()
    dev = torch.device("cuda")
    c5 = cs.config5_preset(pt)
    out = dict(root=os.path.abspath(root),
               package=os.path.dirname(pt.__file__))
    for key, world, camera in (
            ("bvh_trace", bvh_trace.trace_world(), None),
            ("config5", c5.world, dict(position=c5.camera.position,
                                       yaw=c5.camera.yaw,
                                       pitch=c5.camera.pitch))):
        scene = world.device(dev, with_tlas=True)
        o, d = bvh_trace.primary_rays(WIDTH, HEIGHT, camera)
        args = traverse.scene_rays(scene) + (torch.from_numpy(o).to(dev),
                                             torch.from_numpy(d).to(dev))
        kwargs = dict(t_max=bvh_trace.T_MAX)
        if "width" in inspect.signature(ch.closest_hit).parameters:
            kwargs["width"] = WIDTH  # as examples/bvh_trace.trace calls it

        def kernel():
            return ch.closest_hit(*args, **kwargs)

        res = kernel()
        torch.cuda.synchronize()
        digest = hashlib.sha256(res.t.cpu().numpy().tobytes()
                                + res.visits.cpu().numpy().tobytes())
        row = dict(
            device_ms=cs.device_ms(kernel, 20, "closest_hit"),
            call_ms=cs.time_cuda(kernel, 20),
            trace_ms=_wall(lambda: bvh_trace.trace(scene, WIDTH, HEIGHT,
                                                   camera)),
            rays_ms=_wall(lambda: bvh_trace.primary_rays(WIDTH, HEIGHT,
                                                         camera)),
            copy_ms=_wall(lambda: (torch.from_numpy(o).to(dev),
                                   torch.from_numpy(d).to(dev))),
            tables_ms=_wall(lambda: traverse.scene_rays(scene)),
            kernel_ms=_wall(kernel),
            digest=digest.hexdigest()[:16],
            max_pops=int(res.visits.max()))
        if profile:
            _, counts = traverse.closest_hit_reference(
                *args, **cs.twin_kwargs(kwargs))
            row["walk"] = cs.closest_walk_profile(args, kwargs, res.visits,
                                                  counts, key, cs.card_line())
        out[key] = row
    out["card"] = cs.card_line()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", action="store_true")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--parent")
    ap.add_argument("--step", action="append", default=[],
                    help="NAME=DIR, a tree timed between parent and change")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.one:
        one_run(args.root, args.profile)
        return
    if not args.parent:
        sys.exit("--parent DIR is needed")
    trees = [("parent", args.parent)]
    trees += [tuple(s.split("=", 1)) for s in args.step]
    trees.append(("change", HERE))
    order = []
    for k in range(args.turns):
        order += trees if k % 2 == 0 else trees[::-1]
    runs = {name: [] for name, _ in trees}
    for name, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", "--root",
               root]
        if args.profile:
            cmd.append("--profile")
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        lines = [x for x in res.stdout.splitlines() if x.startswith("{")]
        if res.returncode or not lines:
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
            sys.exit(f"the {name} run failed")
        for x in res.stdout.splitlines():
            if not x.startswith("{"):
                print(f"[{name}] {x}", flush=True)
        row = json.loads(lines[-1])
        print(json.dumps(dict(tree=name, **row)), flush=True)
        runs[name].append(row)
    summary, digests = {}, set()
    for name, rows in runs.items():
        summary[name] = {}
        for scene in ("bvh_trace", "config5"):
            digests.add((scene, tuple(sorted({r[scene]["digest"]
                                              for r in rows}))))
            summary[name][scene] = {
                k: float(np.median([r[scene][k] for r in rows
                                    if r[scene][k] is not None] or [np.nan]))
                for k in KEYS}
    same = len(digests) == 2 and all(len(d) == 1 for _, d in digests)
    print(json.dumps(dict(summary=summary, turns=args.turns,
                          same_results=same,
                          card=runs["change"][0]["card"])), flush=True)
    if not same:
        sys.exit("the trees' t and visit words differ")


if __name__ == "__main__":
    main()
