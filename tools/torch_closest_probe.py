"""How the closest-hit kernel's time depends on which rays share a warp,
on one GPU.

    python3 tools/torch_closest_probe.py [--root DIR]

For both 1080p scenes of chip_smoke.closest_phases (the bvh_trace
example's and config 5's primary rays, voidin_tpu_torch imported from DIR,
default this checkout): the SIMT share of the launch, the mean pops a ray
over the mean of each 32-ray warp's most pops (a warp walks as long as its
longest ray), and the kernel's device ms (chip_smoke.device_ms), for the
rays in screen order (a warp 32 pixels of one row) and reordered so that
a warp is an 8x4-pixel tile and a block of 128 a 16x8 one. The reordered
run's t and visit words, put back in screen order, must equal the screen
order's. Prints one JSON line with the card's name and power limit. Needs
a CUDA device.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 1920, 1080


def tile_order(width, height, dev):
    """Ray indices of a width x height screen-order image so that each 32
    rays are an 8x4 tile and each 128 a 16x8 one (width a multiple of 16,
    height of 8)."""
    import torch

    y = torch.arange(height, device=dev).reshape(height // 8, 1, 2, 1, 4, 1)
    x = torch.arange(width, device=dev).reshape(1, width // 16, 1, 2, 1, 8)
    y, x = torch.broadcast_tensors(y, x)
    return (y * width + x).reshape(-1)


def simt_share(visits):
    v = visits.double()
    return float(v.mean() / v.reshape(-1, 32).amax(dim=1).mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as cs
    import voidin_tpu_torch as pt
    from voidin_tpu_torch.examples import bvh_trace
    from voidin_tpu_torch.ops import closest_hit as ch
    from voidin_tpu_torch.rt import traverse

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    c5 = cs.config5_preset(pt)
    perm = tile_order(WIDTH, HEIGHT, dev)
    out = dict(root=os.path.abspath(args.root))
    for key, world, camera in (
            ("bvh_trace", bvh_trace.trace_world(), None),
            ("config5", c5.world, dict(position=c5.camera.position,
                                       yaw=c5.camera.yaw,
                                       pitch=c5.camera.pitch))):
        scene = world.device(dev, with_tlas=True)
        o, d = bvh_trace.primary_rays(WIDTH, HEIGHT, camera)
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        tables = traverse.scene_rays(scene)
        kw = dict(t_max=bvh_trace.T_MAX)
        row = {}
        res = {}
        for order, (oo, dd) in (("screen", (o, d)),
                                ("tiles", (o[perm], d[perm]))):
            res[order] = ch.closest_hit(*tables, oo, dd, **kw)
            row[order] = dict(
                simt_share=simt_share(res[order].visits),
                device_ms=cs.device_ms(
                    lambda: ch.closest_hit(*tables, oo, dd, **kw), 20,
                    "closest_hit"))
        back_t = torch.empty_like(res["tiles"].t)
        back_t[perm] = res["tiles"].t
        back_v = torch.empty_like(res["tiles"].visits)
        back_v[perm] = res["tiles"].visits
        row["same"] = bool(torch.equal(back_t.view(torch.int32),
                                       res["screen"].t.view(torch.int32))
                           and torch.equal(back_v, res["screen"].visits))
        out[key] = row
    out["card"] = cs.card_line()
    print(json.dumps(out), flush=True)
    if not all(out[k]["same"] for k in ("bvh_trace", "config5")):
        sys.exit("the tile order changed a result")


if __name__ == "__main__":
    main()
