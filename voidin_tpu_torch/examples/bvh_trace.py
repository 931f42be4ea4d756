"""Primary-ray TLAS tracer with the traversal-depth heat overlay: the
port's twin of examples/bvh_trace.py (src/bin/bvh_trace.wgsl /
bvh_gpu.rs), which validates the BVH walk on the device against the
raster path.

    python -m voidin_tpu_torch.examples.bvh_trace [--cpu] [--width W]
        [--height H] [--out PATH]

Twelve instances of a torus knot and a sphere on a ring, one primary ray
per pixel through ops/closest_hit.py (the hand-written kernel on the card,
the default; its plain PyTorch twin with --cpu). Red channel: the ray's
node visits over the image's most; grey: 1 / (1 + 0.05 t) where the ray
hits, 0.05 where it misses.
"""

from __future__ import annotations

import argparse
import importlib

import numpy as np
import torch

from ..core import mathx
from ..core.camera import Camera
from ..io.image import save_png
from ..ops.closest_hit import closest_hit
from ..rt import traverse

T_MAX = 1e6
CAMERA = dict(position=[0, 2.5, 0.0], yaw=0.0, pitch=-15.0)


def trace_world(pkg=None):
    """The example's scene on `pkg`'s World (default this package; the
    tests pass the JAX package to build the very same scene there)."""
    if pkg is None:
        pkg = importlib.import_module(__name__.split(".")[0])
    mesh = importlib.import_module(pkg.__name__ + ".scene.mesh")
    w = pkg.World()
    knot = w.meshes.add(mesh.make_torus_knot(segments=128, sides=24))
    for i in range(12):
        a = 2 * np.pi * i / 12
        t = mathx.from_translation(
            [4 * np.cos(a), (i % 3) - 1, -8 + 4 * np.sin(a)])
        w.instances.add(np.asarray(t), knot if i % 2 else mesh.SPHERE_1_MESH,
                        0)
    return w


def primary_rays(width, height, camera=None):
    """(origins, directions), each (H * W, 3) f32 numpy, in screen order:
    from the camera (Camera keyword arguments, default the example's)
    through each pixel centre's point at clip depth 0.5."""
    u = Camera(**(camera or CAMERA), aspect=width / height).uniform()
    xs = (np.arange(width) + 0.5) / width * 2 - 1
    ys = 1 - (np.arange(height) + 0.5) / height * 2
    xx, yy = np.meshgrid(xs, ys)
    clip = np.stack([xx, yy, np.full_like(xx, 0.5), np.ones_like(xx)], -1)
    world = clip @ np.asarray(u.clip_to_world).T
    world = world[..., :3] / world[..., 3:4]
    origins = np.broadcast_to(np.asarray(u.position)[:3],
                              world.shape).reshape(-1, 3)
    dirs = (world - np.asarray(u.position)[:3]).reshape(-1, 3)
    return origins.astype(np.float32), dirs.astype(np.float32)


def trace(scene, width, height, camera=None):
    """Closest hits of the primary rays (primary_rays) of `scene`, built
    with its TLAS: ClosestHitResult with t and visits as (H, W)
    tensors."""
    o, d = primary_rays(width, height, camera)
    dev = scene.device
    res = closest_hit(*traverse.scene_rays(scene),
                      torch.from_numpy(o).to(dev),
                      torch.from_numpy(d).to(dev), t_max=T_MAX, width=width)
    return res._replace(t=res.t.reshape(height, width),
                        visits=res.visits.reshape(height, width))


def overlay(t, visits):
    """The demo's image from (H, W) numpy t and visits."""
    hit = t < T_MAX
    shade = np.where(hit, 1.0 / (1.0 + 0.05 * t), 0.05)
    heat = np.clip(visits / max(visits.max(), 1), 0, 1)
    return np.stack([shade + heat * 0.6, shade, shade], -1).clip(0, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--out", default="bvh_trace.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel's twin)")
    args = ap.parse_args(argv)
    scene = trace_world().device("cpu" if args.cpu else "cuda",
                                 with_tlas=True)
    res = trace(scene, args.width, args.height)
    if int(res.overflow) or int(res.exhausted):
        raise RuntimeError(f"traversal overflow={int(res.overflow)} "
                           f"exhausted={int(res.exhausted)}")
    t, visits = res.t.cpu().numpy(), res.visits.cpu().numpy()
    save_png(args.out, overlay(t, visits))
    print("wrote", args.out, "hit frac:", float((t < T_MAX).mean()),
          "max visits:", int(visits.max()))


if __name__ == "__main__":
    main()
