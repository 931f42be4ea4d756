"""CPU BVH traversal rendered as a visual oracle, the port's twin of
examples/bvh_cpu.py (src/bin/bvh_cpu.rs): a per-pixel host-side stack
traversal of one BLAS, shaded as grayscale (limit - dist) / limit with
limit = 50 (bvh_cpu.rs:86-95). Host numpy only, as in the JAX package:
the traversal IS the oracle code path (rt/bvh.py) the device kernels are
tested against, so it runs on no device.

    python -m voidin_tpu_torch.examples.bvh_cpu [--cpu] [--width W]
        [--height H] [--out PATH]

(--cpu is accepted for the examples' common command line; the walk runs
on the host either way.)
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.camera import Camera
from ..io.image import save_png
from ..rt import bvh as bvh_mod
from ..scene import mesh as mesh_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--out", default="bvh_cpu.png")
    ap.add_argument("--cpu", action="store_true",
                    help="accepted; the oracle always runs on the host")
    args = ap.parse_args(argv)

    mesh = mesh_mod.make_torus_knot(segments=96, sides=16)
    nodes, indices = bvh_mod.build_blas(mesh.vertices, mesh.indices)

    cam = Camera(
        position=[0.0, 1.5, 4.0], yaw=0.0, pitch=-15.0,
        aspect=args.width / args.height,
    )
    u = cam.uniform()
    H, W = args.height, args.width
    # Rays exactly as bvh_cpu.rs:74-83: eye from clip (x, y, 1, 1), direction
    # from clip (x, y, 0, 1) (reverse-Z: z=1 is near, z=0 infinite far).
    xs = (np.arange(W) + 0.5) / W * 2.0 - 1.0
    ys = 1.0 - (np.arange(H) + 0.5) / H * 2.0
    xx, yy = np.meshgrid(xs, ys)
    c2w = np.asarray(u.clip_to_world)
    near = np.stack([xx, yy, np.ones_like(xx), np.ones_like(xx)], -1) @ c2w.T
    tang = np.stack([xx, yy, np.zeros_like(xx), np.ones_like(xx)], -1) @ c2w.T
    eye = near[..., :3] / near[..., 3:4]
    dirs = tang[..., :3]
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    limit = 50.0
    img = np.zeros((H, W, 3), np.float32)
    for py in range(H):
        for px in range(W):
            t = bvh_mod.traverse_blas_oracle(
                nodes, mesh.vertices, indices, eye[py, px], dirs[py, px]
            )
            if t < bvh_mod.MAX_DIST:
                img[py, px] = (limit - t) / limit
    save_png(args.out, np.clip(img, 0.0, 1.0))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
