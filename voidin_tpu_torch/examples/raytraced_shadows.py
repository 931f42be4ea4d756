"""Raytraced point-light shadows over the TLAS, the port's twin of
examples/raytraced_shadows.py (src/bin/raytraced_shadows.rs): instanced
scene, SAH BVH + TLAS, a shadow ray per pixel through the hand-written
shadow-ray kernel (ops/shadow_trace.py; its twin with --cpu).

    python -m voidin_tpu_torch.examples.raytraced_shadows [--cpu]
        [--width W] [--height H] [--out PATH]

The JAX example picks its traversal (rt_packet, rt_threaded); those give
the same hits and the port carries one.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import mathx
from ..core.camera import Camera
from ..framework.renderer import Renderer
from ..io.image import save_png
from ..passes.raster import RasterConfig
from ..scene import mesh
from ..scene.scene import World


def build_world():
    w = World()
    w.lights.add_point_light([3.0, 6.0, 2.0], 30.0, [1.0, 0.95, 0.85])
    mat = w.materials.add()
    sphere5 = w.meshes.add(mesh.make_uv_sphere(1.0, 5))
    cube = w.meshes.add(mesh.make_cube_mesh(1.2))
    for i in range(14):
        a = 2 * np.pi * i / 14
        r = 2.0 + (i % 3)
        t = mathx.from_translation([r * np.cos(a), 0.2 + 0.8 * (i % 4),
                                    -6 + r * np.sin(a)])
        w.instances.add(np.asarray(t), sphere5 if i % 2 else cube, mat)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1.2, -6])
                   @ mathx.from_scale(40.0)),
        mesh.HORIZONTAL_PLANE_MESH,
        mat,
    )
    return w


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--out", default="raytraced_shadows.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)

    w = build_world()
    cfg = RasterConfig(
        width=args.width,
        height=args.height,
        tri_capacity=1 << 16,
        pair_capacity=1 << 18,
        tile_tri_capacity=128,
    )
    r = Renderer(w.device("cpu" if args.cpu else "cuda", with_tlas=True), cfg,
                 enable_taa=False, enable_rt_shadows=True)
    cam = Camera(position=[0, 3.0, 1.0], yaw=0.0, pitch=-20.0,
                 aspect=args.width / args.height)
    img = r.render(cam)
    save_png(args.out, img.cpu().numpy())
    print("wrote", args.out, "coverage:", int(r.aux["vis_coverage"]))


if __name__ == "__main__":
    main()
