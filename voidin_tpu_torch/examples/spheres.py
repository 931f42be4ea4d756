"""Minimal end-to-end example, the port's twin of examples/spheres.py:
procedural spheres + plane, lights, the full frame pipeline (cull ->
raster -> shade -> TAA -> postprocess) to PNG; the reference's
src/bin/model.rs scene shape (ring of spheres, area light, ground) with
procedural assets only.

    python -m voidin_tpu_torch.examples.spheres [--cpu] [--width W]
        [--height H] [--frames N] [--out PATH]
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
    w.lights.add_point_light([0, 2.0, 0], 15.0, [1.0, 0.9, 0.8])
    w.add_area_light(
        [1, 1, 1],
        7.0,
        (5.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 10, 15])
            @ mathx.from_rotation_x(np.float32(-np.pi / 4))
        ),
    )

    # checkerboard-ish materials
    red = w.materials.add(base_color=(0.8, 0.2, 0.2, 1.0))
    blue = w.materials.add(base_color=(0.2, 0.2, 0.9, 1.0))

    sphere5 = w.meshes.add(mesh.make_uv_sphere(1.0, 5))
    n = 10
    moving = []
    for i in range(n):
        a = 2 * np.pi * i / n
        t = mathx.from_translation([3.5 * np.cos(a), 1.0 + 3.5 * np.sin(a),
                                    -10.0])
        moving.append(
            w.instances.add(np.asarray(t), sphere5, red if i % 2 else blue)
        )
    # ground plane
    w.instances.add(
        np.asarray(mathx.from_translation([0, -5, -10])
                   @ mathx.from_scale(60.0)),
        mesh.HORIZONTAL_PLANE_MESH,
        0,
    )
    return w, moving


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="spheres.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)

    world, moving = build_world()
    cfg = RasterConfig(
        width=args.width,
        height=args.height,
        tri_capacity=1 << 16,
        pair_capacity=1 << 18,
        tile_tri_capacity=128,
    )
    r = Renderer(world.device("cpu" if args.cpu else "cuda"), cfg,
                 moving_ids=np.asarray(moving, np.int32))
    cam = Camera(position=[0.0, 2.0, 2.0], yaw=0.0, pitch=-10.0,
                 aspect=args.width / args.height)
    img = None
    for _ in range(args.frames):
        img = r.render(cam)
    print("draws:", int(r.aux["draw_count"]), "coverage:",
          int(r.aux["vis_coverage"]), "overflow:", int(r.aux["overflow"]))
    save_png(args.out, img.cpu().numpy())
    print("wrote", args.out)


if __name__ == "__main__":
    main()
