"""Interactive terminal viewer over the deferred pipeline, the port's twin
of examples/viewer.py — the analogue of running a reference binary in its
winit window (lib.rs event loop), shown as 24-bit ANSI half-block cells in
any terminal.

    python -m voidin_tpu_torch.examples.viewer [--cpu] [--width W]
        [--height H] [--frames N]

Keys: WASD/QE move, arrows look, +/- speed, 3 screenshot, Esc quit. On the
card by default; --cpu runs the kernels' twins.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import mathx
from ..core.camera import Camera
from ..framework.app import App, Example
from ..framework.viewer import run_terminal
from ..passes.raster import RasterConfig
from ..scene import mesh


class Spin(Example):
    name = "viewer"

    def setup_scene(self, app):
        w = app.world
        w.lights.add_point_light([0, 6.0, 0], 30.0, [1.0, 0.95, 0.9])
        app.add_area_light(
            [1, 1, 1], 6.0, (5.0, 5.0),
            np.asarray(
                mathx.from_translation([0, 8, 4])
                @ mathx.from_rotation_x(np.float32(-np.pi / 4))
            ),
        )
        red = w.materials.add(albedo=w.textures.add(
            np.array([[[200, 70, 60, 255]]], np.uint8), srgb=True))
        grey = w.materials.add(albedo=w.textures.add(
            np.array([[[160, 160, 165, 255]]], np.uint8), srgb=True))
        for i in range(8):
            a = 2 * np.pi * i / 8
            t = mathx.from_translation(
                [4.0 * np.cos(a), 0.6, -8 + 4.0 * np.sin(a)]
            )
            app.moving_ids.append(w.instances.add(
                np.asarray(t), mesh.SPHERE_10_MESH,
                red if i % 2 else grey))
        w.instances.add(
            np.asarray(mathx.from_translation([0, -1, -8])
                       @ mathx.from_scale(40.0)),
            mesh.HORIZONTAL_PLANE_MESH, grey)


def make_app(width, height, device):
    """The viewer examples' App: Spin at width x height on `device`."""
    cfg = RasterConfig(width=width, height=height,
                       tri_capacity=1 << 15, pair_capacity=1 << 17)
    cam = Camera(position=[0, 2.5, 0.0], pitch=-14.0, aspect=width / height)
    return App(Spin(), camera=cam, config=cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: until Esc)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)
    app = make_app(args.width, args.height, "cpu" if args.cpu else "cuda")
    n = run_terminal(app, max_frames=args.frames)
    print(f"viewer closed after {n} frames")


if __name__ == "__main__":
    main()
