"""The flagship example — everything at once (src/bin/model.rs:64-229),
the port's twin of examples/model.py, driven through App.

Scene per the reference's default binary, adapted to the assets present
(model.rs loads Sponza + DamagedHelmet + ferris; AntiqueCamera stands in
for the big glTF scene and torus knots for ferris):

* point light + two LTC area lights (emissive light quads added by
  add_area_light, app.rs:220-236);
* two glTF documents imported into the pools, each only where its file is
  found under the asset root (framework/presets.find_asset, VOIDIN_ASSETS);
  without them the example runs what the JAX example runs without its
  sample models;
* a ring of 10 moving spheres + 10 moving torus knots animated on-device by
  compute_update (rotation-Z +-2*sin(0.5t)*dt, compute_update.wgsl:19-27);
* full pipeline: cull -> visibility raster -> deferred LTC shade -> TAA ->
  postprocess, HUD burn-in, recorded clip + screenshot.

    python -m voidin_tpu_torch.examples.model [--cpu] [--width W]
        [--height H] [--frames N] [--out PATH] [--record PATH]

On the card by default; --cpu runs the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import mathx
from ..core.camera import Camera
from ..framework.app import App, AppState, Example
from ..framework.presets import find_asset
from ..io.image import save_png
from ..passes.raster import RasterConfig
from ..scene import mesh

CAMERA_GLTF = "glTF-Sample-Models/2.0/AntiqueCamera/glTF/AntiqueCamera.gltf"
HELMET_GLB = "glTF-Sample-Models/2.0/DamagedHelmet/glTF-Binary/DamagedHelmet.glb"
# raster capacities of the example (examples/model.py)
CAPACITIES = dict(tri_capacity=1 << 18, pair_capacity=1 << 19,
                  tile_tri_capacity=128)
CAMERA = dict(position=[2.0, 5.0, 12.0], yaw=0.0, pitch=-20.0)  # model.rs:232


class Model(Example):
    name = "model"

    def setup_scene(self, app: App):
        from ..io.gltf import GltfDocument

        w = app.world
        w.lights.add_point_light([0.0, 0.5, 0.0], 10.0, [1.0, 1.0, 1.0])
        app.add_area_light(
            [1, 1, 1], 7.0, (5.0, 8.0),
            np.asarray(
                mathx.from_translation([0, 10, 15])
                @ mathx.from_rotation_x(np.float32(-np.pi / 4))
            ),
        )
        app.add_area_light(
            [1, 1, 1], 7.0, (5.0, 8.0),
            np.asarray(
                mathx.from_translation([0, 10, -25])
                @ mathx.from_rotation_x(np.float32(-3 * np.pi / 4))
            ),
        )

        # Big glTF scene (Sponza stand-in) + DamagedHelmet (model.rs:86-106).
        camera_gltf = find_asset(CAMERA_GLTF)
        helmet_glb = find_asset(HELMET_GLB)
        if camera_gltf is not None:
            doc = GltfDocument.import_file(w, camera_gltf)
            doc.add_to_world(
                w,
                np.asarray(
                    mathx.from_translation([7.0, -5.0, 1.0])
                    @ mathx.from_scale(0.5)
                ),
            )
        if helmet_glb is not None:
            doc = GltfDocument.import_file(w, helmet_glb)
            doc.add_to_world(
                w,
                np.asarray(
                    mathx.from_translation([0.0, 0.0, 9.0])
                    @ mathx.from_scale(3.0)
                ),
            )

        # Static torus knots where model.rs places two ferris instances.
        knot = w.meshes.add(mesh.make_torus_knot(segments=96, sides=16))
        rng = np.random.default_rng(7)
        n_mats = len(w.materials)
        for pos in ([-3.0, -5.0, -4.0], [2.0, -5.0, -2.0]):
            w.instances.add(
                np.asarray(mathx.from_translation(pos)
                           @ mathx.from_scale(1.5)),
                knot,
                int(rng.integers(0, n_mats)),
            )

        # Moving ring: 10 spheres at r=3.5, z=-17 + 10 knots at z=-9
        # (model.rs:118-143); compute_update animates them on device.
        sphere10 = w.meshes.add(mesh.make_uv_sphere(1.0, 10))
        num = 10
        for i in range(num):
            r = 3.5
            angle = 2 * np.pi * i / num
            x, y = r * np.cos(angle), r * np.sin(angle)
            app.moving_ids.append(
                w.instances.add(
                    np.asarray(mathx.from_translation([x, y, -17.0])),
                    sphere10,
                    int(rng.integers(0, n_mats)),
                )
            )
            app.moving_ids.append(
                w.instances.add(
                    np.asarray(
                        mathx.from_translation([x, y, -9.0])
                        @ mathx.from_rotation_z(np.float32(angle))
                        @ mathx.from_scale(1.0)
                    ),
                    knot,
                    int(rng.integers(0, n_mats)),
                )
            )
        # Ground so the area lights have something to reflect off.
        w.instances.add(
            np.asarray(mathx.from_translation([0, -5.2, 0])
                       @ mathx.from_scale(80.0)),
            mesh.HORIZONTAL_PLANE_MESH,
            0,
        )

    def update(self, app: App, state: AppState):
        pass  # jitter + compute_update are driven by Renderer.render


def make_app(width=1280, height=1024, device="cuda"):
    """The example's App at width x height (model.rs's window is
    1280x1024) with its capacities and camera, on `device`."""
    cfg = RasterConfig(width=width, height=height, **CAPACITIES)
    cam = Camera(**CAMERA, aspect=width / height)
    return App(Model(), camera=cam, config=cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=1024)  # model.rs window
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default="model.png")
    ap.add_argument("--record", default=None,
                    help="record a clip to this path")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)
    app = make_app(args.width, args.height, "cpu" if args.cpu else "cuda")
    img = None
    if args.record:
        fps = app.run(args.frames, record_path=args.record, hud=True)
        print(f"recorded {args.frames} frames to {app.recorder.out_path} "
              f"(fps {fps:.1f})")
    else:
        for _ in range(args.frames):
            img = app.step()
    if args.record or img is None:  # record consumed its frames inside
        # run(); --frames 0 without --record never stepped at all
        img = app.step()
    save_png(args.out, img.cpu().numpy())
    aux = app.renderer.aux
    print(
        "wrote", args.out,
        "draws:", int(aux["draw_count"]),
        "coverage:", int(aux["vis_coverage"]),
        "overflow:", int(aux["overflow"]),
    )


if __name__ == "__main__":
    main()
