"""LTC ring (annulus) light demo: the port's twin of examples/ring_light.py
(src/bin/ring_light.rs).

    python -m voidin_tpu_torch.examples.ring_light [--cpu] [--width W]
        [--height H] [--out PATH]

The EXACT clipped-disk LTC evaluation (ellipse eigen-decomposition and
cubic solve, ring_light.wgsl:189-305): spec through ltc_evaluate_ring2
(full disk minus shrunk disk), diffuse through the full disk, the flat grey
material-0 background and the ray-intersected annulus emitter band. A grey
ground plane and three spheres, rasterized by kernel K1, resolved, shaded
by shade_ring_light (its LTC matrix fetched by kernel K3), postprocessed.
The card is the default; --cpu runs the kernels' twins.
"""

from __future__ import annotations

import argparse
import importlib

import numpy as np

from ..core import mathx
from ..core.camera import Camera
from ..io.image import save_png
from ..passes import cull, raster, resolve, shading
from ..passes.postprocess import postprocess
from ..passes.raster import RasterConfig
from ..scene.texture import linear_to_srgb

CAMERA = dict(position=[0, 2.0, -1.0], pitch=-18.0)
LIGHT = dict(disk_center=[0, 4.0, -2.0], disk_dirx=[1.0, 0.0, 0.0],
             disk_diry=[0.0, 0.2, -1.0], halfx=2.5, halfy=2.5)


def ring_world(pkg=None):
    """The demo's scene on `pkg`'s World (default this package; the tests
    pass the JAX package to build the very same scene there)."""
    if pkg is None:
        pkg = importlib.import_module(__name__.split(".")[0])
    mesh = importlib.import_module(pkg.__name__ + ".scene.mesh")
    w = pkg.World()
    grey = w.materials.add(albedo=w.textures.add(
        np.array([[[170, 170, 175, 255]]], np.uint8), srgb=True))
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1, -6])
                   @ mathx.from_scale(40.0)),
        mesh.HORIZONTAL_PLANE_MESH, grey)
    for i in range(3):
        t = mathx.from_translation([2.0 * (i - 1), 0.0, -6.0])
        w.instances.add(np.asarray(t), mesh.SPHERE_10_MESH, grey)
    return w


def gbuffer(scene, width, height, tri_capacity=1 << 16,
            pair_capacity=1 << 18):
    """(G-buffer, resolve aux, camera uniform) of the demo's view."""
    cfg = RasterConfig(width=width, height=height, tri_capacity=tri_capacity,
                       pair_capacity=pair_capacity)
    cam = Camera(**CAMERA, aspect=width / height).uniform()
    draws = cull.emit_draws(scene.meshes, scene.instances, cam)
    vis = raster.rasterize(scene.meshes, scene.instances, draws, cam, cfg,
                           materials=scene.materials)
    if int(vis.overflow):
        raise RuntimeError(f"raster overflow {int(vis.overflow)}: raise the "
                           "capacities")
    gb, aux = resolve.resolve_gbuffer(scene, vis, cfg)
    return gb, aux, cam


def render(scene, width, height, **capacities):
    """The demo's (H, W, 3) sRGB frame of `scene` on its device."""
    gb, aux, cam = gbuffer(scene, width, height, **capacities)
    hdr = shading.shade_ring_light(scene, gb, cam, **LIGHT,
                                   albedo=aux.albedo)
    return linear_to_srgb(postprocess(hdr))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--out", default="ring_light.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)
    scene = ring_world().device("cpu" if args.cpu else "cuda")
    img = render(scene, args.width, args.height)
    save_png(args.out, img.cpu().numpy())
    print("wrote", args.out)


if __name__ == "__main__":
    main()
