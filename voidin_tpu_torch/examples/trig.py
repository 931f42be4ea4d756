"""Hello triangle: the port's twin of examples/trig.py (src/bin/trig.rs
equivalent), the smallest pipeline smoke test — one triangle through the
full raster + shade path at 320x240.

    python -m voidin_tpu_torch.examples.trig [--cpu] [--out PATH]

On the card by default (K1 and the fused LTC kernel's frame); --cpu runs
the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.camera import Camera
from ..framework.renderer import Renderer
from ..io.image import save_png
from ..passes.raster import RasterConfig
from ..scene.mesh import Mesh
from ..scene.scene import World


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trig.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)

    w = World()
    tri = Mesh(
        vertices=np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        normals=np.tile(np.array([[0, 0, 1]], np.float32), (3, 1)),
        tangents=np.tile(np.array([[1, 0, 0, -1]], np.float32), (3, 1)),
        uvs=np.array([[0, 0], [1, 0], [0.5, 1]], np.float32),
        indices=np.array([0, 1, 2], np.int32),
    )
    mesh_id = w.meshes.add(tri)
    tex = w.textures.add(np.array([[[230, 80, 60, 255]]], np.uint8), srgb=True)
    mat = w.materials.add(albedo=tex)
    w.instances.add(np.eye(4, dtype=np.float32), mesh_id, mat)
    w.lights.add_point_light([0, 0, 3], 10.0, [1, 1, 1])

    cfg = RasterConfig(width=320, height=240, tri_capacity=1 << 8,
                       pair_capacity=1 << 10, tile_tri_capacity=64)
    r = Renderer(w.device("cpu" if args.cpu else "cuda"), cfg,
                 enable_taa=False)
    img = r.render(Camera(position=[0, 0, 2.5], aspect=320 / 240))
    save_png(args.out, img.cpu().numpy())
    print("wrote", args.out, "coverage:", int(r.aux["vis_coverage"]))


if __name__ == "__main__":
    main()
