"""The north-star scene: a frozen copy of the recipe of
voidin_tpu_torch/framework/renderer.py build_world (itself bench.py
build_world, the BASELINE north star), on the benchmark's own arrays.

10k instances of LOD'd spheres and cubes on a 400 x 400 field (their
layout, scales, meshes and materials drawn from the configuration's
layout seed, as build_world(10_000, seed=0) draws them), two 256^2
sRGB textures, a ground plane, two rect area lights with their emissive
quads and one point light; every 50th instance moves.

From the run's seed: the noise texture's texels, and the order in which
the instances are listed (so which 1 in 50 of them moves). The set of
instances, and with it the frame's work, is the same for every seed.
"""

import numpy as np

from pb import scene as sc


def build(params, seed):
    p = params
    s = sc.Scene.empty()
    layout = np.random.default_rng(p["layout_seed"])
    own = np.random.default_rng(seed)
    quad = s.add_mesh(sc.vertical_plane_mesh())
    s.point_lights.append((np.float32(p["point_light"]["position"]),
                           float(p["point_light"]["radius"]),
                           np.float32(p["point_light"]["color"])))
    for light in p["area_lights"]:
        t = (sc.translation(light["translation"])
             @ sc.rotation_x(np.float32(light["rotation_x_pi"] * np.pi)))
        sc.area_light(s, quad, light["color"], light["intensity"],
                      tuple(light["size"]), t)
    n = p["texture_size"]
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    checker = ((xx // 16 + yy // 16) % 2 * 155 + 100).astype(np.uint8)
    tex_checker = s.add_texture(
        np.stack([checker, checker // 2 + 64, checker // 3 + 42], -1),
        srgb=True)
    layout.integers(60, 220, (n, n, 3))  # the layout seed's noise draw
    tex_noise = s.add_texture(
        own.integers(60, 220, (n, n, 3)).astype(np.uint8), srgb=True)
    mat_checker = s.add_material(albedo=tex_checker)
    mat_noise = s.add_material(albedo=tex_noise)

    sphere2 = s.add_mesh(sc.uv_sphere(1.0, 2))
    sphere3 = s.add_mesh(sc.uv_sphere(1.0, 3))
    cube = s.add_mesh(sc.cube_mesh(1.5))
    sphere1 = s.add_mesh(sc.uv_sphere(1.0, 1))
    plane = s.add_mesh(sc.plane_mesh())
    meshes = [sphere2, cube, sphere3, sphere1]
    s.lods[sphere3] = [(sphere2, 8.0), (sphere1, 20.0)]
    s.lods[sphere2] = [(sphere1, 14.0)]

    half = p["field"] / 2.0
    items = []
    for i in range(p["n_instances"] - len(s.transforms)):
        x = layout.uniform(-half, half)
        z = layout.uniform(-half, half)
        y = layout.uniform(*p["height_range"])
        t = sc.translation([x, y, z]) @ sc.scaling(
            float(layout.uniform(*p["scale_range"])))
        mid = int(layout.integers(0, len(meshes)))
        items.append((t, meshes[mid], mat_checker if i % 2 else mat_noise))
    moving = []
    for k, j in enumerate(own.permutation(len(items))):
        idx = s.add_instance(*items[j])
        if k % p["moving_every"] == 0:
            moving.append(idx)
    s.add_instance(sc.translation([0, p["ground_y"], 0])
                   @ sc.scaling(p["ground_scale"]), plane, 0)
    s.moving = np.asarray(moving, np.int32)
    return s
