"""BASELINE configuration 5, raytraced shadows: a frozen copy of the
recipe of voidin_tpu_torch/framework/presets.py config5_raytraced_shadows
(upstream src/bin/raytraced_shadows.rs), on the benchmark's own arrays.

40 instances of a 96 x 16 torus knot and a res-4 uv sphere on rings
around (0, -8), scales drawn from the preset's seed 11, a 50x ground
plane, one point light; the TLAS over the 41 instances is the program's.

From the run's seed: the order in which the instances are listed, and
the point light's colour within the configuration's range (the preset's
colour lies in it). The geometry, and with it the frame's work, is the
same for every seed.
"""

import numpy as np

from pb import scene as sc


def build(params, seed):
    p = params
    s = sc.Scene.empty()
    own = np.random.default_rng(seed)
    knot = s.add_mesh(sc.torus_knot(segments=p["knot_segments"],
                                    sides=p["knot_sides"]))
    sphere = s.add_mesh(sc.uv_sphere(1.0, p["sphere_resolution"]))
    plane = s.add_mesh(sc.plane_mesh())
    mat = s.add_material()
    scales = np.random.default_rng(p["layout_seed"])
    items = []
    n = p["n_instances"]
    for i in range(n):
        a = 2 * np.pi * i / n
        r = 3 + (i % 5)
        t = sc.translation(
            [r * np.cos(a), 0.5 + (i % 3) * 1.2, -8 + r * np.sin(a)]
        ) @ sc.scaling(float(scales.uniform(*p["scale_range"])))
        items.append((t, knot if i % 2 else sphere, mat))
    for j in own.permutation(n):
        s.add_instance(*items[j])
    s.add_instance(sc.translation(p["ground_translation"])
                   @ sc.scaling(p["ground_scale"]), plane, mat)
    lo, hi = p["point_light"]["color_range"]
    color = own.uniform(lo, hi, 3).astype(np.float32)
    s.point_lights.append((np.float32(p["point_light"]["position"]),
                           float(p["point_light"]["radius"]), color))
    return s
