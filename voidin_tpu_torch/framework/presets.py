"""Benchmark scene presets: the seven BASELINE configurations.

Counterpart of ``voidin_tpu/framework/presets.py``; each preset builds the
same World (pools, instances, lights, skins) from the same calls. The
reference ships Sponza / DamagedHelmet / AntiqueCamera but NOT bunny.obj /
dragon.obj, so configs 1-2 use a dense procedural torus knot as the
scan-mesh stand-in; every preset falls back to procedural content when its
asset is absent. Each returns a :class:`Preset` (World, camera, moving
instance ids, flags, capacities) ready for the Renderer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core import mathx
from ..core.camera import Camera
from ..scene import mesh as mesh_mod
from ..scene.scene import World

# Where find_asset looks: the root named by VOIDIN_ASSETS, read at import
# (the JAX package also looks in its fixed reference mount).
_ASSET_ROOTS = [os.environ.get("VOIDIN_ASSETS", "")]


def find_asset(rel: str) -> Optional[str]:
    """The path of `rel` under the first asset root that holds it, or
    None (every preset then builds its procedural fallback)."""
    for root in _ASSET_ROOTS:
        if not root:
            continue
        p = os.path.join(root, rel)
        if os.path.exists(p):
            return p
    return None


@dataclass
class Preset:
    """A preset's World, camera and the Renderer's flags and capacities.

    The edge capacities of the coherent passes (quad_rate_resolve,
    taa_quad_history) carry the JAX Preset's values; the JAX
    Preset's rt_packet and rt_threaded are left out: they select the
    TPU's packet traversals, whose place the port's shadow-ray kernel
    takes (ROADMAP "Not ported")."""

    world: World
    camera: Camera
    moving_ids: List[int] = field(default_factory=list)
    enable_cull: bool = True
    enable_taa: bool = True
    enable_rt_shadows: bool = False
    rt_shadow_scale: int = 1  # >1 = half/quarter-res shadow rays
    with_tlas: bool = False
    # Capacity hints: padded ops cost by CAPACITY, not live count; each
    # preset sizes for its own worst case (validated by the overflow
    # counter).
    tri_capacity: int = 1 << 20
    pair_capacity: int = 1 << 20
    tile_tri_capacity: int = 128
    # Edge-batch capacities of quad_rate_resolve and taa_quad_history
    # (RasterConfig's fields of the same names)
    quad_edge_capacity: int = 1 << 16
    taa_edge_capacity: int = 1 << 11
    # Per-frame (J, 4, 4) joint matrices for skinned scenes, a function of
    # the Renderer's time (config 4's clapping arms).
    animator: Optional[object] = None


def config1_single_mesh(aspect: float) -> Preset:
    """bunny-equivalent single mesh: deferred raster + shade, fixed camera,
    no cull/TAA."""
    w = World()
    knot = w.meshes.add(mesh_mod.make_torus_knot(segments=512, sides=64))  # ~65k tris
    mat = w.materials.add()
    w.instances.add(np.eye(4, dtype=np.float32), knot, mat)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1.6, 0]) @ mathx.from_scale(30.0)),
        mesh_mod.HORIZONTAL_PLANE_MESH,
        mat,
    )
    w.lights.add_point_light([3, 4, 4], 20.0, [1, 1, 1])
    cam = Camera(position=[0, 1.2, 3.4], pitch=-15.0, aspect=aspect)
    return Preset(world=w, camera=cam, enable_cull=False, enable_taa=False,
                  tri_capacity=1 << 17, pair_capacity=1 << 18,
                  quad_edge_capacity=1 << 16, taa_edge_capacity=1 << 10)


def config2_instanced_cull(aspect: float, n_instances: int = 1000) -> Preset:
    """dragon-equivalent x1k instances: frustum cull + compacted draws.

    The full-detail knot is ~9.2k tris; without LOD the ~635 visible
    instances push 5.9M drawn triangles through a 2^23 capacity and every
    capacity-padded op pays for it (832 ms measured in round 2). A 3-level
    LOD chain selected inside emit_draws keeps far instances at 2.3k/570/
    140 tris, so live work — not capacity — sets the cost."""
    w = World()
    knot = w.meshes.add(mesh_mod.make_torus_knot(segments=192, sides=24))  # ~9k tris
    lod1 = w.meshes.add(mesh_mod.make_torus_knot(segments=96, sides=12))  # ~2.3k
    lod2 = w.meshes.add(mesh_mod.make_torus_knot(segments=48, sides=6))  # ~570
    lod3 = w.meshes.add(mesh_mod.make_torus_knot(segments=24, sides=3))  # ~140
    # Screen radius ~ 540/ratio px at 1080p: each level holds triangle
    # density at a few px^2 — sub-pixel triangles are pure binning waste.
    w.meshes.set_lods(knot, [(lod1, 5.0), (lod2, 12.0), (lod3, 24.0)])
    mat = w.materials.add()
    rng = np.random.default_rng(7)
    for _ in range(n_instances):
        t = mathx.from_translation(
            [rng.uniform(-80, 80), rng.uniform(-2, 6), rng.uniform(-80, 80)]
        ) @ mathx.from_rotation_y(np.float32(rng.uniform(0, 6.28)))
        w.instances.add(np.asarray(t), knot, mat)
    w.lights.add_point_light([0, 20, 0], 80.0, [1, 1, 1])
    cam = Camera(position=[0, 4, 40], pitch=-6.0, aspect=aspect)
    # ~635 visible instances, ~300k live LOD-selected triangles: capacities
    # sized to live work (validated by the overflow counter bench prints).
    return Preset(world=w, camera=cam, enable_taa=False,
                  tri_capacity=1 << 19, pair_capacity=1 << 20,
                  tile_tri_capacity=192,
                  quad_edge_capacity=1 << 17, taa_edge_capacity=1 << 12)


def config3_gltf_arealights(aspect: float) -> Preset:
    """glTF scene with LTC area lights (deferred shading)."""
    w = World()
    path = find_asset("glTF-Sample-Models/2.0/AntiqueCamera/glTF/AntiqueCamera.gltf")
    if path is None:
        path = find_asset(
            "glTF-Sample-Models/2.0/DamagedHelmet/glTF-Binary/DamagedHelmet.glb"
        )
    if path is not None:
        from ..io.gltf import GltfDocument

        doc = GltfDocument.import_file(w, path)
        doc.add_to_world(
            w, np.asarray(mathx.from_translation([0, -2.0, 0]))
        )
    else:  # fully procedural fallback
        knot = w.meshes.add(mesh_mod.make_torus_knot())
        w.instances.add(np.eye(4, dtype=np.float32), knot, 0)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -2.0, 0]) @ mathx.from_scale(40.0)),
        mesh_mod.HORIZONTAL_PLANE_MESH,
        0,
    )
    w.add_area_light(
        [1, 1, 1],
        7.0,
        (5.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 8, 10])
            @ mathx.from_rotation_x(np.float32(-np.pi / 4))
        ),
    )
    w.add_area_light(
        [1.0, 0.7, 0.4],
        5.0,
        (4.0, 4.0),
        np.asarray(
            mathx.from_translation([-6, 6, -6])
            @ mathx.from_rotation_x(np.float32(-3 * np.pi / 4))
        ),
    )
    w.lights.add_point_light([2, 3, 4], 12.0, [0.6, 0.6, 0.7])
    cam = Camera(position=[0, 2.5, 9.0], pitch=-12.0, aspect=aspect)
    return Preset(world=w, camera=cam, enable_taa=False,
                  tri_capacity=1 << 15, pair_capacity=1 << 18,
                  quad_edge_capacity=1 << 13, taa_edge_capacity=1 << 10)


def _add_clapper_arm(w: World, segments: int = 8, width: float = 0.6,
                     height: float = 2.4):
    """A vertical strip mesh with a 2-joint skin (hinge at the base, elbow
    at mid-height); weights blend linearly along the height. Returns the
    pool mesh id (skin registered on the world, 2 joints allocated)."""
    from ..scene import skin as skin_mod
    from ..scene.mesh import Mesh

    rows = segments + 1
    ys = np.linspace(0.0, height, rows, dtype=np.float32)
    verts = np.stack(
        [
            np.tile([-width / 2, width / 2], rows),
            np.repeat(ys, 2),
            np.zeros(rows * 2, np.float32),
        ],
        axis=-1,
    ).astype(np.float32)
    tris = []
    for r in range(segments):
        a = 2 * r
        tris += [[a, a + 1, a + 2], [a + 1, a + 3, a + 2]]
    idx = np.array(tris, np.int32).reshape(-1)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (rows * 2, 1))
    t = np.tile(np.array([[1, 0, 0, 1]], np.float32), (rows * 2, 1))
    uv = np.stack(
        [verts[:, 0] / width + 0.5, verts[:, 1] / height], axis=-1
    ).astype(np.float32)
    mesh = Mesh(verts, n, t, uv, idx)
    mid = w.meshes.add(mesh)
    # weights: joint0 below mid-height fading to joint1 above
    h = np.repeat(ys, 2) / height
    w1 = np.clip(2.0 * h - 1.0, 0.0, 1.0)
    joints = np.zeros((rows * 2, 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((rows * 2, 4), np.float32)
    weights[:, 0] = 1.0 - w1
    weights[:, 1] = w1
    off = w.allocate_joints(2)
    info = w.meshes.mesh_info[mid]
    w.skins.append(
        skin_mod.build_skin_data(
            mesh, w.meshes.indices[mid], joints, weights,
            base_tri=info["base_index"] // 3, mesh_id=mid,
            joint_offset=off, n_joints=2,
            nodes=w.meshes.bvh_nodes[mid], bvh_base=info["bvh_index"],
        )
    )
    return mid


def clapper_joint_mats(t: float, n_arms: int = 2) -> np.ndarray:
    """(4, 4, 4) joint matrices for two clapping arms: hinge rotation
    oscillates the arms toward each other, elbows follow at 60%."""
    out = []
    for k in range(n_arms):
        # first arm sits at -x and bends toward +x (Rz(-theta) tilts the
        # +y axis toward +x), the second mirrors — they clap at center
        sign = -1.0 if k == 0 else 1.0
        theta = sign * 0.8 * (0.5 + 0.5 * np.sin(2.2 * t))
        hinge = np.asarray(mathx.from_rotation_z(np.float32(theta)))
        elbow_local = np.asarray(
            mathx.from_translation([0, 1.2, 0])
            @ mathx.from_rotation_z(np.float32(0.6 * theta))
        )
        elbow_world = hinge @ elbow_local
        inv_bind = np.asarray(mathx.from_translation([0, -1.2, 0]))
        out += [hinge, elbow_world @ inv_bind]
    return np.stack(out).astype(np.float32)


def config4_animated_taa(aspect: float) -> Preset:
    """Animated instances + SKINNED clapping arms with reprojection + TAA
    resolve. BASELINE's 'animated skinned glTF (clapping)' brief: the
    reference can only rotate instance transforms (it has no skinning);
    here two 2-joint linear-blend-skinned arms clap via per-frame joint
    matrices (clapper_joint_mats, the Preset's animator) — beyond
    reference parity."""
    w = World()
    sphere = w.meshes.add(mesh_mod.make_uv_sphere(1.0, 6))
    mat = w.materials.add()
    moving = []
    for i in range(24):
        a = 2 * np.pi * i / 24
        t = mathx.from_translation([6 * np.cos(a), 1 + 2 * np.sin(3 * a), -12 + 6 * np.sin(a)])
        moving.append(w.instances.add(np.asarray(t), sphere, mat))
    w.instances.add(
        np.asarray(mathx.from_translation([0, -2, -10]) @ mathx.from_scale(60.0)),
        mesh_mod.HORIZONTAL_PLANE_MESH,
        mat,
    )
    w.lights.add_point_light([0, 8, -4], 30.0, [1, 1, 1])
    w.add_area_light(
        [1, 1, 1],
        6.0,
        (6.0, 6.0),
        np.asarray(
            mathx.from_translation([0, 9, 0])
            @ mathx.from_rotation_x(np.float32(-np.pi / 3))
        ),
    )
    # the clapping pair (strips face +z, toward the camera)
    for x in (-1.2, 1.2):
        mid = _add_clapper_arm(w)
        w.instances.add(
            np.asarray(mathx.from_translation([x, 0.0, -8.0])), mid, mat
        )
    cam = Camera(position=[0, 3, 4], pitch=-14.0, aspect=aspect)
    return Preset(world=w, camera=cam, moving_ids=moving, enable_taa=True,
                  tri_capacity=1 << 16, pair_capacity=1 << 18,
                  quad_edge_capacity=1 << 15, taa_edge_capacity=1 << 10,
                  animator=clapper_joint_mats)


def config5_raytraced_shadows(aspect: float) -> Preset:
    """Instanced TLAS scene with SAH-BVH raytraced shadows."""
    w = World()
    knot = w.meshes.add(mesh_mod.make_torus_knot(segments=96, sides=16))
    sphere = w.meshes.add(mesh_mod.make_uv_sphere(1.0, 4))
    mat = w.materials.add()
    rng = np.random.default_rng(11)
    for i in range(40):
        a = 2 * np.pi * i / 40
        r = 3 + (i % 5)
        t = mathx.from_translation(
            [r * np.cos(a), 0.5 + (i % 3) * 1.2, -8 + r * np.sin(a)]
        ) @ mathx.from_scale(float(rng.uniform(0.5, 1.0)))
        w.instances.add(np.asarray(t), knot if i % 2 else sphere, mat)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1.0, -8]) @ mathx.from_scale(50.0)),
        mesh_mod.HORIZONTAL_PLANE_MESH,
        mat,
    )
    w.lights.add_point_light([5, 9, 0], 35.0, [0.7, 0.68, 0.6])
    cam = Camera(position=[0, 4, 3], pitch=-22.0, aspect=aspect)
    return Preset(
        world=w,
        camera=cam,
        enable_taa=False,
        enable_rt_shadows=True,
        with_tlas=True,
        tri_capacity=1 << 17,
        pair_capacity=1 << 19,
        quad_edge_capacity=1 << 16,
        taa_edge_capacity=1 << 10,
    )


def _sponza_texture_set(w: World, n_textures: int, base_size: int) -> List[int]:
    """Sponza's REAL texture files from the asset root (when present),
    padded to `n_textures` with seeded procedural plasma textures (full
    procedural fallback when the root lacks the files). The files load
    through io/image.py to the pixels PIL gives the JAX package (every PNG,
    and JPEG through io/jpeg.py, progressive files included; the files it
    leaves out raise NotImplementedError naming them)."""
    import glob

    tex_dir = find_asset("glTF-Sample-Models/2.0/Sponza/glTF")
    tex_ids: List[int] = []
    if tex_dir is not None:
        from ..io.image import load_image

        files = sorted(
            glob.glob(os.path.join(tex_dir, "*.jpg"))
            + glob.glob(os.path.join(tex_dir, "*.png"))
        )
        for f in files[:n_textures]:
            tex_ids.append(w.textures.add(load_image(f), srgb=True))
    while len(tex_ids) < n_textures:  # pad / full procedural fallback
        s = min(base_size, 256)
        yy, xx = np.mgrid[0:s, 0:s]
        k = len(tex_ids)
        img = np.stack(
            [
                128 + 100 * np.sin(xx * (0.05 + 0.01 * (k % 7)) + k),
                128 + 100 * np.sin(yy * (0.04 + 0.01 * (k % 5)) - k),
                128 + 100 * np.sin((xx + yy) * 0.03 + 2 * k),
            ],
            axis=-1,
        ).clip(0, 255).astype(np.uint8)
        tex_ids.append(w.textures.add(img, srgb=True))
    return tex_ids


def config6_sponza_textures(
    aspect: float,
    base_size: int = 1024,
    n_textures: int = 104,
    n_knots: int = 32,
    knot_detail=(192, 24),
    seed: int = 3,
) -> Preset:
    """Sponza-scale TEXTURE stress (VERDICT r3 #3).

    The reference's flagship loads Sponza — ~103 real 1024^2 textures
    (model.rs:86-106, README.md:10 "large scenes") — which is the design
    point the texel-quad texture pool had never been demonstrated at.
    Sponza.bin is absent from the read-only asset mount (geometry cannot
    load), so this preset puts Sponza's REAL texture set (69 jpg/png
    files, padded to `n_textures` with seeded procedural textures) on
    synthesized stand-in geometry: `n_knots` dense torus knots (~9.2k
    tris each, ~300k total) + a textured floor, one material per texture.

    Device bytes (scene/texture.py pool_device_bytes): the pool stores
    one 32 B quad row per texel over the flattened mip chain, (4/3) S^2
    rows = 44.7 MB per texture slot at S=1024, ~4.8 GB for ~107 slots.
    The pool is sized to the largest image it holds: the procedural set
    is 256^2, so the fallback's pool is S=256."""
    w = World(texture_base_size=base_size)
    rng = np.random.default_rng(seed)

    tex_ids = _sponza_texture_set(w, n_textures, base_size)
    mats = [w.materials.add(albedo=t) for t in tex_ids]

    knot = w.meshes.add(
        mesh_mod.make_torus_knot(segments=knot_detail[0],
                                 sides=knot_detail[1])
    )
    side = int(np.ceil(np.sqrt(n_knots)))
    for i in range(n_knots):
        gx, gz = i % side, i // side
        t = mathx.from_translation(
            [6.0 * (gx - (side - 1) / 2), 1.2, -8.0 - 6.0 * gz]
        ) @ mathx.from_rotation_y(np.float32(rng.uniform(0, 6.28)))
        w.instances.add(np.asarray(t), knot, mats[i % len(mats)])
    w.instances.add(
        np.asarray(
            mathx.from_translation([0, -1.2, -20]) @ mathx.from_scale(80.0)
        ),
        mesh_mod.HORIZONTAL_PLANE_MESH,
        mats[-1],
    )
    w.lights.add_point_light([0, 18, -12], 60.0, [1, 1, 1])
    w.add_area_light(
        [1, 1, 1],
        8.0,
        (10.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 14, -2])
            @ mathx.from_rotation_x(np.float32(-np.pi / 3))
        ),
    )
    cam = Camera(position=[0, 6, 6], pitch=-16.0, aspect=aspect)
    return Preset(
        world=w,
        camera=cam,
        tri_capacity=1 << 19,
        pair_capacity=1 << 19,
        tile_tri_capacity=192,
        quad_edge_capacity=1 << 17,
        taa_edge_capacity=1 << 12,
    )


def config7_sponza_geometry(
    aspect: float,
    n_textures: int = 26,
    base_size: int = 1024,
    seed: int = 7,
    detail: float = 1.0,
) -> Preset:
    """Sponza-scale GEOMETRY stress (VERDICT r4 missing #3).

    The reference's flagship loads the full Sponza glTF — a single static
    model of ~262k triangles across ~25 distinct meshes, each with its
    own BLAS, ONE instance each (model.rs:86-106; no instancing leverage
    at all). Config 6 proved the TEXTURE axis; this preset proves the
    unique-geometry axis the torus-knot instancing presets never touch:
    every triangle is a distinct record in the mesh pool, cull passes
    whole meshes (Sponza ships no LOD chains), and triangle setup /
    binning run at full unique-tri rate.

    Sponza.bin is absent from the read-only mount, so the geometry is
    synthesized at the same scale and composition: an atrium layout of
    ~24 distinct dense meshes (varied (p,q) torus-knot "columns", UV
    sphere "vaults", box walls + floor) totalling ~260k triangles, one
    material per mesh drawn from the real Sponza texture set (config 6's
    loader) so resolve runs real trilinear taps."""
    w = World(texture_base_size=base_size)
    rng = np.random.default_rng(seed)

    tex_ids = _sponza_texture_set(w, n_textures, base_size)
    mats = [w.materials.add(albedo=t) for t in tex_ids]

    def place(mesh, t, k):
        mid = w.meshes.add(mesh)
        w.instances.add(np.asarray(t, np.float32), mid, mats[k % len(mats)])
        return mid

    # Like Sponza, detail is authored at ARCHITECTURE density: per-mesh
    # tessellation scales with distance from the fixed camera (an
    # artist's static choice, NOT a runtime LOD chain — the preset ships
    # none, like Sponza), so per-tile triangle density stays bounded
    # instead of collapsing far dense meshes to sub-pixel soup.
    cam_pos = np.array([0.0, 5.0, 2.0], np.float32)

    def knot_at(pos, k, pq, scale=1.7, boost=1.0):
        d = float(np.linalg.norm(np.asarray(pos, np.float32) - cam_pos))
        seg = max(16, int((64 + 2800.0 / d) * boost * detail))
        sides = max(6, int((8 + 180.0 / d) * boost * detail))
        t = (
            mathx.from_translation(pos)
            @ mathx.from_rotation_y(np.float32(rng.uniform(0, 6.28)))
            @ mathx.from_scale(scale)
        )
        place(
            mesh_mod.make_torus_knot(p=pq[0], q=pq[1], segments=seg,
                                     sides=sides),
            t, k,
        )

    def sphere_at(pos, k, scale=3.2, boost=1.0):
        d = float(np.linalg.norm(np.asarray(pos, np.float32) - cam_pos))
        res = max(3, int((4 + 110.0 / d) * boost * detail))
        place(
            mesh_mod.make_uv_sphere(resolution=res),
            mathx.from_translation(pos) @ mathx.from_scale(scale),
            k,
        )

    # Two colonnades of 6 distinct knot "columns" each, varied (p,q).
    pqs = [(2, 3), (2, 5), (3, 4), (2, 7), (3, 5), (2, 3),
           (3, 7), (2, 5), (4, 3), (2, 9), (3, 8), (5, 2)]
    for i in range(12):
        row, col = divmod(i, 6)
        knot_at([-9.0 + 18.0 * row, 2.2, -6.0 - 7.0 * col], i, pqs[i])

    # Six sphere "vaults" along the roof line.
    for i in range(6):
        sphere_at([0.0, 10.5, -6.0 - 7.0 * i], 12 + i)

    # Near-field clutter (Sponza's pots / lion heads / drapes class):
    # four statement knots flanking the camera and eight floor vases —
    # large on screen, so dense tessellation stays architecture-rate.
    for i in range(4):
        knot_at([-6.0 + 4.0 * i, 1.0, -2.5 - 1.5 * (i % 2)], 26 + i,
                pqs[i], scale=0.9, boost=0.9)
    for i in range(8):
        sphere_at([-7.0 + 2.0 * i, 0.6, -7.5 - 2.0 * (i % 3)], 30 + i,
                  scale=0.6, boost=1.1)

    # Atrium shell: floor + two long side walls + far wall (distinct box
    # meshes so each gets its own BLAS like Sponza's architecture nodes).
    place(
        mesh_mod.make_plane_mesh(),
        mathx.from_translation([0, 0, -24]) @ mathx.from_scale(64.0),
        18,
    )
    for i, (x, sx, sz) in enumerate(
        [(-13.0, 1.0, 50.0), (13.0, 1.0, 50.0)]
    ):
        place(
            mesh_mod.make_box_mesh(sx, 14.0, sz),
            mathx.from_translation([x, 7.0, -24.0]),
            19 + i,
        )
    place(
        mesh_mod.make_box_mesh(26.0, 14.0, 1.0),
        mathx.from_translation([0.0, 7.0, -49.0]),
        21,
    )
    # Hanging "cloth" banners: vertical planes mid-atrium.
    for i in range(4):
        place(
            mesh_mod.make_vertical_plane_mesh(4.0, 6.0),
            mathx.from_translation([-6.0 + 4.0 * i, 7.0, -16.0 - 6.0 * i]),
            22 + i,
        )

    # Sponza demo lighting: a sun-like point + two area panels.
    w.lights.add_point_light([0, 24, -20], 80.0, [1.0, 0.95, 0.85])
    w.add_area_light(
        [1, 1, 1], 6.0, (12.0, 8.0),
        np.asarray(
            mathx.from_translation([0, 13.5, -14])
            @ mathx.from_rotation_x(np.float32(-np.pi / 2))
        ),
    )
    w.add_area_light(
        [0.9, 0.9, 1.0], 4.0, (8.0, 6.0),
        np.asarray(
            mathx.from_translation([0, 13.5, -34])
            @ mathx.from_rotation_x(np.float32(-np.pi / 2))
        ),
    )
    cam = Camera(position=[0, 5.0, 2.0], pitch=-8.0, aspect=aspect)
    return Preset(
        world=w,
        camera=cam,
        # ~287k unique tris, all potentially live (no LOD chains): slot
        # stream sized to the mesh pool, extras stream measured 91k over
        # 2^19 at the bench pose on the production pair path -> 2^20
        # (overflow 0, max 1424 records/tile; printed by bench).
        tri_capacity=1 << 19,
        pair_capacity=1 << 20,
        tile_tri_capacity=192,
        quad_edge_capacity=1 << 17,
        taa_edge_capacity=1 << 12,
    )


PRESETS = {
    1: config1_single_mesh,
    2: config2_instanced_cull,
    3: config3_gltf_arealights,
    4: config4_animated_taa,
    5: config5_raytraced_shadows,
    6: config6_sponza_textures,
    7: config7_sponza_geometry,
}
