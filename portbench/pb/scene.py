"""The benchmark's own scene data: meshes, textures, materials, instances
and lights as plain numpy arrays, made by the benchmark's code from a
recipe and a seed, and handed both to the program (through its World)
and to the plain reference.

The mesh generators are frozen copies of voidin_tpu_torch/scene/mesh.py
(make_plane_mesh, make_vertical_plane_mesh, make_uv_sphere,
make_cube_mesh, make_torus_knot) and the area-light corners of
voidin_tpu_torch/scene/light.py area_light_points_from_transform, copied
so that a later change to the program cannot move the yardstick.

A Scene mirrors the program's pools id for id: meshes 0-3, textures 0-3
and materials 0-2 are the pools' reserved entries (the recipes draw
nothing with the reserved meshes, so every drawn triangle comes from here).

Skins and their animation are data shaped as glTF 2.0 holds them: a skin
names a mesh, its vertices' JOINTS_0 / WEIGHTS_0 and its joint list; the
skeleton's joints carry a parent, a rest translation, rotation and scale
and an inverse bind matrix; one looping clip samples each joint's local
translation, rotation and scale at its keys (LINEAR). pb/animation.py
turns them into a frame's joint matrices; a scene without skins has none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

LIGHT_MATERIAL = 2  # the program's reserved emitter material
WHITE, BLACK = 0, 1  # reserved texture ids


@dataclasses.dataclass
class MeshArrays:
    vertices: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    tangents: np.ndarray  # (V, 4) f32
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (I,) i32


def _mesh(v, n, t, uv, idx):
    return MeshArrays(np.ascontiguousarray(v, np.float32),
                      np.ascontiguousarray(n, np.float32),
                      np.ascontiguousarray(t, np.float32),
                      np.ascontiguousarray(uv, np.float32),
                      np.ascontiguousarray(idx, np.int32))


def plane_mesh(width=1.0, height=1.0):
    """Horizontal quad in XZ, +Y normal (copy of make_plane_mesh)."""
    w, h = width / 2.0, height / 2.0
    v = np.array([[-w, 0, -h], [-w, 0, h], [w, 0, h], [w, 0, -h]],
                 np.float32)
    n = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    t = np.tile(np.array([[1, 0, 0, -1]], np.float32), (4, 1))
    return _mesh(v, n, t, uv, [0, 1, 2, 0, 2, 3])


def vertical_plane_mesh(width=1.0, height=1.0):
    """The horizontal plane rotated by Rx(-pi/2) (copy of
    make_vertical_plane_mesh)."""
    m = plane_mesh(width, height)
    rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    return _mesh(m.vertices @ rot.T, m.normals @ rot.T, m.tangents, m.uvs,
                 m.indices)


def uv_sphere(radius=1.0, resolution=10):
    """UV sphere, 4*res stacks and 8*res sectors (copy of make_uv_sphere)."""
    vside = 4 * resolution
    uside = vside * 2
    v = np.linspace(0.0, 1.0, vside + 1, dtype=np.float32)
    u = np.linspace(0.0, 1.0, uside + 1, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    theta = 2.0 * np.pi * uu + np.pi
    phi = np.pi * vv
    x = np.cos(theta) * np.sin(phi) * radius
    y = -np.cos(phi) * radius
    z = np.sin(theta) * np.sin(phi) * radius
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    norms = np.linalg.norm(verts, axis=-1, keepdims=True)
    normals = verts / np.maximum(norms, 1e-20)
    uvs = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    tangents = np.tile(np.array([[1, 0, 0, -1]], np.float32),
                       (len(verts), 1))
    tri = []
    for i in range(vside):
        k1 = i * (uside + 1)
        for j in range(uside):
            a, b = k1 + j, k1 + j + uside + 1
            if i != 0:
                tri += [a, b, a + 1]
            tri += [a + 1, b, b + 1]
    return _mesh(verts, normals, tangents, uvs, tri)


def cube_mesh(size=1.0):
    """24-vertex, 6-face cube (copy of make_cube_mesh)."""
    s = size / 2.0
    faces = [([0, 0, 1], [1, 0, 0]), ([0, 0, -1], [-1, 0, 0]),
             ([1, 0, 0], [0, 0, -1]), ([-1, 0, 0], [0, 0, 1]),
             ([0, 1, 0], [1, 0, 0]), ([0, -1, 0], [1, 0, 0])]
    verts, norms, tans, uvs, idx = [], [], [], [], []
    for fi, (n, t) in enumerate(faces):
        n = np.array(n, np.float32)
        t = np.array(t, np.float32)
        b = np.cross(n, t)
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            verts.append(n * s + t * (du * s) + b * (dv * s))
            norms.append(n)
            tans.append(np.concatenate([t, [np.float32(-1.0)]]))
            uvs.append([(du + 1) / 2, (dv + 1) / 2])
        base = 4 * fi
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return _mesh(np.array(verts), np.array(norms), np.array(tans),
                 np.array(uvs), idx)


def torus_knot(p=2, q=3, segments=256, sides=32, radius=1.0, tube=0.3):
    """(p, q) torus-knot tube (copy of make_torus_knot)."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False, dtype=np.float32)
    r = radius * (2 + np.cos(q * t)) * 0.5
    center = np.stack(
        [r * np.cos(p * t), radius * np.sin(q * t) * 0.5, r * np.sin(p * t)],
        -1)
    nxt = np.roll(center, -1, axis=0)
    tang = nxt - center
    tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-9)
    up = np.array([0, 1, 0], np.float32)
    side = np.cross(tang, up)
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-9)
    up2 = np.cross(side, tang)
    a = np.linspace(0, 2 * np.pi, sides, endpoint=False, dtype=np.float32)
    circ = (np.cos(a)[None, :, None] * side[:, None, :]
            + np.sin(a)[None, :, None] * up2[:, None, :])
    verts = (center[:, None, :] + tube * circ).reshape(-1, 3)
    normals = circ.reshape(-1, 3)
    uvs = np.stack(np.meshgrid(np.arange(sides) / sides,
                               np.arange(segments) / segments),
                   -1).reshape(-1, 2).astype(np.float32)
    tangents = np.concatenate(
        [np.repeat(tang, sides, axis=0),
         -np.ones((len(verts), 1), np.float32)], axis=-1)
    i = np.arange(segments)[:, None]
    j = np.arange(sides)[None, :]
    a0 = i * sides + j
    a1 = i * sides + (j + 1) % sides
    b0 = ((i + 1) % segments) * sides + j
    b1 = ((i + 1) % segments) * sides + (j + 1) % sides
    idx = np.stack([a0, b0, a1, a1, b0, b1], -1).reshape(-1)
    return _mesh(verts, normals, tangents, uvs, idx)


def translation(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def scaling(s):
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    return np.diag(np.concatenate([s, [np.float32(1.0)]])).astype(np.float32)


def rotation_x(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                     [0, 0, 0, 1]], np.float32)


def area_light_points(wh, transform):
    """Quad corners of an area light (copy of the program's
    area_light_points_from_transform, light.rs:28-52)."""
    transform = np.asarray(transform, np.float32)
    basis = transform[:3, :3]
    scale = np.linalg.norm(basis, axis=0)
    rot = basis / scale
    trans = transform[:3, 3]
    direction = rot @ np.array([0.0, 0.0, 1.0], np.float32)
    direction = direction / np.linalg.norm(direction)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    dirx = np.cross(up, direction)
    diry = np.cross(direction, dirx)
    wh = np.asarray(wh, np.float32) * scale[:2]
    dx = dirx * wh[0] / 2.0
    dy = diry * wh[1] / 2.0
    return np.stack([trans - dx - dy, trans + dx - dy, trans + dx + dy,
                     trans - dx + dy]).astype(np.float32)


@dataclasses.dataclass
class Joint:
    """One joint of the skeleton (a glTF node that skins list): its parent
    (an earlier joint's index, -1 for a root), its rest local transform
    (translation, unit rotation quaternion x y z w, scale) and its inverse
    bind matrix."""

    parent: int
    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # (4,) x y z w
    scale: np.ndarray  # (3,)
    inverse_bind: np.ndarray  # (4, 4)


@dataclasses.dataclass
class Skin:
    """A skinned mesh (a glTF skin and its primitive's JOINTS_0 /
    WEIGHTS_0): every instance of `mesh` takes the pose. A vertex's joint
    k is skeleton joint joint_list[joints[v, k]]."""

    mesh: int
    joints: np.ndarray  # (V, 4) int
    weights: np.ndarray  # (V, 4) f32
    joint_list: List[int]


@dataclasses.dataclass
class Clip:
    """One looping animation clip (a glTF animation with LINEAR samplers):
    at each key time (K,) s every joint's local translation (K, J, 3),
    rotation (K, J, 4, x y z w) and scale (K, J, 3). Frame f samples it at
    (f % period_frames) * dt, held at its first and last key outside them
    (glTF's clamp), so it repeats every period_frames frames."""

    times: np.ndarray  # (K,)
    translation: np.ndarray  # (K, J, 3)
    rotation: np.ndarray  # (K, J, 4)
    scale: np.ndarray  # (K, J, 3)
    period_frames: int


@dataclasses.dataclass
class Scene:
    """One configuration's scene as host arrays, ids as in the program's
    pools. Textures are u8 (h, w, 4) with an sRGB flag; materials hold
    base colour and texture ids (albedo, normal, metallic-roughness,
    emissive)."""

    meshes: List[MeshArrays] = dataclasses.field(default_factory=list)
    lods: Dict[int, List[Tuple[int, float]]] = dataclasses.field(
        default_factory=dict)
    textures: List[Tuple[np.ndarray, bool]] = dataclasses.field(
        default_factory=list)
    materials: List[dict] = dataclasses.field(default_factory=list)
    transforms: List[np.ndarray] = dataclasses.field(default_factory=list)
    mesh_ids: List[int] = dataclasses.field(default_factory=list)
    material_ids: List[int] = dataclasses.field(default_factory=list)
    point_lights: List[tuple] = dataclasses.field(default_factory=list)
    area_lights: List[tuple] = dataclasses.field(default_factory=list)
    moving: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    skins: List[Skin] = dataclasses.field(default_factory=list)
    skeleton: List[Joint] = dataclasses.field(default_factory=list)
    clip: Optional[Clip] = None

    @classmethod
    def empty(cls):
        """The pools' reserved entries: meshes 0-3 (planes, spheres of
        res 1 and 10), textures white, black and two white placeholders,
        materials 0-2 at the defaults."""
        s = cls()
        for m in (plane_mesh(), vertical_plane_mesh(), uv_sphere(1.0, 1),
                  uv_sphere(1.0, 10)):
            s.meshes.append(m)
        white = np.full((1, 1, 4), 255, np.uint8)
        black = np.zeros((1, 1, 4), np.uint8)
        black[..., 3] = 255
        for img in (white, black, white.copy(), white.copy()):
            s.textures.append((img, False))
        for _ in range(3):
            s.add_material()
        return s

    def add_mesh(self, m: MeshArrays) -> int:
        self.meshes.append(m)
        return len(self.meshes) - 1

    def add_texture(self, img, srgb=False) -> int:
        img = np.asarray(img, np.uint8)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.full_like(img[..., :1], 255)], -1)
        self.textures.append((np.ascontiguousarray(img), bool(srgb)))
        return len(self.textures) - 1

    def add_material(self, base_color=(1.0, 1.0, 1.0, 1.0), albedo=WHITE,
                     normal=WHITE, metallic_roughness=BLACK,
                     emissive=BLACK) -> int:
        self.materials.append(dict(
            base_color=np.asarray(base_color, np.float32), albedo=albedo,
            normal=normal, metallic_roughness=metallic_roughness,
            emissive=emissive))
        return len(self.materials) - 1

    def add_instance(self, transform, mesh, material) -> int:
        self.transforms.append(np.asarray(transform, np.float32))
        self.mesh_ids.append(int(mesh))
        self.material_ids.append(int(material))
        return len(self.transforms) - 1

    def arrays(self):
        """Instance arrays: (transform (N, 4, 4), mesh (N,), material (N,))."""
        return (np.stack(self.transforms).astype(np.float32),
                np.asarray(self.mesh_ids, np.int32),
                np.asarray(self.material_ids, np.int32))


def area_light(scene: Scene, quad_mesh: int, color, intensity, wh,
               transform):
    """An area light and its emissive quad instance, as the program's
    World.add_area_light adds them (app.rs:220-236); `quad_mesh` is the
    recipe's own vertical unit plane."""
    pts = area_light_points(wh, transform)
    scene.area_lights.append((np.asarray(color, np.float32),
                              float(intensity), pts))
    wh = np.asarray(wh, np.float32)
    scale = np.diag([wh[0] / 2.0, wh[1] / 2.0, 1.0, 1.0]).astype(np.float32)
    scene.add_instance(np.asarray(transform, np.float32) @ scale, quad_mesh,
                       LIGHT_MATERIAL)


def to_world(scene: Scene):
    """The program's World holding `scene`: the recipe's meshes, textures
    and materials appended after the pools' reserved entries (so every id
    is the scene's), then its instances and lights, then its skins as the
    program's glTF importer binds them (io/gltf.py bind_skins): each
    skin's joint rows allocated in the scene's order and its SkinData
    built with the mesh's BVH, so that the BLAS and TLAS are refit to
    the pose."""
    from voidin_tpu_torch.scene import skin as skin_mod
    from voidin_tpu_torch.scene.mesh import Mesh
    from voidin_tpu_torch.scene.scene import World

    w = World()
    if len(w.meshes) != 4 or len(w.textures) != 4 or len(w.materials) != 3:
        raise RuntimeError("the program's pools no longer start with the "
                           "reserved entries the scene mirrors")
    for m in scene.meshes[4:]:
        w.meshes.add(Mesh(m.vertices, m.normals, m.tangents, m.uvs,
                          m.indices))
    for base, lods in scene.lods.items():
        w.meshes.set_lods(base, list(lods))
    for img, srgb in scene.textures[4:]:
        w.textures.add(img, srgb=srgb)
    for mat in scene.materials[3:]:
        w.materials.add(**mat)
    for t, m, mat in zip(scene.transforms, scene.mesh_ids,
                         scene.material_ids):
        w.instances.add(t, m, mat)
    for pos, radius, color in scene.point_lights:
        w.lights.add_point_light(pos, radius, color)
    for color, intensity, pts in scene.area_lights:
        w.lights.add_area_light(color, intensity, pts)
    pool = w.meshes
    for sk in scene.skins:
        info = pool.mesh_info[sk.mesh]
        view = Mesh(pool.positions[sk.mesh], pool.normals[sk.mesh],
                    pool.tangents[sk.mesh], pool.uvs[sk.mesh],
                    pool.indices[sk.mesh])
        n = len(sk.joint_list)
        w.skins.append(skin_mod.build_skin_data(
            view, pool.indices[sk.mesh], sk.joints, sk.weights,
            base_tri=info["base_index"] // 3, mesh_id=sk.mesh,
            joint_offset=w.allocate_joints(n), n_joints=n,
            nodes=pool.bvh_nodes[sk.mesh], bvh_base=info["bvh_index"]))
    return w
