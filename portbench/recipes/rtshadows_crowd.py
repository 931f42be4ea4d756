"""A walking crowd under raytraced shadows: configuration 5's scene
(recipes/rtshadows.py, unchanged) and a grid of skinned humanoids, each
its own mesh and its own skin (a skin poses every instance of its mesh),
walking in place on the ground, every one out of step with the others.

The humanoid has the 55 bones of Unity's Mecanim humanoid avatar
(HumanBodyBones): 25 of the body (hips, spine, chest, upper chest, neck,
head, jaw, two eyes, and per side a shoulder, upper arm, lower arm, hand,
upper leg, lower leg, foot and toes) and 30 of the fingers (3 a finger, 5
fingers a hand), listed parents first. In its bind pose it stands at the
origin, facing +z, 1.8 units tall, arms hanging; every joint's rest
rotation is the identity, and its inverse bind matrix is the inverse of
its bind-pose world transform. Its surface is closed parts: a torso and
a head turned about their vertical axes, and tapered tubes along the
bones (neck, jaw, eyes, arms, palms, finger segments, legs, feet, toes),
each capped at both ends, `params["parts"]` giving each part's sides and
segments.

The weights are glTF's JOINTS_0 / WEIGHTS_0, four a vertex: of the bones
of the vertex's part, their parents and their children, the four whose
segments lie nearest, each weighted by exp(-((d - d_min) / s)^2), d its
distance to the segment, d_min the nearest's and s = falloff * d_min +
0.002 (so a torso blends over its spine and a limb near its joints), the
weights under `min_weight` of the largest dropped and the rest
normalised.

The clip is one in-place walk: 16 LINEAR keys `frames_per_key` frames
apart, the last the first again, period (16 - 1) * frames_per_key frames.
Key i samples the walk at phase 2 pi i / 15: the hips bob and sway, the
legs swing with the knees bending, the arms swing against the legs, the
spine and neck twist, the fingers curl. Character c's key k is the
walk's key (k + 7 c) mod 15, so the characters walk out of step; no joint
drifts, so each lap closes.

The characters stand on a grid (`grid` columns by rows, `spacing` apart,
centred on `grid_center`) on the ground, each turned by a yaw and scaled
within `scale_range`, both drawn from `layout_seed`. The run's seed draws
only what rtshadows draws (the order of its instances, the light's
colour): the crowd, its geometry and its walk are the same for every
seed.
"""

import numpy as np

from pb import animation
from pb import scene as sc
from recipes import rtshadows

# (name, parent name, bind-pose world position); parents first
_BODY = [
    ("hips", None, (0.0, 0.95, 0.0)),
    ("spine", "hips", (0.0, 1.05, 0.0)),
    ("chest", "spine", (0.0, 1.18, 0.0)),
    ("upper_chest", "chest", (0.0, 1.31, 0.0)),
    ("neck", "upper_chest", (0.0, 1.47, 0.0)),
    ("head", "neck", (0.0, 1.56, 0.0)),
    ("jaw", "head", (0.0, 1.60, 0.04)),
    ("left_eye", "head", (0.032, 1.67, 0.085)),
    ("right_eye", "head", (-0.032, 1.67, 0.085)),
]
_ARM = [  # the left side's (+x); the right side mirrors x
    ("shoulder", "upper_chest", (0.04, 1.43, 0.0)),
    ("upper_arm", "shoulder", (0.17, 1.43, 0.0)),
    ("lower_arm", "upper_arm", (0.22, 1.15, 0.0)),
    ("hand", "lower_arm", (0.25, 0.90, 0.0)),
]
# per finger: its proximal joint, the direction it points, its three
# segments' lengths
_FINGERS = [
    ("thumb", (0.245, 0.875, 0.035), (0.0, -0.6, 0.8), (0.035, 0.03, 0.025)),
    ("index", (0.255, 0.815, 0.030), (0.0, -1.0, 0.0), (0.040, 0.025, 0.020)),
    ("middle", (0.257, 0.810, 0.010), (0.0, -1.0, 0.0), (0.042, 0.027, 0.021)),
    ("ring", (0.255, 0.813, -0.010), (0.0, -1.0, 0.0), (0.040, 0.025, 0.020)),
    ("little", (0.252, 0.820, -0.028), (0.0, -1.0, 0.0), (0.032, 0.020, 0.017)),
]
_SEGMENTS = ("proximal", "intermediate", "distal")
_LEG = [
    ("upper_leg", "hips", (0.10, 0.92, 0.0)),
    ("lower_leg", "upper_leg", (0.10, 0.51, 0.0)),
    ("foot", "lower_leg", (0.10, 0.09, 0.0)),
    ("toes", "foot", (0.10, 0.025, 0.13)),
]
# where a bone's segment ends, for the bones with no child or whose
# segment does not end at their first child
_TIPS = {"head": (0.0, 1.78, 0.0), "jaw": (0.0, 1.585, 0.10),
         "left_eye": (0.032, 1.67, 0.105), "right_eye": (-0.032, 1.67, 0.105),
         "hips": (0.0, 1.05, 0.0), "upper_chest": (0.0, 1.47, 0.0),
         "left_hand": (0.257, 0.815, 0.0), "right_hand": (-0.257, 0.815, 0.0),
         "left_toes": (0.10, 0.025, 0.20), "right_toes": (-0.10, 0.025, 0.20)}


def skeleton_layout():
    """([names], [parent index or -1], (J, 3) bind-pose world positions,
    (J, 3) each bone's segment end), parents first: the 25 body joints
    and 30 finger joints of the humanoid."""
    rows = list(_BODY)
    tips = dict(_TIPS)
    for side, sx in (("left", 1.0), ("right", -1.0)):
        def p(v):
            return (sx * v[0], v[1], v[2])

        for name, parent, pos in _ARM:
            par = parent if parent == "upper_chest" else f"{side}_{parent}"
            rows.append((f"{side}_{name}", par, p(pos)))
        for finger, base, direction, lengths in _FINGERS:
            d = np.asarray(direction) / np.linalg.norm(direction)
            at = np.asarray(p(base), np.float64)
            d = d * np.array([sx, 1.0, 1.0])
            parent = f"{side}_hand"
            for seg, length in zip(_SEGMENTS, lengths):
                name = f"{side}_{finger}_{seg}"
                rows.append((name, parent, tuple(at)))
                at = at + d * length
                tips[name] = tuple(at)
                parent = name
        for name, parent, pos in _LEG:
            par = parent if parent == "hips" else f"{side}_{parent}"
            rows.append((f"{side}_{name}", par, p(pos)))
    names = [r[0] for r in rows]
    parents = [-1 if r[1] is None else names.index(r[1]) for r in rows]
    pos = np.array([r[2] for r in rows], np.float64)
    ends = pos.copy()
    for j, name in enumerate(names):
        kids = [k for k, par in enumerate(parents) if par == j]
        if name in tips:
            ends[j] = tips[name]
        elif kids:
            ends[j] = pos[kids[0]]
    return names, parents, pos, ends


def _frame(axis, ref):
    """Unit (u, v) perpendicular to `axis`, u along `ref`'s part
    perpendicular to it, u x v = axis."""
    d = axis / np.linalg.norm(axis)
    u = ref - (ref @ d) * d
    u = u / np.linalg.norm(u)
    return u, np.cross(d, u)


def lathe(p0, p1, ru, rv, sides, segments, ref=(1.0, 0.0, 0.0),
          poles=(0.0, 0.0)):
    """A closed surface about the segment p0 -> p1: segments + 1 rings of
    `sides` vertices, ring i at t = i / segments with radii ru(t), rv(t)
    along u and v (_frame), and a cap at each end, its centre `poles`
    beyond the end rings along the axis. Outward winding, as
    pb/scene.py's meshes have it. (vertices (V, 3), triangles (T, 3))."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    axis = p1 - p0
    d = axis / np.linalg.norm(axis)
    u, v = _frame(axis, np.asarray(ref, np.float64))
    t = np.linspace(0.0, 1.0, segments + 1)
    a = 2.0 * np.pi * np.arange(sides) / sides
    ring = (p0 + t[:, None] * axis)[:, None, :] \
        + (ru(t)[:, None, None] * np.cos(a)[None, :, None] * u
           + rv(t)[:, None, None] * np.sin(a)[None, :, None] * v)
    verts = np.concatenate([ring.reshape(-1, 3),
                            [p0 - poles[0] * d, p1 + poles[1] * d]])
    i = np.arange(segments)[:, None]
    j = np.arange(sides)[None, :]
    a0, a1 = i * sides + j, i * sides + (j + 1) % sides
    b0, b1 = a0 + sides, a1 + sides
    side = np.stack([a0, a1, b0, a1, b1, b0], -1).reshape(-1, 3)
    c0, c1 = len(verts) - 2, len(verts) - 1
    j = np.arange(sides)
    top = segments * sides
    caps = np.concatenate([
        np.stack([np.full(sides, c0), (j + 1) % sides, j], -1),
        np.stack([np.full(sides, c1), top + j, top + (j + 1) % sides], -1)])
    return verts, np.concatenate([side, caps])


def _taper(r0, r1):
    return lambda t: r0 + (r1 - r0) * t


def _profile(knots):
    """Radii along a part from (t, radius) knots, linear between."""
    ts, rs = np.asarray(knots, np.float64).T
    return lambda t: np.interp(t, ts, rs)


def _ellipsoid(radius):
    return lambda t: radius * np.sqrt(np.clip(1.0 - (2.0 * t - 1.0) ** 2,
                                              0.0, None) * 0.96 + 0.04)


def body_parts(parts, names, pos, ends):
    """[(bone names the part follows, vertices, triangles)] of the
    humanoid's closed parts. `parts`: each part's [sides, segments]."""
    idx = {n: j for j, n in enumerate(names)}
    out = []

    def add(key, bones, p0, p1, ru, rv, ref=(1.0, 0.0, 0.0), poles=(0, 0)):
        s, n = parts[key]
        v, f = lathe(p0, p1, ru, rv, int(s), int(n), ref, poles)
        out.append((bones, v, f))

    torso_a = _profile([(0.0, 0.13), (0.17, 0.155), (0.32, 0.14),
                        (0.43, 0.135), (0.55, 0.15), (0.71, 0.165),
                        (0.83, 0.175), (0.92, 0.15), (1.0, 0.07)])
    torso_b = _profile([(0.0, 0.09), (0.17, 0.105), (0.32, 0.095),
                        (0.55, 0.105), (0.71, 0.11), (0.83, 0.10),
                        (0.92, 0.085), (1.0, 0.06)])
    add("torso", ["hips", "spine", "chest", "upper_chest"],
        (0.0, 0.84, 0.0), (0.0, 1.49, 0.0), torso_a, torso_b,
        poles=(0.02, 0.01))
    add("neck", ["neck"], (0.0, 1.44, 0.0), (0.0, 1.60, 0.0),
        _taper(0.055, 0.05), _taper(0.055, 0.05))
    add("head", ["head"], (0.0, 1.575, 0.01), (0.0, 1.795, 0.01),
        _ellipsoid(0.085), _ellipsoid(0.10), poles=(0.005, 0.005))
    add("jaw", ["jaw"], pos[idx["jaw"]], ends[idx["jaw"]],
        _taper(0.04, 0.025), _taper(0.03, 0.02), ref=(0.0, 1.0, 0.0))
    for side in ("left", "right"):
        eye = f"{side}_eye"
        add("eye", [eye], pos[idx[eye]], ends[idx[eye]], _taper(0.012, 0.01),
            _taper(0.012, 0.01))

        def bone(key, name, r0, r1, rv=None, ref=(0.0, 0.0, 1.0)):
            j = idx[f"{side}_{name}"]
            add(key, [f"{side}_{name}"], pos[j], ends[j], _taper(r0, r1),
                rv or _taper(r0, r1), ref=ref)

        bone("upper_arm", "upper_arm", 0.05, 0.04)
        bone("lower_arm", "lower_arm", 0.04, 0.03)
        # the palm: wide across the fingers (z), thin across the hand (x)
        bone("hand", "hand", 0.045, 0.04, _taper(0.018, 0.015))
        for finger, *_ in _FINGERS:
            for seg in _SEGMENTS:
                r = 0.009 if seg == "proximal" else 0.0075
                bone("finger", f"{finger}_{seg}", r, r * 0.85)
        bone("upper_leg", "upper_leg", 0.08, 0.055)
        bone("lower_leg", "lower_leg", 0.055, 0.04)
        bone("foot", "foot", 0.045, 0.035, ref=(1.0, 0.0, 0.0))
        bone("toes", "toes", 0.032, 0.02, ref=(1.0, 0.0, 0.0))
    return out


def _segment_distance(p, a, b):
    """(V, B) distances of points (V, 3) to segments a -> b (B, 3)."""
    ab = b - a
    t = np.einsum("vbk,bk->vb", p[:, None] - a[None], ab) \
        / np.maximum((ab * ab).sum(-1), 1e-12)
    q = a[None] + np.clip(t, 0.0, 1.0)[..., None] * ab[None]
    return np.linalg.norm(p[:, None] - q, axis=-1)


def part_weights(verts, bones, parents, pos, ends, falloff, min_weight):
    """(V, 4) joints and (V, 4) weights of a part's vertices: of its
    bones, their parents and their children, the four nearest by
    exp(-((d - d_min) / s)^2), s = falloff * d_min + 0.002; weights under
    min_weight of the largest dropped, the rest normalised to 1."""
    cand = set(bones)
    for j in bones:
        if parents[j] >= 0:
            cand.add(parents[j])
        cand.update(k for k, par in enumerate(parents) if par == j)
    cand = np.array(sorted(cand))
    d = _segment_distance(verts, pos[cand], ends[cand])
    dmin = d.min(1, keepdims=True)
    w = np.exp(-((d - dmin) / (falloff * dmin + 0.002)) ** 2)
    k = min(4, len(cand))
    top = np.argsort(-w, axis=1, kind="stable")[:, :k]
    tw = np.take_along_axis(w, top, 1)
    tw = np.where(tw >= min_weight * tw[:, :1], tw, 0.0)
    joints = np.zeros((len(verts), 4), np.int32)
    weights = np.zeros((len(verts), 4), np.float32)
    joints[:, :k] = cand[top]
    weights[:, :k] = tw / tw.sum(1, keepdims=True)
    joints[weights == 0.0] = 0
    return joints, weights


def vertex_normals(verts, tris):
    """Area-weighted vertex normals of a closed part."""
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)


def humanoid(params):
    """(MeshArrays, joints (V, 4), weights (V, 4), names, parents, (J, 3)
    bind-pose joint positions) of the bind-pose humanoid."""
    names, parents, pos, ends = skeleton_layout()
    idx = {n: j for j, n in enumerate(names)}
    vs, ns, fs, js, ws = [], [], [], [], []
    base = 0
    for bones, v, f in body_parts(params["parts"], names, pos, ends):
        jt, wt = part_weights(v, [idx[b] for b in bones], parents, pos, ends,
                              params["weight_falloff"], params["min_weight"])
        vs.append(v)
        ns.append(vertex_normals(v, f))
        fs.append(f + base)
        js.append(jt)
        ws.append(wt)
        base += len(v)
    v = np.concatenate(vs)
    n = np.concatenate(ns)
    # tangent: the horizontal direction about the vertical axis, as the
    # other meshes carry a unit tangent with handedness -1
    t = np.cross(np.array([0.0, 1.0, 0.0]), n)
    t = np.where(np.linalg.norm(t, axis=1, keepdims=True) > 1e-6, t,
                 np.array([1.0, 0.0, 0.0]))
    t = t / np.linalg.norm(t, axis=1, keepdims=True)
    tan = np.concatenate([t, -np.ones((len(v), 1))], 1)
    uv = np.stack([np.arctan2(v[:, 0], v[:, 2]) / (2 * np.pi) + 0.5,
                   v[:, 1] / 1.8], 1)
    mesh = sc._mesh(v, n, tan, uv, np.concatenate(fs).reshape(-1))
    return (mesh, np.concatenate(js), np.concatenate(ws), names, parents,
            pos)


def _quat(axis, deg):
    a = np.radians(deg) / 2.0
    q = np.zeros(4)
    q[axis] = np.sin(a)
    q[3] = np.cos(a)
    return q


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def euler(x=0.0, y=0.0, z=0.0):
    """The quaternion (x y z w) of Ry(y) Rx(x) Rz(z), degrees."""
    return _qmul(_qmul(_quat(1, y), _quat(0, x)), _quat(2, z))


def walk_pose(names, phase):
    """{joint name: (rotation quaternion, translation offset)} of the
    walk at `phase` (radians; one stride a lap). A side's swing is the
    other's negated; a downward limb swings forward (+z) under a
    negative rotation about x."""
    s, c = np.sin(phase), np.cos(phase)
    s2, c2 = np.sin(2 * phase), np.cos(2 * phase)
    pose = {
        "hips": (euler(2.0 * s2, 6.0 * s, 3.0 * c),
                 (0.02 * c, 0.02 * c2, 0.0)),
        "spine": (euler(2.0 + s2, -3.0 * s), None),
        "chest": (euler(1.0 + 0.5 * c2, -4.0 * s), None),
        "upper_chest": (euler(0.5 * s2, -3.0 * s, c), None),
        "neck": (euler(-2.0 + c2, 3.0 * s), None),
        "head": (euler(3.0 * s2, 2.0 * s), None),
        "jaw": (euler(2.0 + 1.5 * s2), None),
    }
    for side, k in (("left", 1.0), ("right", -1.0)):
        swing = k * s  # > 0: this side's leg forward, its arm back
        lift = ((1.0 + k * c) / 2.0) ** 2  # this leg's swing phase
        pose[f"{side}_eye"] = (euler(c, 3.0 * s), None)
        pose[f"{side}_shoulder"] = (euler(0.0, 0.0, k * (2.0 + 2.0 * s)),
                                    None)
        pose[f"{side}_upper_arm"] = (euler(22.0 * swing, 0.0, 4.0 * k), None)
        pose[f"{side}_lower_arm"] = (euler(-(15.0 - 10.0 * swing)), None)
        pose[f"{side}_hand"] = (euler(5.0 * swing, 0.0, 2.0 * k * c), None)
        for finger, *_ in _FINGERS:
            for n_seg, seg in enumerate(_SEGMENTS):
                curl = 12.0 + 4.0 * s + 3.0 * n_seg
                q = (euler(-curl) if finger == "thumb"
                     else euler(0.0, 0.0, -k * curl))
                pose[f"{side}_{finger}_{seg}"] = (q, None)
        pose[f"{side}_upper_leg"] = (euler(-25.0 * swing, 0.0, 2.0 * k * c),
                                     None)
        pose[f"{side}_lower_leg"] = (euler(5.0 + 35.0 * lift), None)
        pose[f"{side}_foot"] = (euler(10.0 * k * np.sin(phase + 0.5)), None)
        pose[f"{side}_toes"] = (euler(8.0 * (1.0 - lift)), None)
    missing = set(names) - set(pose)
    if missing:
        raise ValueError(f"the walk poses no {sorted(missing)}")
    return pose


def walk_keys(names, parents, pos, n_keys):
    """Translation (P, J, 3) and rotation (P, J, 4) of the walk's
    n_keys - 1 distinct keys: key i at phase 2 pi i / (n_keys - 1); a
    joint's translation is its rest offset from its parent plus the
    walk's offset."""
    distinct = n_keys - 1
    rest_t = np.array([pos[j] - (pos[p] if p >= 0 else 0.0)
                       for j, p in enumerate(parents)])
    tr = np.tile(rest_t, (distinct, 1, 1))
    rot = np.zeros((distinct, len(names), 4))
    for i in range(distinct):
        pose = walk_pose(names, 2.0 * np.pi * i / distinct)
        for j, name in enumerate(names):
            q, off = pose[name]
            rot[i, j] = q
            if off is not None:
                tr[i, j] += off
    return rest_t, tr, rot


def layout(params):
    """(N, 4, 4) float32 instance transforms of the crowd: the grid on the
    ground, each character turned by a yaw and scaled, both drawn from
    layout_seed."""
    cols, rows = params["grid"]
    cx, cz = params["grid_center"]
    sp = float(params["spacing"])
    rng = np.random.default_rng(params["layout_seed"])
    out = []
    for r in range(rows):
        for c in range(cols):
            yaw = float(rng.uniform(*params["yaw_range_deg"]))
            scale = float(rng.uniform(*params["scale_range"]))
            x = cx + (c - (cols - 1) / 2.0) * sp
            z = cz + (r - (rows - 1) / 2.0) * sp
            rot = np.eye(4, dtype=np.float32)
            a = np.radians(yaw)
            rot[0, 0], rot[0, 2] = np.cos(a), np.sin(a)
            rot[2, 0], rot[2, 2] = -np.sin(a), np.cos(a)
            out.append(sc.translation([x, params["ground_y"], z]) @ rot
                       @ sc.scaling(scale))
    return np.stack(out)


def build(params, seed):
    s = rtshadows.build(params, seed)
    crowd = params["crowd"]
    mesh, joints, weights, names, parents, pos = humanoid(crowd)
    want = crowd.get("triangles_per_character")
    if want is not None and len(mesh.indices) // 3 != int(want):
        raise ValueError(f"the humanoid has {len(mesh.indices) // 3} "
                         f"triangles, the configuration states {want}")
    n_keys = int(crowd["keys"])
    step = int(crowd["frames_per_key"])
    rest_t, key_t, key_r = walk_keys(names, parents, pos, n_keys)
    distinct = n_keys - 1
    unit_q = np.array([0.0, 0.0, 0.0, 1.0])
    mat = s.add_material()
    n_joints = len(names)
    # each joint's bind-pose world transform, composed from its rest
    # local transforms, parents first; its inverse is the inverse bind
    world = []
    for j, p in enumerate(parents):
        local = animation.trs(rest_t[j], unit_q, np.ones(3))
        world.append(local if p < 0 else world[p] @ local)
    inv_binds = [np.linalg.inv(w) for w in world]
    clip_t, clip_r = [], []
    for c, t in enumerate(layout(crowd)):
        m = s.add_mesh(sc._mesh(mesh.vertices, mesh.normals, mesh.tangents,
                                mesh.uvs, mesh.indices))
        s.add_instance(t, m, mat)
        first = len(s.skeleton)
        s.skins.append(sc.Skin(m, joints, weights,
                               list(range(first, first + n_joints))))
        for j in range(n_joints):
            s.skeleton.append(sc.Joint(
                -1 if parents[j] < 0 else first + parents[j], rest_t[j],
                unit_q, np.ones(3), inv_binds[j]))
        order = [(k + 7 * c) % distinct for k in range(n_keys)]
        clip_t.append(key_t[order])
        clip_r.append(key_r[order])
    s.clip = sc.Clip(
        times=np.arange(n_keys) * step * float(params["frame_s"]),
        translation=np.concatenate(clip_t, 1),
        rotation=np.concatenate(clip_r, 1),
        scale=np.ones((n_keys, len(s.skeleton), 3)),
        period_frames=distinct * step)
    return s
