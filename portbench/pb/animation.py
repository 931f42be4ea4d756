"""Joint matrices of a scene's skins at a frame, from its skeleton and
looping clip (pb/scene.py Joint, Skin, Clip), as a glTF 2.0 player
computes them: each joint's local translation, rotation and scale sampled
from the clip (LINEAR: lerp for translation and scale, shortest-arc slerp
for rotation), local = T R S, world transforms composed parent before
child, and each row world @ inverse bind, the rows of every skin
concatenated in the order in which pb/scene.py to_world allocates them
(the scene's skins in order, each skin's joint list in order).

Composed in float64 and rounded to float32 once. Numpy only: it imports
nothing of the program, so that the program and the plain reference get
the same matrices, as they get the same camera from pb/camera.py.
"""

import numpy as np


def period(scene):
    """The frames in one lap of the scene's animation: the clip's period,
    1 for a scene without a clip (every frame the same pose)."""
    return int(scene.clip.period_frames) if scene.clip is not None else 1


def _sample(times, values, t):
    """(keys a, b, weight u) of the LINEAR sampler at time t, held at the
    first and last key outside them."""
    if t <= times[0]:
        return values[0], values[0], 0.0
    if t >= times[-1]:
        return values[-1], values[-1], 0.0
    i = int(np.searchsorted(times, t, side="right")) - 1
    return values[i], values[i + 1], (t - times[i]) / (times[i + 1]
                                                       - times[i])


def slerp(a, b, u):
    """Shortest-arc spherical interpolation of unit quaternions (x y z w),
    in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = float(a @ b)
    if d < 0.0:
        b, d = -b, -d
    if d > 1.0 - 1e-12:
        q = a + (b - a) * u
    else:
        th = np.arccos(d)
        q = (np.sin((1.0 - u) * th) * a + np.sin(u * th) * b) / np.sin(th)
    return q / np.linalg.norm(q)


def trs(translation, rotation, scale):
    """The (4, 4) float64 matrix T @ R @ S of a translation, a quaternion
    (x y z w; normalised here) and a scale."""
    x, y, z, w = np.asarray(rotation, np.float64) / np.linalg.norm(rotation)
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def local_transforms(scene, frame, dt):
    """Each skeleton joint's local (4, 4) float64 transform at `frame`:
    the clip sampled at (frame % period) * dt, or the rest pose without a
    clip."""
    clip = scene.clip
    if clip is None:
        return [trs(j.translation, j.rotation, j.scale)
                for j in scene.skeleton]
    t = (int(frame) % int(clip.period_frames)) * float(dt)
    times = np.asarray(clip.times, np.float64)
    out = []
    for j in range(len(scene.skeleton)):
        ta, tb, u = _sample(times, clip.translation[:, j], t)
        ra, rb, _ = _sample(times, clip.rotation[:, j], t)
        sa, sb, _ = _sample(times, clip.scale[:, j], t)
        ta, tb, sa, sb = (np.asarray(v, np.float64) for v in (ta, tb, sa, sb))
        out.append(trs(ta + (tb - ta) * u, slerp(ra, rb, u),
                       sa + (sb - sa) * u))
    return out


def joint_matrices(scene, frame, dt):
    """(J, 4, 4) float32: the joint matrices of every skin of `scene` at
    `frame` (frame step `dt` s), world @ inverse bind, in to_world's
    order. A joint's parent comes before it in the skeleton."""
    world = []
    for j, (joint, local) in enumerate(zip(scene.skeleton,
                                           local_transforms(scene, frame,
                                                            dt))):
        if joint.parent >= j:
            raise ValueError(f"joint {j}'s parent {joint.parent} does not "
                             "come before it")
        world.append(local if joint.parent < 0 else world[joint.parent]
                     @ local)
    rows = [world[j] @ np.asarray(scene.skeleton[j].inverse_bind, np.float64)
            for skin in scene.skins for j in skin.joint_list]
    return np.stack(rows).astype(np.float32)


def period_table(scene, dt):
    """(P, J, 4, 4) float32: joint_matrices of frames 0 .. P - 1, P the
    animation's period; frame f takes row f % P."""
    return np.stack([joint_matrices(scene, f, dt)
                     for f in range(period(scene))])
