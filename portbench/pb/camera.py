"""Camera math of the benchmark: frozen copies of the program's
core/camera.py build_uniform, core/mathx.py look_at_rh,
perspective_infinite_reverse_rh, yaw_pitch_quat_forward and
radical_inverse, and core/jitter.py JitterSequence (upstream camera.rs,
taa.rs). The reference renders with these, never with the program's."""

import numpy as np

ZNEAR = 0.001
FOVY = float(np.pi) / 2.0
N_JITTER = 16


def _normalize(v):
    return v / np.linalg.norm(v)


def forward(yaw_deg, pitch_deg):
    yaw, pitch = np.deg2rad(yaw_deg), np.deg2rad(pitch_deg)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    return np.array([-sy * cp, sp, -cy * cp], np.float32)


def look_at(eye, center, up):
    eye = np.asarray(eye, np.float32)
    f = _normalize(np.asarray(center, np.float32) - eye)
    s = _normalize(np.cross(f, np.asarray(up, np.float32)))
    u = np.cross(s, f)
    return np.stack([
        np.concatenate([s, [-np.dot(s, eye)]]),
        np.concatenate([u, [-np.dot(u, eye)]]),
        np.concatenate([-f, [np.dot(f, eye)]]),
        np.array([0.0, 0.0, 0.0, 1.0], np.float32),
    ]).astype(np.float32)


def projection(aspect, znear=ZNEAR, fovy=FOVY):
    f = 1.0 / float(np.tan(0.5 * fovy))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 3] = znear
    m[3, 2] = -1.0
    return m


def radical_inverse(n, base):
    val = np.float32(0.0)
    inv_base = np.float32(1.0 / base)
    inv_bi = inv_base
    while n > 0:
        d_i = n % base
        val += np.float32(d_i) * inv_bi
        n = int(np.float32(n) * inv_base)
        inv_bi *= inv_base
    return float(val)


def jitter(frame, width, height):
    """The TAA jitter of `frame` (pixels / resolution): the 16-sample
    Halton(2, 3) cycle, reshuffled at each new cycle by a generator
    seeded with the frame index until its first sample differs from the
    last one before (taa.rs:229-238, 284-299)."""
    samples = np.array(
        [[radical_inverse(i % N_JITTER + 1, 2) * 2.0 - 1.0,
          radical_inverse(i % N_JITTER + 1, 3) * 2.0 - 1.0]
         for i in range(N_JITTER)], np.float32)
    for f in range(N_JITTER, frame + 1, N_JITTER):
        rng = np.random.default_rng(f)
        prev = samples[-1].copy()
        while True:
            rng.shuffle(samples)
            if not np.array_equal(samples[0], prev):
                break
    s = samples[frame % N_JITTER]
    return (s / np.array([width, height], np.float32)).astype(np.float32)


class Uniform:
    """The per-frame camera block (camera.rs:15-27, 135-169)."""

    def __init__(self, position, yaw, pitch, aspect, jit, previous=None):
        pos = np.asarray(position, np.float32)
        self.view = look_at(pos, pos + forward(yaw, pitch), [0.0, 1.0, 0.0])
        proj = projection(aspect)
        jit = np.asarray(jit, np.float32)
        proj[0, 2] += jit[0]
        proj[1, 2] += jit[1]
        self.projection = proj
        self.jitter = jit
        pv = proj @ self.view
        self.clip_to_world = np.linalg.inv(pv).astype(np.float32)
        fx = proj[3] + proj[0]
        fx = fx / np.linalg.norm(fx)
        fy = proj[3] + proj[1]
        fy = fy / np.linalg.norm(fy)
        self.frustum = np.array([fx[0], fx[2], fy[1], fy[2]], np.float32)
        if previous is not None:
            self.prev_world_to_clip = (previous.projection
                                       @ previous.view).astype(np.float32)
            self.prev_jitter = previous.jitter
        else:
            self.prev_world_to_clip = pv.astype(np.float32)
            self.prev_jitter = np.zeros(2, np.float32)
        self.position = pos
        self.znear = np.float32(ZNEAR)
