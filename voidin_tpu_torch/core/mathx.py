"""Host/device math helpers (4x4 matrix conventions, projections, frustum).

Conventions
-----------
* Matrices are (4, 4) arrays acting on *column* vectors: ``clip = P @ V @ p``.
* Right-handed world space, camera looks down -Z in view space.
* Reverse-Z infinite projection (near plane maps to ndc.z = 1, infinity to 0),
  mirroring the reference renderer's camera contract
  (reference crates/components/src/camera.rs:128-133).

Host-side numpy helpers: scene assembly and the camera rig build their
matrices here; the device passes carry their own torch forms.
"""

from __future__ import annotations

import numpy as np

PI = float(np.pi)
TAU = 2.0 * PI
EPS = 1e-5
MAX_DIST = 1e30


def _f32(x, xp):
    return xp.asarray(x, dtype=xp.float32)


def normalize(v, xp=np):
    v = _f32(v, xp)
    return v / xp.linalg.norm(v)


def look_at_rh(eye, center, up, xp=np):
    """Right-handed look-at view matrix (world -> view)."""
    eye = _f32(eye, xp)
    f = normalize(_f32(center, xp) - eye, xp)  # forward
    s = normalize(xp.cross(f, _f32(up, xp)), xp)  # right
    u = xp.cross(s, f)
    m = xp.stack(
        [
            xp.concatenate([s, xp.reshape(-xp.dot(s, eye), (1,))]),
            xp.concatenate([u, xp.reshape(-xp.dot(u, eye), (1,))]),
            xp.concatenate([-f, xp.reshape(xp.dot(f, eye), (1,))]),
            _f32([0.0, 0.0, 0.0, 1.0], xp),
        ]
    )
    return m.astype(xp.float32)


def perspective_infinite_reverse_rh(fovy: float, aspect: float, znear: float, xp=np):
    """Infinite reverse-Z perspective: ndc.z = znear / depth.

    Matches glam's ``Mat4::perspective_infinite_reverse_rh`` used by the
    reference (camera.rs:131).
    """
    f = 1.0 / float(np.tan(0.5 * fovy))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 3] = znear
    m[3, 2] = -1.0
    return xp.asarray(m)


def from_rotation_x(angle, xp=np):
    c, s = xp.cos(angle), xp.sin(angle)
    zero = xp.zeros_like(c)
    one = xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([one, zero, zero, zero]),
            xp.stack([zero, c, -s, zero]),
            xp.stack([zero, s, c, zero]),
            xp.stack([zero, zero, zero, one]),
        ]
    ).astype(xp.float32)


def from_rotation_y(angle, xp=np):
    c, s = xp.cos(angle), xp.sin(angle)
    zero = xp.zeros_like(c)
    one = xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([c, zero, s, zero]),
            xp.stack([zero, one, zero, zero]),
            xp.stack([-s, zero, c, zero]),
            xp.stack([zero, zero, zero, one]),
        ]
    ).astype(xp.float32)


def from_rotation_z(angle, xp=np):
    c, s = xp.cos(angle), xp.sin(angle)
    zero = xp.zeros_like(c)
    one = xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([c, -s, zero, zero]),
            xp.stack([s, c, zero, zero]),
            xp.stack([zero, zero, one, zero]),
            xp.stack([zero, zero, zero, one]),
        ]
    ).astype(xp.float32)


def from_translation(t, xp=np):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return xp.asarray(m)


def from_scale(s, xp=np):
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m = np.diag(np.concatenate([s, [np.float32(1.0)]]).astype(np.float32))
    return xp.asarray(m)


def extract_scale(m, xp=np):
    """Per-axis scale = column norms of the upper 3x3 (math.wgsl extract_scale).

    ``m`` may be a single (4,4) matrix or a batch (..., 4, 4).
    """
    m = _f32(m, xp)
    basis = m[..., :3, :3]
    return xp.sqrt(xp.sum(basis * basis, axis=-2))


def transform_point(m, p, xp=np):
    """Apply (...,4,4) @ (...,3) point (w=1), returns (...,3)."""
    m = _f32(m, xp)
    p = _f32(p, xp)
    res = xp.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]
    return res


def transform_dir(m, d, xp=np):
    m = _f32(m, xp)
    d = _f32(d, xp)
    return xp.einsum("...ij,...j->...i", m[..., :3, :3], d)


def yaw_pitch_quat_forward(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """Forward vector of a yaw/pitch camera (yaw about +Y, then pitch about +X).

    yaw = 0, pitch = 0 looks down -Z, matching the dolly YawPitch rig
    the reference uses (camera.rs:113-127).
    """
    yaw = np.deg2rad(yaw_deg)
    pitch = np.deg2rad(pitch_deg)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # Ry(yaw) @ Rx(pitch) @ (0, 0, -1)
    f = np.array([-sy * cp, sp, -cy * cp], dtype=np.float32)
    return f


def radical_inverse(n: int, base: int) -> float:
    """Van der Corput radical inverse, float32 semantics of taa.rs:29-42."""
    val = np.float32(0.0)
    inv_base = np.float32(1.0 / base)
    inv_bi = inv_base
    while n > 0:
        d_i = n % base
        val += np.float32(d_i) * inv_bi
        n = int(np.float32(n) * inv_base)
        inv_bi *= inv_base
    return float(val)
