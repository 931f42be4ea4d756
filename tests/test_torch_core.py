"""Port parity: voidin_tpu_torch.core against voidin_tpu.core.

Encodings are bit-exact; the small-matrix helpers, the camera uniform, the
jitter schedule and the compaction order are exact too (same operations in
the same order; the JAX side runs op by op, unfused).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voidin_tpu.core import camera as j_camera
from voidin_tpu.core import color as j_color
from voidin_tpu.core import encoding as j_enc
from voidin_tpu.core import fastmath as j_fm
from voidin_tpu.core import jitter as j_jitter

from voidin_tpu_torch.core import camera as t_camera
from voidin_tpu_torch.core import color as t_color
from voidin_tpu_torch.core import encoding as t_enc
from voidin_tpu_torch.core import fastmath as t_fm
from voidin_tpu_torch.core import jitter as t_jitter

torch.set_num_threads(2)


def _normals(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    v = np.concatenate([v, axes, np.array([[0, 0, -1e-3], [1e-3, 0, -1]],
                                          np.float32)])
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_octahedral_encode_bit_exact():
    n = _normals(np.random.default_rng(0), 20000)
    want = np.asarray(j_enc.encode_octahedral_32(jnp.asarray(n)))
    got = t_enc.as_u32_np(t_enc.encode_octahedral_32(torch.from_numpy(n)))
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(t_enc.encode_octahedral_32_np(n), want)


def test_octahedral_decode_bit_exact():
    bits = np.random.default_rng(1).integers(0, 2**32, 20000,
                                             dtype=np.uint64)
    bits = np.concatenate([bits, [0, 0xFFFFFFFF, 0x7FFF7FFF, 0x80008000]])
    bits = bits.astype(np.uint32)
    want = np.asarray(j_enc.decode_octahedral_32(jnp.asarray(bits)))
    got = t_enc.decode_octahedral_32(
        torch.from_numpy(bits.view(np.int32))).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_pack2x16float_bit_exact():
    rng = np.random.default_rng(2)
    v = np.concatenate([
        rng.uniform(-2, 2, (10000, 2)),
        rng.standard_normal((1000, 2)) * 1e5,
        rng.standard_normal((1000, 2)) * 1e-6,
        [[0.0, -0.0], [65504.0, 65520.0], [np.inf, -np.inf]],
    ]).astype(np.float32)
    want = np.asarray(j_enc.pack2x16float(jnp.asarray(v)))
    got = t_enc.as_u32_np(t_enc.pack2x16float(torch.from_numpy(v)))
    np.testing.assert_array_equal(want, got)


def test_unpack2x16float_bit_exact():
    bits = np.random.default_rng(3).integers(0, 2**32, 20000,
                                             dtype=np.uint64).astype(np.uint32)
    want = np.asarray(j_enc.unpack2x16float(jnp.asarray(bits)))
    got = t_enc.unpack2x16float(torch.from_numpy(bits.view(np.int32))).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_array_equal(want[finite], got[finite])


@pytest.mark.parametrize("n,size", [(1000, 300), (777, 777), (50, 80)])
def test_compact_indices_order(n, size):
    mask = np.random.default_rng(n).uniform(size=n) < 0.3
    want = np.asarray(j_fm.compact_indices(jnp.asarray(mask), size))
    got = t_fm.compact_indices(torch.from_numpy(mask), size).numpy()
    np.testing.assert_array_equal(want, got)


def test_small_matrix_helpers_exact():
    rng = np.random.default_rng(4)
    m3 = rng.standard_normal((500, 3, 3)).astype(np.float32)
    b3 = rng.standard_normal((500, 3, 3)).astype(np.float32)
    v3 = rng.standard_normal((500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(j_fm.mat3_vec(jnp.asarray(m3), jnp.asarray(v3))),
        t_fm.mat3_vec(torch.from_numpy(m3), torch.from_numpy(v3)).numpy())
    np.testing.assert_array_equal(
        np.asarray(j_fm.mat3_mat3(jnp.asarray(m3), jnp.asarray(b3))),
        t_fm.mat3_mat3(torch.from_numpy(m3), torch.from_numpy(b3)).numpy())
    m4 = rng.standard_normal((4, 4)).astype(np.float32)
    x, y, z = (rng.standard_normal((30, 40)).astype(np.float32)
               for _ in range(3))
    want = j_fm.const_mat4_point4(jnp.asarray(m4), jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(z))
    got = t_fm.const_mat4_point4(m4, torch.from_numpy(x),
                                 torch.from_numpy(y), torch.from_numpy(z))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the (4,4) @ (N,4,4) product rounds like the JAX package's dot
    t = rng.standard_normal((300, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(j_fm.compose_mat4(jnp.asarray(m4), jnp.asarray(t))),
        t_fm.compose_mat4(torch.from_numpy(m4), torch.from_numpy(t)).numpy())


def test_color_transforms_exact():
    c = np.random.default_rng(5).uniform(0, 4, (64, 64, 3)).astype(np.float32)
    for jf, tf in ((j_color.rgb_to_ycbcr, t_color.rgb_to_ycbcr),
                   (j_color.ycbcr_to_rgb, t_color.ycbcr_to_rgb),
                   (j_color.calculate_luma, t_color.calculate_luma)):
        np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(c))),
                                      tf(torch.from_numpy(c)).numpy())


def test_camera_uniform_and_jitter_exact():
    js, ts = j_jitter.JitterSequence(), t_jitter.JitterSequence()
    jprev = tprev = None
    jc = j_camera.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0, aspect=1.7)
    tc = t_camera.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0, aspect=1.7)
    for frame in range(40):
        jc.jitter = js.get_jitter(frame, 160, 96)
        tc.jitter = ts.get_jitter(frame, 160, 96)
        np.testing.assert_array_equal(jc.jitter, tc.jitter)
        jc.yaw = tc.yaw = frame * 0.7
        jc.update(1 / 60)
        tc.update(1 / 60)
        ju, tu = jc.uniform(previous=jprev), tc.uniform(previous=tprev)
        for f in ("position", "projection", "view", "clip_to_world",
                  "prev_world_to_clip", "frustum", "jitter", "prev_jitter"):
            np.testing.assert_array_equal(np.asarray(getattr(ju, f)),
                                          getattr(tu, f), err_msg=f)
        jprev, tprev = ju, tu
