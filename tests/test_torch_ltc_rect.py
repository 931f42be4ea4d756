"""Port parity: the fused LTC rect-light evaluation's twin
(voidin_tpu_torch.ops.ltc_rect.ltc_rect_terms_reference) against the JAX
package's ltc_matrix and per-light ltc_evaluate_rect
(voidin_tpu/passes/shading.py:191, :277), with the LUT fetches through
K3's Pallas kernel in interpret mode, in f32 and with LTC_LUT_BF16.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voidin_tpu.passes import shading as j_shading

from voidin_tpu_torch.ops import ltc_rect as t_ltc
from voidin_tpu_torch.scene.ltc import load_ltc_tables

torch.set_num_threads(2)
H, W = 96, 160
KEYS = ("nor", "rd", "pos", "rough", "points", "ltc1", "ltc2")


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _fields(seed):
    """Per-pixel fields at the golden 160x96 size from a seed, with the
    edge cases of a real frame: pixels in front of and behind each light's
    plane, a row of background pixels (pos clamped to +-1e12, as
    world_position_from_depth leaves depth 0), and roughness 0 and 1 (uv
    on the table's edge)."""
    rng = np.random.default_rng(seed)
    nor = _unit(rng.standard_normal((H, W, 3)))
    rd = _unit(rng.standard_normal((H, W, 3)))
    pos = rng.uniform(-8.0, 8.0, (H, W, 3)).astype(np.float32)
    pos[2] = np.where(rng.uniform(size=(W, 3)) < 0.5, -1e12, 1e12)
    rough = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    rough[0], rough[1] = 0.0, 1.0
    # two 4x4 rect lights above the field: one facing down, one tilted
    quad = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
                    np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    tilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    points = np.stack([quad + [0.0, 6.0, 0.0],
                       quad @ tilt.T + [3.0, 2.0, -1.0]]).astype(np.float32)
    ltc1, ltc2 = load_ltc_tables()
    return dict(nor=nor, rd=rd, pos=pos, rough=rough, points=points,
                ltc1=ltc1, ltc2=ltc2)


def _jax_terms(f):
    """shade's full-resolution area-light loop in the JAX package
    (shading.py:492-505): (diff, spec * t2.x) per light."""
    scene = types.SimpleNamespace(ltc1=jnp.asarray(f["ltc1"]),
                                  ltc2=jnp.asarray(f["ltc2"]))
    nor, rd, pos = (jnp.asarray(f[k]) for k in ("nor", "rd", "pos"))
    minv, _t1, t2 = j_shading.ltc_matrix(scene, nor, rd,
                                         jnp.asarray(f["rough"]))
    identity = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), minv.shape)
    diffs, specs = [], []
    for pts in jnp.asarray(f["points"]):
        diffs.append(j_shading.ltc_evaluate_rect(scene, nor, rd, pos,
                                                 identity, pts))
        specs.append(j_shading.ltc_evaluate_rect(scene, nor, rd, pos, minv,
                                                 pts) * t2[..., 0])
    return np.stack(diffs), np.stack(specs)


def _torch_fields(f):
    return [torch.from_numpy(f[k]) for k in KEYS]


# Tolerances (values are O(1) irradiance terms). The twin rounds every
# step separately; the JAX chain runs jnp.cross jitted, where XLA
# contracts each component into an FMA (SKILL.md "Parity gotchas"), in
# the basis, the light normal and every edge integral, and its fetch runs
# the Pallas kernel compiled in interpret mode. One rounding apart in a
# cross product grows where a light is seen nearly edge-on and the four
# edge integrals cancel: 3.5e-6 at most on these fields (my CPU run), so
# 1e-5. With LTC_LUT_BF16 the same last-bit difference in a row weight can
# round to the neighbouring bf16 step (2^-8 relative): 1.5e-4 at most, so
# 5e-4. In both, most values agree exactly (median difference 0).
TOL = {False: 1e-5, True: 5e-4}


@pytest.mark.parametrize("bf16", [False, True])
def test_twin_matches_jax(monkeypatch, bf16):
    monkeypatch.setattr(j_shading, "LTC_FETCH_PALLAS", "interpret")
    monkeypatch.setattr(j_shading, "LTC_LUT_BF16", bf16)
    f = _fields(7)
    want = _jax_terms(f)
    got = t_ltc.ltc_rect_terms_reference(*_torch_fields(f), bf16=bf16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, H, W) and np.isfinite(w).all()
        err = np.abs(g.numpy() - w)
        assert err.max() <= TOL[bf16], err.max()
        assert np.median(err) == 0.0


def test_fields_cover_the_edge_cases():
    """On the test's fields the twin sees both sides of each light, the
    background row and the table's edge, and stays finite there."""
    f = _fields(7)
    nor, rd, pos, rough, points, ltc1, ltc2 = _torch_fields(f)
    diff, spec = t_ltc.ltc_rect_terms_reference(nor, rd, pos, rough, points,
                                                ltc1, ltc2)
    assert torch.isfinite(diff).all() and torch.isfinite(spec).all()
    for pts, d in zip(points, diff):
        normal = torch.linalg.cross(pts[1] - pts[0], pts[3] - pts[0])
        behind = ((pts[0] - pos) * normal).sum(-1) < 0
        assert behind.any() and (~behind).any()
        assert (d[behind] == 0).all() and (d[~behind] != 0).any()
        # a background pixel (1e12 away) sees the light as a point
        assert d[2].abs().max() < 1e-6
    u = rough[:2] * t_ltc.LUT_SCALE + t_ltc.LUT_BIAS
    assert float(u[0].max()) * 64 - 0.5 == 0.0  # first column exactly
    assert float(u[1].min()) * 64 - 0.5 == 63.0  # last column exactly


def test_wrapper_on_cpu_is_the_twin():
    f = _fields(11)
    before = (t_ltc.LAUNCHES, t_ltc.LAUNCHES_BF16)
    for bf16 in (False, True):
        got = t_ltc.ltc_rect_terms(*_torch_fields(f), bf16=bf16)
        want = t_ltc.ltc_rect_terms_reference(*_torch_fields(f), bf16=bf16)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (t_ltc.LAUNCHES, t_ltc.LAUNCHES_BF16) == before
