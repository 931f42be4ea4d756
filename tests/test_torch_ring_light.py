"""Port parity: the exact ring and disk LTC lights
(voidin_tpu_torch.passes.shading ltc_matrix, _solve_cubic,
ltc_evaluate_disk, ltc_evaluate_ring2, ltc_evaluate_polygon,
ltc_apply_texture, shade_ring_light) against the JAX package, and the
golden ring_light frame.

One G-buffer feeds both packages: the golden ring_light scene
(tests/test_golden.py:164-196) rasterized and resolved by JAX at 160x96
(jitted), its leaves handed to the port. JAX runs the shading functions op
by op, as its example and golden do; its LUT fetches take the matmul form
(sample_lut_bilinear_mxu), the port's ltc_matrix takes K3's twin: the
fetched values agree to 1e-6. Tolerances (measured on this G-buffer on
the CPU): ltc_matrix 1e-6 absolute; the disk, ring and polygon terms and
the HDR 1e-5 relative to the field's largest magnitude (atan2 and cos of
two libraries, square roots near the ellipse's degenerate cases; the HDR
measured 9.7e-6); apply_texture 1e-6; the cubic's roots 1e-5 relative.
The port's ring_light example within the golden tests' 5e-3 sRGB mean of
the golden (measured 2.6e-7 on the PNGs).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.passes import cull as j_cull
from voidin_tpu.passes import raster as j_raster
from voidin_tpu.passes import resolve as j_resolve
from voidin_tpu.passes import shading as j_shading

import voidin_tpu_torch as pt
from voidin_tpu_torch.examples import ring_light as pt_ring
from voidin_tpu_torch.io.image import load_image
from voidin_tpu_torch.ops import lut_fetch as t_lut
from voidin_tpu_torch.passes import shading as t_shading
from voidin_tpu_torch.passes.gbuffer import GBuffer

from tests.test_golden import CFG, GOLDEN_DIR, H, W
from tests.test_torch_scene import port_scene

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
BUDGET = 5e-3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ring():
    """The golden ring scene's JAX G-buffer and the per-pixel fields
    shade_ring_light derives from it, on both packages."""
    js = pt_ring.ring_world(vt).device()
    cam = vt.Camera(**pt_ring.CAMERA, aspect=W / H).uniform()

    @jax.jit  # one compile of the interpret-mode raster: ~5 s, not ~45
    def gbuffer(s):
        draws = j_cull.emit_draws(s.meshes, s.instances, cam)
        vis = j_raster.rasterize(s.meshes, s.instances, draws, cam, CFG)
        return j_resolve.resolve_gbuffer(s, vis, cam, CFG), vis.overflow

    (gb, aux), overflow = gbuffer(js)
    assert int(overflow) == 0
    ps = port_scene(js)
    pgb = GBuffer(normal_uv=_t(gb.normal_uv).view(torch.int32),
                  material=_t(gb.material), depth=_t(gb.depth))
    pcam = pt.Camera(**pt_ring.CAMERA, aspect=W / H).uniform()
    nor = t_shading.encoding.decode_octahedral_32(pgb.normal_uv[..., 0])
    pos = t_shading.world_position_from_depth(pgb.depth,
                                              pcam.clip_to_world)
    rd = t_shading.fastmath.normalize(
        torch.from_numpy(np.asarray(pcam.position, np.float32)[:3]) - pos)
    return dict(js=js, gb=gb, aux=aux, cam=cam, ps=ps, pgb=pgb, pcam=pcam,
                nor=nor, pos=pos, rd=rd)


def _close(got, want, rel=REL_TOL):
    got, want = got.numpy(), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= rel * scale, (err, scale)
    return err


def _jax(f, r, *args, **kw):
    """`f` on the JAX scene, tensors among `args` handed over as arrays."""
    return f(r["js"], *[jnp.asarray(x.numpy()) if torch.is_tensor(x) else x
                        for x in args], **kw)


def test_ltc_matrix_matches_jax(ring):
    r = ring
    rough = torch.full(r["pgb"].depth.shape, 0.3)
    before = t_lut.LAUNCHES
    minv, t1, t2 = t_shading.ltc_matrix(r["ps"], r["nor"], r["rd"], rough)
    assert t_lut.LAUNCHES == before  # CPU tensors: K3's twin
    jminv, jt1, jt2 = _jax(j_shading.ltc_matrix, r, r["nor"], r["rd"], rough)
    for a, b in ((minv, jminv), (t1, jt1), (t2, jt2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_disk_ring_and_polygon_match_jax(ring):
    r = ring
    rough = torch.full(r["pgb"].depth.shape, 0.3)
    minv, _, _ = t_shading.ltc_matrix(r["ps"], r["nor"], r["rd"], rough)
    L = pt_ring.LIGHT
    args = (L["disk_center"], L["disk_dirx"], L["disk_diry"], L["halfx"],
            L["halfy"])
    fields = (r["nor"], r["rd"], r["pos"], minv)
    for two_sided in (True, False):
        kw = dict(two_sided=two_sided)
        pts3 = t_shading.disk_points3(*args)
        np.testing.assert_array_equal(pts3, j_shading.disk_points3(*args))
        _close(t_shading.ltc_evaluate_disk(r["ps"], *fields, _t(pts3), **kw),
               _jax(j_shading.ltc_evaluate_disk, r, *fields, _t(pts3), **kw))
        _close(t_shading.ltc_evaluate_ring2(r["ps"], *fields, *args, **kw),
               _jax(j_shading.ltc_evaluate_ring2, r, *fields, *args, **kw))
        poly = t_shading.ring_points(L["disk_center"], [0, 1, 0.2], 2.0, 16)
        np.testing.assert_array_equal(
            poly, j_shading.ring_points(L["disk_center"], [0, 1, 0.2], 2.0,
                                        16))
        _close(t_shading.ltc_evaluate_polygon(r["ps"], *fields, _t(poly),
                                              **kw),
               _jax(j_shading.ltc_evaluate_polygon, r, *fields, _t(poly),
                    **kw))


def test_solve_cubic_matches_jax():
    """The cubics the disk solves, c0 = ab, c1 = ab (1 + x0^2 + y0^2) - a -
    b, c2 = 1 - a (1 + x0^2) - b (1 + y0^2), over ellipse parameters a, b
    in [0.01, 10] and x0, y0 in [-3, 3], and the degenerate ones of a
    background pixel (all-zero axes: x^3 + x^2, and x^3, where a -0 from
    torch.clamp would flip atan2): every root within 1e-5 relative of
    JAX's (measured 4.7e-7 on the CPU)."""
    rng = np.random.default_rng(3)
    a, b = np.exp(rng.uniform(np.log(0.01), np.log(10.0), (2, 4096)))
    x0, y0 = rng.uniform(-3.0, 3.0, (2, 4096))
    c = np.stack([a * b, a * b * (1 + x0 * x0 + y0 * y0) - a - b,
                  1 - a * (1 + x0 * x0) - b * (1 + y0 * y0)])
    c = np.concatenate([c, [[0.0, 0.0], [0.0, 0.0], [1.0, 0.0]]],
                       axis=1).astype(np.float32)
    got = t_shading._solve_cubic(*map(torch.from_numpy, c))
    want = j_shading._solve_cubic(*map(jnp.asarray, c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    assert float(got[1][-2]) == -1.0  # x^3 + x^2: the middle root


def test_shade_ring_light_matches_jax(ring):
    r = ring
    L = pt_ring.LIGHT
    hdr = t_shading.shade_ring_light(r["ps"], r["pgb"], r["pcam"], **L,
                                     albedo=_t(r["aux"].albedo))
    jhdr = j_shading.shade_ring_light(r["js"], r["gb"], r["cam"], **L,
                                      albedo=r["aux"].albedo)
    err = _close(hdr, jhdr)
    print(f"ring HDR max abs diff vs JAX {err:.3e}")


def test_ltc_apply_texture_matches_jax():
    """tests/test_ltc.py:341's quads (near, far, off the square) on both
    packages' texture pools."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (64, 64, 4)).astype(np.uint8)
    scenes = []
    for pkg in (vt, pt):
        w = pkg.World()
        tid = w.textures.add(img, srgb=True)
        scenes.append(w.device() if pkg is vt else w.device("cpu"))
    js, ps = scenes
    p0 = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    p1 = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    p2 = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    ids = np.full(256, tid, np.int32)
    for k in (1.0, 10.0):
        got = t_shading.ltc_apply_texture(ps, _t(ids), _t(p0 * k),
                                          _t(p1 * k), _t(p2 * k))
        want = j_shading.ltc_apply_texture(js, jnp.asarray(ids),
                                           *(jnp.asarray(p * k)
                                             for p in (p0, p1, p2)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_ring_light_example_matches_golden(tmp_path):
    """The port's example at 160x96 writes a PNG within the golden tests'
    5e-3 mean of tests/golden/ring_light.png, the JAX package's render of
    the same scene, camera and light at that size
    (tests/test_golden.py:164-196)."""
    out = tmp_path / "ring_light.png"
    pt_ring.main(["--cpu", "--width", str(W), "--height", str(H), "--out",
                  str(out)])
    got = load_image(str(out))[..., :3] / 255.0
    gold = load_image(os.path.join(GOLDEN_DIR, "ring_light.png"))
    diff = np.abs(got - gold[..., :3] / 255.0).mean()
    print(f"ring_light example vs golden: mean abs diff {diff:.3e}")
    assert got.shape == (H, W, 3) and got.std() > 0 and diff < BUDGET
