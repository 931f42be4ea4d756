"""Port parity: closest-hit traversal (voidin_tpu_torch.rt.traverse
closest_hit_reference, the plain PyTorch twin of csrc/closest_hit.cu)
against the JAX package's closest_hit, jitted as examples/bvh_trace.py
runs it.

The port keeps JAX's per-ray stack walk and its push order, so every
output is compared exactly: t bit for bit, the per-ray visit counts, and
the overflow and exhausted counters. Scenes: examples/bvh_trace.py's (12
instances of the knot and the sphere) at 64x36 primary rays; the knot
scene of test_torch_traverse.py (rotated instances) with its coherent and
random rays, an active mask and per-ray t_max; a step limit of 3 with
rays exhausted; a tree deeper than STACK that overflows; and the
adversarial ray sets of chip_smoke.shadow_edge_case. Each package builds
the scene on its own World with the same BVH builder.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voidin_tpu as vt
from voidin_tpu.rt import traverse as j_trav

import voidin_tpu_torch as pt
from voidin_tpu_torch.examples import bvh_trace as pt_bvh_trace
from voidin_tpu_torch.io.image import load_image
from voidin_tpu_torch.ops import closest_hit as t_ch
from voidin_tpu_torch.rt import traverse as t_trav

from chip_smoke import SHADOW_EDGE_CASES, shadow_edge_case, staircase_case
from tests.test_torch_traverse import _knot_rays, _knot_world

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_closest(js, o, d, **kw):
    tlas, blas, inst, tri_pos = j_trav.scene_rays(js)
    t_max = kw.pop("t_max", j_trav.MAX_DIST)
    active = kw.pop("active", None)
    f = jax.jit(lambda o, d, t, a: j_trav.closest_hit(
        tlas, blas, inst, tri_pos, o, d, t_max=t, active=a, **kw))
    return f(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
             None if active is None else jnp.asarray(active))


def _port_closest(ps, o, d, t_max=t_trav.MAX_DIST, active=None, **kw):
    if not isinstance(t_max, float):
        t_max = torch.from_numpy(np.asarray(t_max, np.float32))
    return t_trav.closest_hit_reference(
        *t_trav.scene_rays(ps), torch.from_numpy(o), torch.from_numpy(d),
        t_max=t_max, active=None if active is None
        else torch.from_numpy(active), **kw)


def _assert_same(jr, pr):
    jt = np.asarray(jr.t)
    np.testing.assert_array_equal(pr.t.numpy().view(np.int32),
                                  jt.view(np.int32))
    np.testing.assert_array_equal(pr.visits.numpy(), np.asarray(jr.visits))
    assert int(pr.overflow) == int(jr.overflow)
    assert int(pr.exhausted) == int(jr.exhausted)


@pytest.fixture(scope="module")
def trace_scenes():
    """examples/bvh_trace.py's scene on both packages and its 64x36
    primary rays."""
    js = pt_bvh_trace.trace_world(vt).device(with_tlas=True)
    ps = pt_bvh_trace.trace_world(pt).device("cpu", with_tlas=True)
    o, d = pt_bvh_trace.primary_rays(64, 36)
    return js, ps, o, d


def test_tables_match_jax(trace_scenes):
    js, ps, _, _ = trace_scenes
    for a, b in zip(j_trav.scene_rays(js), t_trav.scene_rays(ps)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bvh_trace_rays_match_jax(trace_scenes):
    js, ps, o, d = trace_scenes
    jr = _jax_closest(js, o, d, t_max=1e6)
    pr, counts = _port_closest(ps, o, d, t_max=1e6)
    _assert_same(jr, pr)
    assert int(jr.overflow) == 0 and int(jr.exhausted) == 0
    hit = pr.t.numpy() < 1e6
    assert 0.05 < hit.mean() < 0.95
    assert counts.node_visits == int(pr.visits.sum())
    assert counts.instance_entries > 0 and counts.triangle_tests > 0


def test_step_limit_exhausts_rays(trace_scenes):
    """max_steps=3: every ray that reaches an instance is cut short."""
    js, ps, o, d = trace_scenes
    jr = _jax_closest(js, o, d, t_max=1e6, max_steps=3)
    pr, _ = _port_closest(ps, o, d, t_max=1e6, max_steps=3)
    _assert_same(jr, pr)
    assert int(pr.exhausted) > 0 and int(pr.visits.max()) == 3


def test_knot_scene_matches_jax():
    """Rotated instances (the transform's fused rounding), an active mask
    and a per-ray t_max."""
    jw, jrng = _knot_world(vt)
    pw, _ = _knot_world(pt)
    o, d, active = _knot_rays(jrng)
    t_max = np.where(np.arange(len(o)) % 3 == 0, 1.0, 1e30).astype(
        np.float32)
    js, ps = jw.device(with_tlas=True), pw.device("cpu", with_tlas=True)
    jr = _jax_closest(js, o, d, t_max=t_max, active=active)
    pr, _ = _port_closest(ps, o, d, t_max=t_max, active=active)
    _assert_same(jr, pr)
    t = pr.t.numpy()
    assert (t < t_max).any() and (t[~active] == t_max[~active]).all()
    assert (pr.visits.numpy()[~active] == 0).all()


def test_deep_tree_overflows_the_stack():
    """chip_smoke.staircase_case: a TLAS chain and a BLAS under it deeper
    than STACK."""
    jw, o, d = staircase_case(vt)
    js = jw.device(with_tlas=True)
    ps = staircase_case(pt)[0].device("cpu", with_tlas=True)
    jr = _jax_closest(js, o, d)
    pr, _ = _port_closest(ps, o, d)
    _assert_same(jr, pr)
    assert int(pr.overflow) > 0 and int(pr.exhausted) == 0


@pytest.mark.parametrize("kind", SHADOW_EDGE_CASES)
def test_edge_sets_match_jax(kind):
    jw, o, d, active = shadow_edge_case(vt, kind)
    pw, _, _, _ = shadow_edge_case(pt, kind)
    ps = pw.device("cpu", with_tlas=True)
    pr, _ = _port_closest(ps, o, d, active=active)
    if not len(o):
        assert pr.t.shape == (0,) and int(pr.exhausted) == 0
        return
    jr = _jax_closest(jw.device(with_tlas=True), o, d, active=active)
    _assert_same(jr, pr)
    assert int(pr.exhausted) == 0 and int(pr.overflow) == 0
    assert (pr.t.numpy() < j_trav.MAX_DIST).any()


def test_closest_hit_on_the_cpu_runs_the_twin(trace_scenes):
    """ops.closest_hit.closest_hit on CPU tensors: the twin, no launch."""
    _, ps, o, d = trace_scenes
    before = t_ch.LAUNCHES
    tables = t_trav.scene_rays(ps)
    got = t_ch.closest_hit(*tables, torch.from_numpy(o), torch.from_numpy(d),
                           t_max=1e6)
    want, _ = _port_closest(ps, o, d, t_max=1e6)
    assert t_ch.LAUNCHES == before
    _assert_same(want, got)


def test_leaves_above_max_leaf_are_refused():
    w = pt.World(build_bvh=False)
    w.instances.add(np.eye(4, dtype=np.float32), 3, 0)
    with pytest.raises(ValueError, match="MAX_LEAF"):
        t_trav.scene_rays(w.device("cpu", with_tlas=True))


def test_bvh_trace_example_matches_jax_example(tmp_path, monkeypatch):
    """Both examples at 64x36 write the same PNG."""
    jax_png, port_png = tmp_path / "jax.png", tmp_path / "port.png"
    monkeypatch.setattr(sys, "argv", ["bvh_trace.py", "--width", "64",
                                      "--height", "36", "--out",
                                      str(jax_png)])
    runpy.run_path(os.path.join(ROOT, "examples", "bvh_trace.py"),
                   run_name="__main__")
    pt_bvh_trace.main(["--cpu", "--width", "64", "--height", "36", "--out",
                       str(port_png)])
    got, want = load_image(str(port_png)), load_image(str(jax_png))
    assert got.shape == (36, 64, 4) and got.std() > 0
    np.testing.assert_array_equal(got, want)
