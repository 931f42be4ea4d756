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

A scalar Python model of csrc/closest_hit.cu's loop (_model_walk: pops
until one hits a leaf, one slab test for TLAS and BLAS entries, the
kernel's push arithmetic, then the leaf) is held against the twin word
for word at step limits 1, 2, 3 and 2048, and a model of its thread
order (_thread_ray: rays in pixel tiles given a row width) is held to
give every ray one thread, where no card is present.
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
from voidin_tpu_torch.core import fastmath
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


# --- the kernel's walk and thread order, on the CPU ------------------------
def _model_walk(tables, origins, directions, t_max, max_steps):
    """csrc/closest_hit.cu's loop ray by ray over scene_rays tables (CPU
    tensors): (t, visits, overflow, exhausted). Pops (entries TLAS n + 1,
    BLAS -(n + 1)) until one hits a leaf, one slab test for both kinds,
    internal hits pushing `first` (left + 1, or -(base + left + 1)) and
    then right + 1 or first - 1; then the leaf: an instance entry or its
    triangles. The slab, the ray transform and the triangle test are the
    twin's functions on one-row tensors; the walk and its stack are the
    kernel's."""
    tlas, blas, inst, tri_pos = tables
    inv_all = t_trav.inv_direction(directions)
    R = origins.shape[0]
    t_out = np.asarray(t_max, np.float32) * np.ones(R, np.float32)
    visits_out = np.zeros(R, np.int32)
    overflow = exhausted = 0
    for r in range(R):
        o, d, inv0 = origins[r:r + 1], directions[r:r + 1], inv_all[r:r + 1]
        co, cd, cinv = o, d, inv0
        t = torch.from_numpy(t_out[r:r + 1])
        bvh_base = tri_base = 0
        stack, visits = [1], 0

        def push(entry):
            nonlocal overflow
            if len(stack) >= t_trav.STACK:
                overflow += 1
            else:
                stack.append(entry)

        while True:
            leaf = 0
            while stack and visits < max_steps:
                entry = stack.pop()
                visits += 1
                world = entry > 0
                row = (tlas[entry - 1] if world else blas[-entry - 1])[None]
                if not t_trav._slab(o if world else co,
                                    inv0 if world else cinv, row[:, 0:3],
                                    row[:, 4:7], t)[0]:
                    continue
                ia, ib = int(row[0, 3]), int(row[0, 7])
                if (not row[0, 3] < 0) if world else ib <= 0:
                    first = ia + 1 if world else -(bvh_base + ia + 1)
                    push(first)
                    push(ib + 1 if world else first - 1)
                    continue
                leaf = entry
                break
            if leaf == 0:
                break
            if leaf > 0:
                irow = inst[ib]
                m = irow[:16].reshape(1, 4, 4)
                co = fastmath.mat4_point_fma(m, o)
                cd = fastmath.mat3_vec_fma(m[:, :3, :3], d)
                cinv = t_trav.inv_direction(cd)
                bvh_base, tri_base = int(irow[16]), int(irow[17])
                push(-(bvh_base + 1))
                continue
            for k in range(ib):
                tri = tri_pos[tri_base + ia + k][None]
                th = t_trav._tri_t(co, cd, tri[:, 0:3], tri[:, 3:6],
                                   tri[:, 6:9])
                if th[0] > 0 and th[0] < t[0]:
                    t = th
        t_out[r], visits_out[r] = t[0], visits
        exhausted += len(stack) > 0
    return t_out, visits_out, overflow, exhausted


def _model_cases():
    """(name, tables, origins, directions, t_max) on the CPU: 288 of the
    bvh_trace example's 64x36 primary rays (every eighth; a third of them
    with t_max 8) and the staircase deeper than STACK."""
    scene = pt_bvh_trace.trace_world(pt).device("cpu", with_tlas=True)
    o, d = pt_bvh_trace.primary_rays(64, 36)
    o, d = o[::8], d[::8]
    t_max = np.where(np.arange(len(o)) % 3 == 0, 8.0, 1e6).astype(np.float32)
    yield "bvh_trace", t_trav.scene_rays(scene), o, d, t_max
    world, o, d = staircase_case(pt)
    yield ("staircase", t_trav.scene_rays(world.device("cpu",
                                                       with_tlas=True)),
           o, d, np.full(len(o), t_trav.MAX_DIST, np.float32))


@pytest.fixture(scope="module")
def model_cases():
    return {name: rest for name, *rest in _model_cases()}


@pytest.mark.parametrize("max_steps", [1, 2, 3, 2048])
@pytest.mark.parametrize("case", ["bvh_trace", "staircase"])
def test_kernel_walk_model_matches_twin(model_cases, case, max_steps):
    """The kernel's walk (pops until a leaf, one slab test for both
    kinds, its push arithmetic, then the leaf) gives the twin's t bits,
    visits, overflow and exhausted count."""
    tables, o, d, t_max = model_cases[case]
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t, visits, overflow, exhausted = _model_walk(tables, o, d, t_max,
                                                 max_steps)
    want, counts = t_trav.closest_hit_reference(
        *tables, o, d, t_max=torch.from_numpy(t_max), max_steps=max_steps)
    np.testing.assert_array_equal(t.view(np.int32),
                                  want.t.numpy().view(np.int32))
    np.testing.assert_array_equal(visits, want.visits.numpy())
    assert overflow == int(want.overflow)
    assert exhausted == int(want.exhausted)
    assert int(visits.sum()) == counts.node_visits
    if max_steps < 2048:
        assert exhausted > 0
    else:
        assert exhausted == 0 and (t < t_max).any()
        assert counts.missed_pops > 0
        assert (overflow > 0) == (case == "staircase")


THREADS = 128  # csrc/closest_hit.cu kThreads


def _thread_ray(block, lane, n_rays, width):
    """csrc/closest_hit.cu thread_ray: the ray of a thread, -1 for none."""
    if width:
        tiles_x = (width + 15) // 16
        x = (block % tiles_x) * 16 + ((lane >> 5) & 1) * 8 + (lane & 7)
        y = (block // tiles_x) * 8 + ((lane >> 6) & 1) * 4 + ((lane >> 3) & 3)
        if x >= width:
            return -1
        r = y * width + x
    else:
        r = block * THREADS + lane
    return r if r < n_rays else -1


def _grid_blocks(n_rays, width):
    """csrc/closest_hit.cu grid_blocks."""
    if width:
        rows = -(-n_rays // width)
        return -(-width // 16) * -(-rows // 8)
    return -(-n_rays // THREADS)


@pytest.mark.parametrize("n_rays,width", [
    (64 * 36, 64), (2509, 37), (3, 1), (1920 * 24, 1920), (300, 7),
    (2509, None)])
def test_kernel_thread_order_covers_each_ray_once(n_rays, width):
    """The kernel's launch gives every ray one thread, ragged tiles and
    rows included; with a width, each warp's rays lie in one 8x4 tile."""
    rays = [[_thread_ray(b, lane, n_rays, width) for lane in range(THREADS)]
            for b in range(_grid_blocks(n_rays, width))]
    flat = [r for block in rays for r in block if r >= 0]
    assert sorted(flat) == list(range(n_rays))
    if width:
        for block in rays:
            for w in range(0, THREADS, 32):
                warp = [r for r in block[w:w + 32] if r >= 0]
                if warp:
                    xs = {r % width for r in warp}
                    ys = {r // width for r in warp}
                    assert max(xs) - min(xs) < 8 and max(ys) - min(ys) < 4


def test_width_changes_nothing_on_the_cpu(trace_scenes):
    """ops.closest_hit.closest_hit's `width` only orders the kernel's
    threads: on CPU tensors the twin's result, with or without it."""
    _, ps, o, d = trace_scenes
    tables = t_trav.scene_rays(ps)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    _assert_same(t_ch.closest_hit(*tables, o, d, t_max=1e6),
                 t_ch.closest_hit(*tables, o, d, t_max=1e6, width=64))
