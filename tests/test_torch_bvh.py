"""Port parity: the host BVH builders (voidin_tpu_torch.rt.bvh, .native) and
the pools and TLAS built with them, against the JAX package.

The native (C++) and numpy builders give different trees, so every
comparison pins the same builder on both sides: "numpy" sets
VOIDIN_NATIVE=0 (both packages read it at each build), "native" needs a
host C++ compiler and skips without one. With the same builder the nodes,
permuted indices, exit links and refit plans are bit-identical, and so are
the pools' indices, tri_pos and bvh_* leaves and the TLAS of a World. The
invariants of tests/test_bvh.py hold on the port's builders.
"""

import functools
import os

import numpy as np
import pytest
import torch

import bench
import voidin_tpu as vt
from voidin_tpu import native as j_native
from voidin_tpu.rt import bvh as j_bvh
from voidin_tpu.scene import scene as jax_scene_mod

import voidin_tpu_torch as pt
from voidin_tpu_torch import native as t_native
from voidin_tpu_torch.framework import renderer as t_renderer
from voidin_tpu_torch.rt import bvh as t_bvh
from voidin_tpu_torch.scene import mesh as t_mesh

from tests.test_bvh import _check_invariants, _random_tris
from tests.test_torch_scene import deferred_scene, jax_leaves, packer  # noqa: F401

torch.set_num_threads(2)

BUILDERS = ("numpy", "native")


@pytest.fixture(params=BUILDERS)
def builder(request, monkeypatch):
    """Pins both packages to one BVH builder."""
    if request.param == "numpy":
        monkeypatch.setenv("VOIDIN_NATIVE", "0")
    elif t_native.load() is None or j_native.load() is None:
        pytest.skip("no host C++ compiler: the native builders are absent")
    return request.param


def _identical_centroids(n=40):
    """n triangles rotated about one common centroid (SAH has no split)."""
    a = 2 * np.pi * np.arange(n) / n
    tri = np.stack([np.stack([np.cos(a + k * 2.1), np.sin(a + k * 2.1),
                              np.full(n, 0.25 * k - 0.25)], -1)
                    for k in range(3)], 1)
    tri -= tri.mean(axis=1, keepdims=True)
    return tri.reshape(-1, 3).astype(np.float32), np.arange(3 * n,
                                                           dtype=np.int32)


INPUTS = {
    "random": lambda: _random_tris(257, seed=4),
    "identical_centroids": _identical_centroids,
    "sphere": lambda: (lambda m: (m.vertices, m.indices))(
        t_mesh.make_uv_sphere(1.0, 3)),
}


def _assert_plans_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "levels":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("gen", list(INPUTS))
def test_build_blas_bit_identical(builder, gen):
    verts, idx = INPUTS[gen]()
    native = builder == "native"
    jn, jp = j_bvh.build_blas(verts, idx.copy(), native=native)
    tn, tp = t_bvh.build_blas(verts, idx.copy(), native=native)
    assert jn.dtype == tn.dtype and jn.tobytes() == tn.tobytes()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(j_bvh.blas_exit_links(jn),
                                  t_bvh.blas_exit_links(tn))
    _assert_plans_equal(j_bvh.blas_refit_plan(jn), t_bvh.blas_refit_plan(tn))
    _check_invariants(tn, verts, tp, idx.size // 3)
    if gen == "identical_centroids":  # forced onto the median split
        assert (tn["count"] > 0).sum() > 1


@pytest.mark.parametrize("n", [1, 50, 300])
def test_build_tlas_bit_identical(builder, n):
    rng = np.random.default_rng(n)
    mins = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.1, 3.0, (n, 3)).astype(np.float32)
    native = builder == "native"
    jn = j_bvh.build_tlas(mins, maxs, native=native)
    tn = t_bvh.build_tlas(mins, maxs, native=native)
    assert jn.dtype == tn.dtype and jn.tobytes() == tn.tobytes()
    np.testing.assert_array_equal(j_bvh.tlas_exit_links(jn),
                                  t_bvh.tlas_exit_links(tn))
    _assert_plans_equal(j_bvh.tlas_refit_plan(jn), t_bvh.tlas_refit_plan(tn))
    transforms = rng.uniform(-2, 2, (n, 4, 4)).astype(np.float32)
    mesh_ids = rng.integers(0, n, n).astype(np.int32)
    for a, b in zip(j_bvh.instance_world_aabbs(mins, maxs, transforms,
                                               mesh_ids),
                    t_bvh.instance_world_aabbs(mins, maxs, transforms,
                                               mesh_ids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene", ["golden", "build_world_300"])
def test_world_leaves_bit_identical(builder, packer, scene):
    """Every leaf the port's World carries, the BVH-permuted pool and the
    TLAS included, equals the JAX World()'s (default build_bvh=True)."""
    if scene == "golden":
        jw, pw = deferred_scene(vt), deferred_scene(pt)
    else:
        jw, _ = bench.build_world(300, seed=0)
        pw, _ = t_renderer.build_world(300, seed=0)
    jl = jax_leaves(jw.device(with_tlas=True, tap_blocks=False))
    pl = pw.host_leaves(with_tlas=True)
    for k in ("meshes.indices", "meshes.tri_pos", "meshes.bvh_min",
              "meshes.bvh_left_first", "meshes.bvh_exit", "tlas.tlas_min",
              "tlas.tlas_left_right", "tlas.tlas_exit", "tlas.refit_order"):
        assert k in pl, k
    for k, v in pl.items():
        a, b = np.asarray(jl[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    js, ps = jw.device(with_tlas=True), pw.device("cpu", with_tlas=True)
    assert ps.meshes.bvh_max_leaf == js.meshes.bvh_max_leaf <= 3
    assert ps.tlas.refit_levels == js.tlas.refit_levels
    # the permutation is real: the pool is not in input order
    unpermuted = jax_scene_mod.World(build_bvh=False).meshes.host_arrays()
    n = unpermuted["indices"].size
    assert not np.array_equal(pl["meshes.indices"][:n], unpermuted["indices"])


def test_world_without_bvh_keeps_input_order(packer):
    """build_bvh=False: input order and one leaf per mesh, as JAX's."""
    jw = functools.partial(jax_scene_mod.World, build_bvh=False)()
    pw = pt.World(build_bvh=False)
    jl = jax_leaves(jw.device(tap_blocks=False))
    for k, v in pw.host_leaves().items():
        np.testing.assert_array_equal(np.asarray(jl[k]), v, err_msg=k)
    assert pw.device("cpu").meshes.bvh_max_leaf == jw.device(
        ).meshes.bvh_max_leaf


@pytest.mark.parametrize("gen", ["sphere", "random"])
def test_blas_invariants(builder, gen):
    verts, indices = INPUTS[gen]()
    nodes, perm = t_bvh.build_blas(verts, indices)
    _check_invariants(nodes, verts, perm, indices.size // 3)
    np.testing.assert_array_equal(np.sort(indices), np.sort(perm))
    assert nodes["count"][nodes["count"] > 0].max() <= t_bvh.LEAF_SIZE


def test_blas_traversal_matches_brute_force(builder):
    verts, indices = _random_tris(64, seed=3)
    nodes, perm = t_bvh.build_blas(verts, indices)
    rng = np.random.default_rng(7)
    misses = 0
    for _ in range(64):
        origin = rng.uniform(-15, 15, 3).astype(np.float32)
        direction = rng.normal(size=3).astype(np.float32)
        t_hit = t_bvh.traverse_blas_oracle(nodes, verts, perm, origin,
                                           direction)
        t_ref = t_bvh.brute_force_closest(verts, perm, origin, direction)
        assert np.isclose(t_hit, t_ref, rtol=1e-5), (t_hit, t_ref)
        misses += t_ref >= t_bvh.MAX_DIST
    assert misses < 64


def test_blas_degenerate_identical_centroids(builder):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    verts = np.tile(v, (10, 1))
    nodes, perm = t_bvh.build_blas(verts, np.arange(30, dtype=np.int32))
    _check_invariants(nodes, verts, perm, 10)


def test_tlas_structure(builder):
    rng = np.random.default_rng(0)
    n = 50
    mins = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    nodes = t_bvh.build_tlas(mins, maxs)
    seen = np.zeros(n, int)
    stack = [0]
    while stack:
        node = nodes[stack.pop()]
        if node["left_right"] == 0:
            seen[int(node["instance_idx"])] += 1
            np.testing.assert_array_equal(node["min"],
                                          mins[node["instance_idx"]])
            np.testing.assert_array_equal(node["max"],
                                          maxs[node["instance_idx"]])
        else:
            li = int(node["left_right"] & 0xFFFF)
            ri = int(node["left_right"] >> 16)
            assert li != 0 and ri != 0
            for c in (li, ri):
                assert (nodes[c]["min"] >= node["min"]).all()
                assert (nodes[c]["max"] <= node["max"]).all()
            stack += [li, ri]
    assert (seen == 1).all()


def test_instance_world_aabbs():
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [5, 0, 0]
    t[0, 0] = 2.0
    mn, mx = t_bvh.instance_world_aabbs(
        np.array([[-1, -1, -1]], np.float32), np.array([[1, 1, 1]],
                                                       np.float32),
        t[None], np.array([0], np.int32))
    np.testing.assert_allclose(mn[0], [3, -1, -1], atol=1e-6)
    np.testing.assert_allclose(mx[0], [7, 1, 1], atol=1e-6)


def test_native_library_builds_inside_the_port():
    if t_native.load() is None:
        pytest.skip("no host C++ compiler")
    path = t_native.library_path()
    port_dir = os.path.dirname(os.path.abspath(pt.__file__))
    assert os.path.commonpath([path, port_dir]) == port_dir
    assert os.path.exists(path) and t_native.builder() == "native"
