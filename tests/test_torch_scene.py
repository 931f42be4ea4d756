"""Port parity: host scene assembly (voidin_tpu_torch.scene) against the
JAX package's World, plus the helpers the other port tests share.

Both packages' pools permute each mesh's triangles while building its
BLAS (tests/test_torch_bvh.py holds those trees against each other); the
raster, resolve and shade parity tests compare stages in input order, so
``unpermuted_worlds`` builds both packages' Worlds with
``build_bvh=False``. Both packages pack textures through their native C++
packer by default, whose deepest mips differ from the numpy packer's by a
few u8 steps; ``pin_packer`` puts both on one packer, and the tests of
World leaves run on each (tests/test_torch_texture_native.py holds the
packers themselves). Exact equality is asserted for every leaf the port
carries.
"""

import contextlib
import functools
import os
import time

import jax
import numpy as np
import pytest
import torch

import bench
import voidin_tpu as vt
import voidin_tpu.native
from voidin_tpu.core import mathx
from voidin_tpu.scene import scene as jax_scene_mod

import voidin_tpu_torch as pt
import voidin_tpu_torch.native
from voidin_tpu_torch.framework import renderer as pt_renderer
from voidin_tpu_torch.framework.renderer import build_world as port_build_world
from voidin_tpu_torch.scene import mesh as pt_mesh
from voidin_tpu_torch.scene import scene as pt_scene_mod
from voidin_tpu_torch.scene.scene import STATIC_FLAGS, scene_from_numpy
from voidin_tpu_torch.scene.skin import skin_statics

torch.set_num_threads(2)


def jax_leaves(tree) -> dict:
    """Pytree leaves as numpy arrays keyed by dotted attribute path (a
    tuple's entries by their index, as in "skins.0.rest_pos")."""
    return {
        ".".join(str(p.name if hasattr(p, "name") else p.idx)
                 for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def port_scene(jax_scene, device="cpu"):
    """The port's SceneData holding the very state of a JAX SceneData,
    its skins included."""
    statics = {k: getattr(jax_scene, k) for k in STATIC_FLAGS}
    statics["skins"] = tuple(skin_statics(s) for s in jax_scene.skins)
    return scene_from_numpy(jax_leaves(jax_scene), statics, device)


# The texture packers a parity test runs both packages on (pin_packer).
PACKERS = ("numpy", "native")


def load_jax_native(attempts=40):
    """The JAX package's native library, loaded. It compiles into its own
    package directory at first use, so test workers that start together
    can find it half-written and fall back to numpy for good: load it
    again (its _tried latch cleared) until it opens. None where no
    compiler builds it."""
    mod = voidin_tpu.native
    for _ in range(attempts):
        lib = mod.load()
        if lib is not None or os.environ.get("VOIDIN_NATIVE", "1") == "0":
            return lib
        mod._tried = False
        time.sleep(0.25)
    return mod.load()


def pin_packer(mp, packer):
    """Both packages' texture pools on one packer: "numpy" turns both
    native packers off (each package's numpy fallback); "native" is both
    packages' default, each library built from its own copy of
    texture_packer.cpp."""
    assert packer in PACKERS, packer
    if packer == "numpy":
        for mod in (voidin_tpu.native, voidin_tpu_torch.native):
            mp.setattr(mod, "pack_texture", lambda *a, **k: None)
    else:
        load_jax_native()


@pytest.fixture(params=PACKERS)
def packer(request, monkeypatch):
    """Each test that takes it runs on both packers (pin_packer)."""
    pin_packer(monkeypatch, request.param)
    return request.param


@contextlib.contextmanager
def unpermuted_worlds(packer="native"):
    """Both packages' Worlds (vt.World, pt.World and the one the port's
    build_world makes) without the BLAS triangle permutation
    (build_bvh=False), both texture pools on `packer` (pin_packer).
    Yields the MonkeyPatch for more patches of the same extent."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vt, "World",
                   functools.partial(jax_scene_mod.World, build_bvh=False))
        port_world = functools.partial(pt_scene_mod.World, build_bvh=False)
        mp.setattr(pt, "World", port_world)
        mp.setattr(pt_renderer, "World", port_world)
        pin_packer(mp, packer)
        yield mp


@pytest.fixture(params=PACKERS)
def jax_world_unpermuted(request):
    """Both packages' Worlds in input order (unpermuted_worlds), on each
    packer."""
    with unpermuted_worlds(request.param):
        yield


def deferred_scene(pkg):
    """tests/test_golden.py's deferred scene, built with `pkg`'s World
    (pkg = voidin_tpu or voidin_tpu_torch)."""
    w = pkg.World()
    w.lights.add_point_light([0, 2.5, 0], 14.0, [1.0, 0.95, 0.9])
    w.add_area_light(
        [1, 1, 1], 6.0, (4.0, 4.0),
        np.asarray(mathx.from_translation([0, 6, 2])
                   @ mathx.from_rotation_x(np.float32(-np.pi / 4))),
    )
    red = w.materials.add(albedo=w.textures.add(
        np.array([[[200, 60, 50, 255]]], np.uint8), srgb=True))
    grey = w.materials.add(albedo=w.textures.add(
        np.array([[[150, 150, 150, 255]]], np.uint8), srgb=True))
    sphere10, plane = 3, 0  # SPHERE_10_MESH, HORIZONTAL_PLANE_MESH
    for i in range(5):
        a = 2 * np.pi * i / 5
        t = mathx.from_translation(
            [2.2 * np.cos(a), 0.5, -6 + 2.2 * np.sin(a)])
        w.instances.add(np.asarray(t), sphere10, red if i % 2 else grey)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -1, -6])
                   @ mathx.from_scale(30.0)),
        plane, grey,
    )
    return w


def _assert_scene_equal(jax_world, port_world):
    jl = jax_leaves(jax_world.device(tap_blocks=False))
    pl = port_world.host_leaves()
    for k, v in pl.items():
        assert k in jl, k
        a, b = np.asarray(jl[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    js = jax_world.device(tap_blocks=False)
    for k, v in port_world.statics().items():
        assert getattr(js, k) == v, k


def test_builtin_meshes_match(jax_world_unpermuted):
    assert pt_mesh.SPHERE_10_MESH == vt.mesh.SPHERE_10_MESH
    assert pt_mesh.HORIZONTAL_PLANE_MESH == vt.mesh.HORIZONTAL_PLANE_MESH
    for jm, pm in (
        (vt.mesh.make_uv_sphere(1.0, 3), pt_mesh.make_uv_sphere(1.0, 3)),
        (vt.mesh.make_cube_mesh(1.5), pt_mesh.make_cube_mesh(1.5)),
    ):
        for f in ("vertices", "normals", "tangents", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(jm, f), getattr(pm, f))


def test_golden_scene_arrays_exact(jax_world_unpermuted):
    _assert_scene_equal(deferred_scene(vt), deferred_scene(pt))


def test_build_world_arrays_exact(jax_world_unpermuted):
    jw, jmoving = bench.build_world(300, seed=0)
    pw, pmoving = port_build_world(300, seed=0)
    np.testing.assert_array_equal(jmoving, pmoving)
    _assert_scene_equal(jw, pw)


def test_scene_from_numpy_carries_jax_state(jax_world_unpermuted):
    js = deferred_scene(vt).device(tap_blocks=False)
    ps = port_scene(js)
    np.testing.assert_array_equal(ps.meshes.tri_pos.numpy(),
                                  np.asarray(js.meshes.tri_pos))
    np.testing.assert_array_equal(
        ps.meshes.tri_attr_packed.numpy().view(np.uint32),
        np.asarray(js.meshes.tri_attr_packed))
    assert ps.meshes.has_lods == js.meshes.has_lods
    assert ps.textures.base_size == js.textures.base_size
    assert ps.textures.total == js.textures.total
    assert ps.no_normal_maps == js.no_normal_maps
