"""Port parity: the framework's small pieces against the JAX package's.

- Input edges, keymap accumulation and clamp, CameraController
  (tests/test_aux.py:19-51), and the controller moving the port's camera
  exactly as JAX's moves its own.
- PipelineCache keeps the last good version when a reload raises.
- HUD: draw_hud and draw_hud_np equal JAX's word for word.
- Blit: downsample2x and the mip chain equal JAX's word for word, present
  too except the sRGB curve, whose power differs by at most 1 ulp of f32
  (1.2e-7) from XLA's; resize_bilinear within 1e-6 of jax.image.resize at
  2x up and 2x and 3x down.
- core/hash: every function equal to JAX's word for word.
- Profiler: profile_frame on the CPU gives JAX's rows in order (the fine
  raster row named for the CUDA kernel), each > 0; time_fn times CPU
  inputs on the host clock.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import voidin_tpu as vt
from voidin_tpu.core import hash as j_hash
from voidin_tpu.framework import input as j_input
from voidin_tpu.passes import blit as j_blit
from voidin_tpu.passes import hud as j_hud

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import hash as t_hash
from voidin_tpu_torch.framework import profiler
from voidin_tpu_torch.framework.input import (CameraController, Input,
                                              KeyboardMap, default_keymap)
from voidin_tpu_torch.framework.pipeline import PipelineCache
from voidin_tpu_torch.framework.renderer import build_world
from voidin_tpu_torch.passes import blit as t_blit
from voidin_tpu_torch.passes import hud as t_hud
from voidin_tpu_torch.passes.raster import RasterConfig

torch.set_num_threads(2)
RNG = np.random.default_rng(11)
IMG = (RNG.random((37, 50, 3)) * 1.4).astype(np.float32)


def test_input_just_pressed_edges():
    inp = Input()
    inp.press("w")
    assert inp.was_just_pressed("w")
    inp.tick()
    assert inp.is_held("w") and not inp.was_just_pressed("w")
    inp.press("w")  # held: the edge does not come back
    assert not inp.was_just_pressed("w")
    inp.release("w")
    assert not inp.is_held("w")
    inp.move_mouse(3.0, 4.0)
    inp.move_mouse(5.0, 1.0)
    np.testing.assert_array_equal(inp.mouse_delta, [2.0, -3.0])
    inp.tick()
    np.testing.assert_array_equal(inp.mouse_delta, [0.0, 0.0])


def test_keymap_accumulation_and_clamp():
    m = KeyboardMap().bind("w", "fwd", 1.0).bind("s", "fwd", -1.0).bind(
        "x", "fwd", 5.0)
    inp = Input()
    inp.press("w")
    inp.press("x")
    assert m.map(inp)["fwd"] == 1.0  # clamped from 6
    inp.press("s")
    assert m.map(inp, clamp=(-10, 10))["fwd"] == 5.0
    assert default_keymap().map(Input()) == {}


def test_camera_controller_moves():
    cam = pt.Camera(position=[0, 0, 0], yaw=0.0, pitch=0.0)
    ctl = CameraController(cam, speed=2.0)
    inp = Input()
    inp.press("w")
    ctl.update(default_keymap().map(inp), inp, dt=0.5)
    assert cam.position[2] < -0.5  # moved forward (-z)


def test_camera_controller_matches_jax():
    """The same key and mouse script drives both packages' controllers to
    the same camera (position, yaw, pitch) at every step."""
    cams = {"jax": vt.Camera(position=[1.0, 2.0, 3.0], yaw=10.0, pitch=-5.0),
            "port": pt.Camera(position=[1.0, 2.0, 3.0], yaw=10.0,
                              pitch=-5.0)}
    mods = {"jax": j_input, "port": __import__(
        "voidin_tpu_torch.framework.input", fromlist=["Input"])}
    rigs = {k: (mods[k].Input(), mods[k].default_keymap(),
                mods[k].CameraController(cams[k], speed=3.0))
            for k in cams}
    script = [("w", None), ("shift", (4.0, -2.0)), ("d", (10.0, 3.0)),
              ("e", None), ("a", (-7.0, 1.0))]
    for key, mouse in script:
        for inp, keymap, ctl in rigs.values():
            inp.press(key)
            if mouse is not None:
                inp.mouse_held.add("left")
                inp.move_mouse(*mouse)
            ctl.update(keymap.map(inp), inp, 1.0 / 60.0)
            inp.tick()
        a, b = cams["jax"], cams["port"]
        np.testing.assert_array_equal(np.asarray(a.position),
                                      np.asarray(b.position))
        assert (a.yaw, a.pitch) == (b.yaw, b.pitch)


def test_pipeline_cache_reload_keeps_good_version():
    cache = PipelineCache()
    state = {"v": 1}

    def build():
        v = state["v"]
        if v == 99:
            raise RuntimeError("bad shader")
        return lambda x: x * v

    f = cache.register("scale", build)
    x = torch.tensor(2.0)
    assert float(f(x)) == 2.0
    state["v"] = 3
    assert cache.reload("scale")
    assert float(f(x)) == 6.0
    state["v"] = 99
    assert not cache.reload("scale")  # failed reload
    assert float(f(x)) == 6.0  # previous version kept
    assert cache._entries["scale"].reload_count == 1
    assert cache.names() == ["scale"]
    cache.discard("scale")
    assert cache.names() == []


@pytest.mark.parametrize("text,origin,scale", [
    ("fps: 60.0", (4, 4), 2), ("ms: 16.6", (20, 3), 3),
    ("0123456789.:", (0, 0), 1)])
def test_hud_matches_jax(text, origin, scale):
    img = RNG.random((64, 128, 3)).astype(np.float32)
    want = np.asarray(j_hud.draw_hud(jnp.asarray(img), text, origin, scale))
    t = torch.from_numpy(img.copy())
    got = t_hud.draw_hud(t, text, origin, scale).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.numpy(), img)  # the input untouched
    np.testing.assert_array_equal(
        t_hud.draw_hud_np(img, text, origin, scale),
        j_hud.draw_hud_np(img, text, origin, scale))
    np.testing.assert_array_equal(t_hud.text_bitmap(text, scale),
                                  j_hud.text_bitmap(text, scale))


def test_hud_np_clips_at_the_border():
    img = np.zeros((12, 20, 3), np.float32)
    np.testing.assert_array_equal(
        t_hud.draw_hud_np(img, "fps: 60.0", (6, 8)),
        j_hud.draw_hud_np(img, "fps: 60.0", (6, 8)))


def test_blit_present_and_mips_match_jax():
    x = torch.from_numpy(IMG)
    j = jnp.asarray(IMG)
    srgb = t_blit.present(x).numpy()
    diff = np.abs(srgb - np.asarray(j_blit.present(j)))
    assert diff.max() <= 1.2e-7  # the sRGB power: <= 1 ulp of f32
    for kw in (dict(srgb=False), dict(srgb=False, to_uint8=True),
               dict(to_uint8=True)):
        np.testing.assert_array_equal(t_blit.present(x, **kw).numpy(),
                                      np.asarray(j_blit.present(j, **kw)))
    mips_t, mips_j = t_blit.generate_mipmaps(x), j_blit.generate_mipmaps(j)
    assert len(mips_t) == len(mips_j) == 6
    for a, b in zip(mips_t, mips_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    grey = RNG.random((9, 14)).astype(np.float32)
    np.testing.assert_array_equal(
        t_blit.downsample2x(torch.from_numpy(grey)).numpy(),
        np.asarray(j_blit.downsample2x(jnp.asarray(grey))))


@pytest.mark.parametrize("size", [(74, 100), (18, 25), (12, 16), (20, 17)])
def test_resize_bilinear_matches_jax(size):
    got = t_blit.resize_bilinear(torch.from_numpy(IMG), *size).numpy()
    want = np.asarray(j_blit.resize_bilinear(jnp.asarray(IMG), *size))
    assert got.shape == want.shape == size + (3,)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("name,shape", [
    ("hash11", (500,)), ("hash21", (500, 2)), ("hash13", (4, 125)),
    ("hash31", (500, 3)), ("hash33", (10, 50, 3))])
def test_hash_matches_jax(name, shape):
    x = (RNG.standard_normal(shape) * 200).astype(np.float32)
    want = np.asarray(getattr(j_hash, name)(jnp.asarray(x)))
    got = getattr(t_hash, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 1


JAX_ROWS = ["emit_draws (cull+compact)", "triangle setup + clip",
            "binning (pairs+sort)", "fine raster (pallas)",
            "gbuffer resolve", "deferred shade (LTC)",
            "taa (reproject+resolve)", "postprocess"]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_profile_frame_rows(backend, capsys):
    world, moving = build_world(60, seed=1)
    cfg = RasterConfig(width=64, height=32, tri_capacity=1 << 13,
                       pair_capacity=1 << 13, backend=backend)
    scene = world.device("cpu")
    cam = pt.Camera(position=[0.0, 2.0, 30.0], pitch=-5.0, aspect=2.0)
    rows = profiler.profile_frame(scene, cam.uniform(), cfg,
                                  moving_ids=moving)
    want = [n.replace("(pallas)", "(cuda)") for n in JAX_ROWS]
    assert [n for n, _ in rows] == want
    assert all(ms > 0 for _, ms in rows)
    profiler.print_table(rows)
    out = capsys.readouterr().out
    assert "fine raster (cuda)" in out and "total (sum of passes)" in out


def test_time_fn_on_cpu_inputs_uses_the_host_clock(monkeypatch):
    def no_events(*a, **k):
        raise AssertionError("CUDA events on CPU inputs")

    monkeypatch.setattr(torch.cuda, "Event", no_events)
    calls = []
    ms = profiler.time_fn(lambda t: calls.append(t.sum()),
                          torch.ones(3), n=4)
    assert ms >= 0 and len(calls) == 5
    assert profiler._device_of([1, {"a": torch.zeros(1)}]).type == "cpu"
    assert profiler._device_of((1, "x")) is None
    monkeypatch.setenv(profiler.PROFILING_ENV, "1")
    assert profiler.profiling_enabled()
