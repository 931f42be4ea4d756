"""Port parity: the App layer (voidin_tpu_torch.framework.app) against the
JAX package's App.

- tests/test_framework.py's demo scene plus one rect area light, at its
  128x64 CFG: both packages' App run 3 frames through step() and 2 through
  run(); every frame within BUDGET (5e-3) mean abs of the JAX App's.
- resize as tests/test_framework.py:53-69, and the old Renderer freed;
  hot reload mid-run as :72-112 (a user post hook from a file, then a
  touched frame source bumping the "frame" entry's reload_count).
- FpsCounter, screenshot, and the device rule: App(device="cpu").
"""

import gc
import os
import sys
import time
import weakref

import numpy as np
import torch

import voidin_tpu as vt
from voidin_tpu.framework.app import App as JaxApp
from voidin_tpu.framework.app import Example as JaxExample
from voidin_tpu.passes.raster import RasterConfig as JaxRasterConfig

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import mathx
from voidin_tpu_torch.framework import app as app_mod
from voidin_tpu_torch.framework.app import App, Example, FpsCounter
from voidin_tpu_torch.io.image import load_image
from voidin_tpu_torch.passes.raster import RasterConfig

torch.set_num_threads(2)
BUDGET = 5e-3
CAPS = dict(width=128, height=64, tri_capacity=1 << 12,
            pair_capacity=1 << 13, tile_tri_capacity=64)
CFG = RasterConfig(**CAPS)
SPHERE_1_MESH, HORIZONTAL_PLANE_MESH = 2, 0  # in both packages


def setup_demo(app, moving=True):
    """tests/test_framework.py's _Demo scene plus a rect area light, on
    either package's App."""
    w = app.world
    w.lights.add_point_light([0, 3, 0], 15.0, [1, 1, 1])
    sphere = w.instances.add(np.asarray(mathx.from_translation([0, 0, -5])),
                             SPHERE_1_MESH, 0)
    w.instances.add(
        np.asarray(mathx.from_translation([0, -2, -5])
                   @ mathx.from_scale(20.0)),
        HORIZONTAL_PLANE_MESH, 0)
    app.add_area_light(
        [1, 0.9, 0.8], 6.0, (4.0, 3.0),
        np.asarray(mathx.from_translation([0, 4, -2])
                   @ mathx.from_rotation_x(np.float32(-np.pi / 3))))
    if moving:
        app.moving_ids.append(sphere)


class _Demo(Example):
    name = "demo"

    def setup_scene(self, app):
        setup_demo(app)

    def update(self, app, state):
        self.updated = getattr(self, "updated", 0) + 1


class _JaxDemo(JaxExample):
    name = "demo"

    def setup_scene(self, app):
        setup_demo(app)


def _app(example=None, **kw):
    return App(example or _Demo(), camera=pt.Camera(position=[0, 1, 0]),
               config=CFG, device="cpu", **kw)


def test_app_frames_match_jax():
    frames = {}
    for name, app in (
            ("jax", JaxApp(_JaxDemo(), camera=vt.Camera(position=[0, 1, 0]),
                           config=JaxRasterConfig(interpret=True, **CAPS))),
            ("port", _app())):
        got = frames[name] = []
        app.post_hooks.append(
            lambda img, got=got: got.append(np.array(img)) or img)
        for _ in range(3):
            app.step()
        app.run(2)
        assert app.state.frame_count == 5
    assert frames["port"][0].shape == (64, 128, 3)
    for i, (a, b) in enumerate(zip(frames["port"], frames["jax"])):
        d = np.abs(a - b)
        print(f"frame {i}: mean abs diff {d.mean():.3e}, max {d.max():.3e}")
        assert np.isfinite(a).all() and a.std() > 0.01
        assert d.mean() < BUDGET
    # the moving sphere and TAA change the frames
    assert np.abs(frames["port"][4] - frames["port"][0]).max() > 0


def test_app_steps_count_updates_and_return_device_tensors():
    demo = _Demo()
    app = _app(demo)
    img = app.step()
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    assert img.shape == (64, 128, 3) and torch.isfinite(img).all()
    assert demo.updated == 1
    app.run(frames=2)
    assert demo.updated == 3 and app.state.frame_count == 3
    assert abs(app.state.total_time - 3 * app_mod.FIXED_TIME_STEP) < 1e-12
    assert app_mod.MAX_FRAME_TIME == 15 * app_mod.FIXED_TIME_STEP


def test_app_resize_rerenders():
    """App.resize recreates the frame pipeline at the new resolution and
    invokes Example.resize (app.rs:360-377, lib.rs Example trait); the old
    Renderer stays alive neither in App.renderer nor in the cache."""

    class _Resizable(_Demo):
        def resize(self, app, width, height):
            self.resized_to = (width, height)

    demo = _Resizable()
    app = _app(demo)
    assert app.step().shape == (64, 128, 3)
    old = weakref.ref(app.renderer)
    app.resize(64, 32)
    gc.collect()
    assert old() is None
    assert demo.resized_to == (64, 32)
    assert app.state.camera.aspect == 2.0
    assert app.recorder.width == 64 and app.recorder.height == 32
    img = app.step()
    assert img.shape == (32, 64, 3)
    assert torch.isfinite(img).all()
    assert app.pipelines.names() == ["frame"]


def test_hot_reload_mid_run(tmp_path):
    """Editing a module mid-run rebuilds the live frame pipeline
    (PipelineArena reload semantics, app/pipeline.rs:253-351), and a user
    post hook registered from a file hot-swaps its behavior."""
    mod_path = tmp_path / "user_tint_torch.py"
    mod_path.write_text("def tint(img):\n    return img\n")
    sys.path.insert(0, str(tmp_path))
    try:
        app = _app()

        import user_tint_torch

        hook = app.pipelines.register(
            "tint", lambda: user_tint_torch.tint, source=str(mod_path))
        app.post_hooks.append(hook)
        img1 = app.step().numpy()

        # Edit the module on disk; the next step's poll() must reload it.
        time.sleep(0.01)
        mod_path.write_text("def tint(img):\n    return img * 0.0\n")
        os.utime(mod_path)
        img2 = app.step().numpy()
        assert np.all(img2 == 0.0) and not np.all(img1 == 0.0)

        # Touching a frame source rebuilds the frame pipeline itself
        frame_entry = app.pipelines._entries["frame"]
        before = frame_entry.reload_count
        src = frame_entry.sources[0]
        assert os.sep + "voidin_tpu_torch" + os.sep in src
        os.utime(src)
        img3 = app.step().numpy()
        assert frame_entry.reload_count == before + 1
        assert np.isfinite(img3).all()
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("user_tint_torch", None)


def test_fps_counter():
    f = FpsCounter()
    assert f.tick() == 0.0
    for _ in range(12):
        time.sleep(0.002)
        fps = f.tick()
    assert 0 < fps < 1000
    assert len(f.times) == f.window == 8


def test_screenshot_writes_the_next_frame(tmp_path):
    app = _app()
    path = str(tmp_path / "shot.png")
    app.screenshot(path)
    img = load_image(path)
    assert img.shape == (64, 128, 4) and img[..., :3].std() > 0
    assert app.state.frame_count == 1
