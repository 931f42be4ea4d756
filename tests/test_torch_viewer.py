"""Port parity: the terminal and web viewers (framework/viewer.py,
framework/webviewer.py) against the JAX package's.

- ansi_frame: the port's string equals JAX's on the same images (uint8
  and float, shrunk and not), and takes a tensor; _term_size agrees.
- run_terminal drives App.step() headless (tests/test_framework.py:256).
- run_web serves the page, a PNG frame (decoded by the port's decode_png:
  the frame's shape) and the stats, and takes posted input
  (tests/test_webviewer.py:52): held W moves the camera, a drag turns it,
  Esc ends the loop.
- The viewer examples' Spin scene (examples/viewer.py) through both
  packages' App within BUDGET (5e-3) mean abs, and both port viewer
  example mains headless for two frames.
"""

import io
import json
import os
import runpy
import threading
import urllib.request

import numpy as np
import torch

import voidin_tpu as vt
from voidin_tpu.framework import viewer as j_viewer
from voidin_tpu.framework.app import App as JaxApp
from voidin_tpu.passes.raster import RasterConfig as JaxRasterConfig

import voidin_tpu_torch as pt
from voidin_tpu_torch.core import mathx
from voidin_tpu_torch.examples import viewer, web_viewer
from voidin_tpu_torch.framework import viewer as t_viewer
from voidin_tpu_torch.framework.app import App, Example
from voidin_tpu_torch.framework.webviewer import run_web
from voidin_tpu_torch.io.image import decode_png
from voidin_tpu_torch.passes.raster import RasterConfig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 5e-3
CFG = RasterConfig(width=128, height=64, tri_capacity=1 << 12,
                   pair_capacity=1 << 13, tile_tri_capacity=64)


class _Demo(Example):
    name = "webdemo"

    def setup_scene(self, app):
        w = app.world
        w.lights.add_point_light([0, 3, 0], 15.0, [1, 1, 1])
        w.instances.add(np.asarray(mathx.from_translation([0, 0, -5])),
                        2, 0)  # SPHERE_1_MESH


def test_ansi_frame_matches_jax():
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (37, 50, 3)).astype(np.uint8),
            (rng.random((20, 30, 3)) * 1.2 - 0.1).astype(np.float32)]
    imgs.append(np.full((4, 6, 3), 77, np.uint8))  # one colour run
    for img in imgs:
        for cols, rows in ((25, 9), (6, 2), (50, 18)):
            want = j_viewer.ansi_frame(img, cols, rows)
            assert t_viewer.ansi_frame(img, cols, rows) == want
            assert t_viewer.ansi_frame(torch.from_numpy(img), cols,
                                       rows) == want
    for shape in ((64, 128, 3), (1080, 1920, 3)):
        assert t_viewer._term_size(shape) == j_viewer._term_size(shape)
        assert (t_viewer._term_size(shape, 40, 10)
                == j_viewer._term_size(shape, 40, 10))


def test_terminal_viewer_headless_frames():
    """run_terminal drives App.step() even without a tty (frames render to
    the provided stream; input is simply absent)."""
    cfg = RasterConfig(width=96, height=64, tri_capacity=1 << 10,
                       pair_capacity=1 << 12)
    app = App(_Demo(), camera=pt.Camera(position=[0, 1, 4]), config=cfg,
              device="cpu")
    buf = io.StringIO()
    n = t_viewer.run_terminal(app, max_frames=2, fps_cap=1000.0, out=buf)
    assert n == 2 and app.state.frame_count == 2
    s = buf.getvalue()
    assert "▀" in s and "fps" in s and "\x1b[38;2;" in s
    assert s.endswith("\x1b[?25h\x1b[0m\n")


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _post(url, obj, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_web_viewer_serves_frames_and_takes_input():
    app = App(_Demo(), camera=pt.Camera(position=[0, 1, 0]), config=CFG,
              device="cpu")
    pos0 = np.asarray(app.state.camera.position).copy()
    ready = threading.Event()
    result = {}

    def drive():
        result["frames"] = run_web(app, port=0, max_frames=200,
                                   fps_cap=1000.0, ready=ready)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    assert ready.wait(60), "server never came up"
    base = f"http://127.0.0.1:{ready.port}"
    try:
        page = _get(base + "/")
        assert b"voidin-tpu viewer" in page
        png = _get(base + "/frame.png", timeout=180)
        img = decode_png(png)
        assert img.shape == (64, 128, 4) and img[..., :3].std() > 0
        stats = json.loads(_get(base + "/stats"))
        assert stats["frame"] >= 1 and len(stats["pos"]) == 3

        # hold W for a few frames -> the camera moved forward
        _post(base + "/input", {"type": "down", "key": "w"})
        f0 = json.loads(_get(base + "/stats"))["frame"]
        while json.loads(_get(base + "/stats"))["frame"] < f0 + 5:
            pass
        _post(base + "/input", {"type": "up", "key": "w"})
        _post(base + "/input", {"type": "look", "dx": 40, "dy": 0})
    finally:
        _post(base + "/input", {"type": "down", "key": "escape"})
        t.join(120)
    assert not t.is_alive()
    assert result["frames"] >= f0 + 5
    pos1 = np.asarray(app.state.camera.position)
    assert np.linalg.norm(pos1 - pos0) > 1e-3, (pos0, pos1)
    assert abs(app.state.camera.yaw) > 1e-3  # drag-look landed


def test_viewer_scene_matches_jax(capsys):
    """The viewers' Spin scene through both packages' App (2 frames at
    64x40), then both port viewer mains headless for two frames."""
    jax_spin = runpy.run_path(os.path.join(ROOT, "examples", "viewer.py"))
    caps = dict(width=64, height=40, tri_capacity=1 << 15,
                pair_capacity=1 << 17)
    apps = {
        "jax": JaxApp(jax_spin["Spin"](), camera=vt.Camera(
            position=[0, 2.5, 0.0], pitch=-14.0, aspect=64 / 40),
            config=JaxRasterConfig(interpret=True, **caps)),
        "port": viewer.make_app(64, 40, "cpu"),
    }
    frames = {k: [np.asarray(a.step()) for _ in range(2)]
              for k, a in apps.items()}
    for a, b in zip(frames["port"], frames["jax"]):
        assert a.shape == (40, 64, 3) and a.std() > 0
        assert np.abs(a - b).mean() < BUDGET
    viewer.main(["--cpu", "--frames", "2", "--width", "48", "--height",
                 "32"])
    web_viewer.main(["--cpu", "--frames", "2", "--width", "48",
                     "--height", "32", "--port", "0"])
    out = capsys.readouterr().out
    assert out.count("viewer closed after 2 frames") == 2
