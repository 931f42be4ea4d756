"""Port parity: the example twins (voidin_tpu_torch/examples) against the
JAX package's scripts (examples/*.py, run by runpy as
tests/test_torch_closest_hit.py runs bvh_trace.py) at small sizes.

Each pair writes its PNG; the port's (--cpu) must be within BUDGET (5e-3)
mean abs of JAX's in [0, 1] units, the fractal's too (a plain PyTorch
raymarch against XLA's: their transcendentals round differently, 1.5e-4
apart at 48x27). bvh_cpu is the same numpy oracle in both packages: its
PNGs are equal. The viewers' examples are held in
tests/test_torch_viewer.py.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from voidin_tpu_torch.examples import (bvh_cpu, fractal, model,
                                       raytraced_shadows, spheres, trig)
from voidin_tpu_torch.io.image import load_image

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 5e-3

SMALL = ["--width", "64", "--height", "36"]
CASES = {
    "trig": (trig, []),
    "spheres": (spheres, SMALL + ["--frames", "2"]),
    "raytraced_shadows": (raytraced_shadows, SMALL),
    "fractal": (fractal, ["--width", "48", "--height", "27"]),
    "bvh_cpu": (bvh_cpu, ["--width", "24", "--height", "16"]),
    "model": (model, ["--width", "64", "--height", "48", "--frames", "2"]),
}


def _run_jax_example(name, args, out, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args, "--out", out])
    runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                   run_name="__main__")


@pytest.mark.parametrize("name", list(CASES))
def test_example_matches_jax_example(name, tmp_path, monkeypatch):
    mod, args = CASES[name]
    jax_png, port_png = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    _run_jax_example(name, args, jax_png, monkeypatch)
    mod.main(["--cpu", *args, "--out", port_png])
    got, want = load_image(port_png), load_image(jax_png)
    assert got.shape == want.shape and got[..., :3].std() > 0
    diff = np.abs(got.astype(np.float64) - want) / 255.0
    print(f"{name} {got.shape}: mean abs diff {diff.mean():.3e}, max "
          f"{diff.max():.3e}")
    if name == "bvh_cpu":
        np.testing.assert_array_equal(got, want)
    assert diff.mean() < BUDGET


def test_model_example_records_without_ffmpeg(tmp_path, monkeypatch,
                                              capsys):
    """--record without ffmpeg writes the MJPEG-AVI (HUD burnt in) and
    still saves the screenshot."""
    from voidin_tpu_torch.framework import recorder

    monkeypatch.setattr(recorder.shutil, "which", lambda name: None)
    out = str(tmp_path / "shot.png")
    model.main(["--cpu", "--width", "48", "--height", "32", "--frames", "2",
                "--record", str(tmp_path / "clip.mp4"), "--out", out])
    assert os.path.getsize(tmp_path / "clip.avi") > 0
    assert load_image(out).shape == (32, 48, 4)
    assert "overflow: 0" in capsys.readouterr().out
