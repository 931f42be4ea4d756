"""Nothing the benchmark's process loads is JAX or the JAX package, and
the reference loads nothing of the program either. Top-level module
names (before the first dot) are compared whole: voidin_tpu_torch is not
voidin_tpu. Each check runs in a fresh process."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

PRELUDE = f"""
import json, sys
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {HERE!r})
"""
REPORT = """
print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))
"""


def _loaded(body):
    out = subprocess.run([sys.executable, "-c", PRELUDE + body + REPORT],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_timed_process_loads_no_jax():
    """A whole run of a cell (on the CPU, tiny): set-up, the window and
    the check."""
    names = _loaded("""
import run
cell, per_layer = run.load_cell("rtshadows.static")
out, _ = run.run_cell(cell, per_layer, 3, 0.2, 0, "cpu", size=(64, 36))
assert out["attempted"] > 0
""")
    assert "voidin_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "voidin_tpu"}


def test_reference_loads_no_jax_and_no_program():
    names = _loaded("""
import numpy as np
from pb import camera, check, configs, traffic
from reference.render import Reference
cfg = dict(configs.load("northstar"), width=64, height=36)
scene = configs.build_scene(cfg, 5)
ref = Reference(scene, cfg, "cpu")
u = camera.Uniform([0, 2, 30], 0.0, -5.0, 64 / 36, camera.jitter(0, 64, 36))
img, hist = ref.frame(0, u, 1 / 60)
img, _ = ref.frame(1, camera.Uniform([0, 2, 30], 0.0, -5.0, 64 / 36,
                                     camera.jitter(1, 64, 36), previous=u),
                   1 / 60, history=hist)
assert img.shape == (36, 64, 3)
""")
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "voidin_tpu",
                        "voidin_tpu_torch"}


def test_animation_and_skinned_reference_load_no_program():
    """pb/animation.py, and the reference posing a skinned scene (the
    skinned fixture) from its joint matrices, load neither JAX nor the
    JAX package nor the program."""
    names = _loaded(f"""
sys.path.insert(0, {os.path.join(HERE, "tests")!r})
import numpy as np
from pb import animation, camera, check, traffic
from reference.render import Reference
import skinned_fixture as fx
cfg = dict(fx.config(), width=64, height=36)
scene = fx.build(cfg["scene"], 5)
path = traffic.CameraPath(traffic.load("static"), cfg,
                          animation.period(scene))
ref = Reference(scene, cfg, "cpu")
out = check.render_frames(ref, path, cfg, {{7: (None, None, None)}}, scene)
assert out[7][0].shape == (36, 64, 3)
""")
    assert "torch" in names and "numpy" in names
    assert not names & {"jax", "jaxlib", "flax", "voidin_tpu",
                        "voidin_tpu_torch"}


def test_animation_imports_numpy_alone():
    names = _loaded("""
import pb.animation
""")
    assert "numpy" in names
    assert not names & {"torch", "jax", "jaxlib", "flax", "voidin_tpu",
                        "voidin_tpu_torch"}
