"""Test fixture of a skinned scene: rtshadows' scene (recipes/rtshadows.py)
with its knot mesh a skin of 2 joints and a looping clip, as the recipe
of configuration "rtshadows_skinned" (skinned_fixture.json beside this
file). The weights go by height, as chip_smoke.py knot_skin binds the
knot: the lowest vertices follow joint 0, the highest joint 1, blended
linearly between. Joint 0 is the root at the knot's lowest point, joint
1 its child at `pivot`; the clip's keys, frames_per_key frames apart,
turn joint 1 about z by bend_deg (the last key the first, so the clip
loops). Every instance of the knot takes the pose.

The configuration lives here, not in configs/, so no cell can name it:
install() makes configs.load, configs.build_scene and check.load_limits
(rtshadows.static's limits) take it for the tests' run of CELL.
"""

import json
import os

import numpy as np

from pb import scene as sc
from recipes import rtshadows

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = "rtshadows_skinned"
CELL = {"name": f"{NAME}.static", "config": NAME, "traffic": "static",
        "chips": 1, "why": "test fixture"}
KNOT = 4  # the first mesh rtshadows' recipe adds


def config():
    with open(os.path.join(HERE, "skinned_fixture.json")) as f:
        return json.load(f)


def _quat_z(deg):
    a = np.radians(deg) / 2.0
    return np.array([0.0, 0.0, np.sin(a), np.cos(a)])


def build(params, seed):
    s = rtshadows.build(params, seed)
    p = params["skin"]
    y = s.meshes[KNOT].vertices[:, 1]
    h = ((y - y.min()) / (y.max() - y.min())).astype(np.float32)
    joints = np.zeros((len(y), 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((len(y), 4), np.float32)
    weights[:, 0], weights[:, 1] = 1.0 - h, h
    s.skins.append(sc.Skin(KNOT, joints, weights, [0, 1]))

    root = np.array([0.0, float(y.min()), 0.0])
    pivot = np.asarray(p["pivot"], np.float64)
    rest_t = np.stack([root, pivot - root])  # joint 1 local to joint 0
    unit_q = np.array([0.0, 0.0, 0.0, 1.0])
    for j, parent in enumerate((-1, 0)):
        world = root if j == 0 else pivot
        inv_bind = np.eye(4)
        inv_bind[:3, 3] = -world
        s.skeleton.append(sc.Joint(parent, rest_t[j], unit_q, np.ones(3),
                                   inv_bind))
    bend = np.asarray(p["bend_deg"], np.float64)
    k = len(bend)
    step = int(p["frames_per_key"])
    rot = np.stack([np.tile(unit_q, (k, 1)),
                    np.stack([_quat_z(d) for d in bend])], 1)
    s.clip = sc.Clip(times=np.arange(k) * step * float(p["frame_s"]),
                     translation=np.tile(rest_t, (k, 1, 1)), rotation=rot,
                     scale=np.ones((k, 2, 3)), period_frames=(k - 1) * step)
    return s


def install(monkeypatch):
    """configs.load / build_scene and check.load_limits take the fixture
    for NAME and CELL, and the cells of BENCHMARK.json as before."""
    from pb import check, configs

    load, build_scene, limits = (configs.load, configs.build_scene,
                                 check.load_limits)
    monkeypatch.setattr(configs, "load", lambda name: config()
                        if name == NAME else load(name))
    monkeypatch.setattr(configs, "build_scene", lambda cfg, seed: build(
        cfg["scene"], int(seed)) if cfg["name"] == NAME
        else build_scene(cfg, seed))
    monkeypatch.setattr(check, "load_limits", lambda w: limits(
        "rtshadows.static") if w == CELL["name"] else limits(w))
