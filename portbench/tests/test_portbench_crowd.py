"""The walking crowd (configs/rtshadows_crowd.json, recipes/rtshadows_crowd.py)
on the CPU: its humanoid, skeleton, weights and walk at the configuration's
own sizes, the crowd's layout against the camera and the light, and the
harness's whole run of the cell on a cut copy of the configuration: 2
characters with half the sides and segments in every part, 10 of the
rings' 40 instances, the walk's keys a frame apart (a 15-frame lap, so
that a window is 15 frames), and the camera brought up to the characters
so that each covers many of the 160x90 pixels.
"""

import copy

import numpy as np
import pytest
import torch

import run
from pb import animation, check, configs, traffic
from recipes import rtshadows_crowd as crowd
from voidin_tpu_torch.framework import renderer as R

torch.set_num_threads(2)
NAME = "rtshadows_crowd"
CELL = f"{NAME}.static"
SIZE = (160, 90)
DT = 1.0 / 60.0
N_JOINTS = 55


def _config():
    return configs.load(NAME)


def cut_config():
    cfg = copy.deepcopy(_config())
    c = cfg["scene"]["crowd"]
    c["grid"], c["spacing"], c["grid_center"] = [2, 1], 1.0, [0.0, 0.8]
    c["parts"] = {k: [max(4, s // 2), max(1, n // 2)]
                  for k, (s, n) in c["parts"].items()}
    del c["triangles_per_character"]
    c["frames_per_key"] = 1
    cfg["scene"]["n_instances"] = 10
    cfg["camera"] = {"position": [0.0, 0.3, 3.4], "yaw": 0.0, "pitch": -12.0}
    return cfg


def _install_cut(monkeypatch):
    cut, load = cut_config(), configs.load
    monkeypatch.setattr(configs, "load", lambda name: copy.deepcopy(cut)
                        if name == NAME else load(name))


@pytest.fixture(scope="module")
def scene():
    return configs.build_scene(_config(), 2 ** 31 + 17)


def test_humanoid_has_the_stated_triangles_and_55_joints_parents_first():
    p = _config()["scene"]["crowd"]
    mesh, _, _, names, parents, _ = crowd.humanoid(p)
    assert len(mesh.indices) // 3 == p["triangles_per_character"]
    assert 10_000 <= p["triangles_per_character"] <= 12_000
    assert len(names) == len(set(names)) == N_JOINTS
    assert sum("_proximal" in n or "_intermediate" in n or "_distal" in n
               for n in names) == 30
    assert parents[0] == -1 and all(0 <= p < j
                                    for j, p in enumerate(parents) if j)


def test_crowd_skins_each_own_mesh_and_joints(scene):
    assert len(scene.skins) == 32 and len(scene.skeleton) == 32 * N_JOINTS
    assert len({sk.mesh for sk in scene.skins}) == 32
    _, mesh_ids, _ = scene.arrays()
    for c, sk in enumerate(scene.skins):
        assert sk.joint_list == list(range(c * N_JOINTS, (c + 1) * N_JOINTS))
        assert list(mesh_ids).count(sk.mesh) == 1
    for j, joint in enumerate(scene.skeleton):
        assert joint.parent < j
        assert joint.parent < 0 or joint.parent // N_JOINTS == j // N_JOINTS


def test_inverse_binds_undo_the_bind_pose(scene):
    world = []
    for j, joint in enumerate(scene.skeleton):
        local = animation.trs(joint.translation, joint.rotation, joint.scale)
        world.append(local if joint.parent < 0 else world[joint.parent]
                     @ local)
        np.testing.assert_allclose(
            np.asarray(joint.inverse_bind) @ world[j], np.eye(4), rtol=0,
            atol=1e-6)


def test_weights_are_blended_and_normalised(scene):
    sk = scene.skins[0]
    w = sk.weights
    assert w.shape == (len(scene.meshes[sk.mesh].vertices), 4)
    assert (w >= 0).all()
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=0, atol=1e-6)
    n = (w > 0).sum(1)
    assert (n >= 2).mean() >= 0.3 and (n == 4).any()
    assert (0 <= sk.joints).all() and (sk.joints < N_JOINTS).all()


def test_walk_laps_in_60_frames_out_of_step(scene):
    clip = scene.clip
    assert clip.period_frames == 60 and len(clip.times) == 16
    assert np.array_equal(clip.rotation[-1], clip.rotation[0])
    assert np.array_equal(clip.translation[-1], clip.translation[0])
    f0 = animation.joint_matrices(scene, 0, DT)
    assert f0.shape == (32 * N_JOINTS, 4, 4)
    assert np.array_equal(animation.joint_matrices(scene, 60, DT), f0)
    assert np.abs(f0[:N_JOINTS] - f0[N_JOINTS:2 * N_JOINTS]).max() > 0.05
    # every joint turns away from its rest rotation at some key
    rest = np.stack([j.rotation for j in scene.skeleton[:N_JOINTS]])
    dots = np.abs((clip.rotation[:, :N_JOINTS] * rest).sum(-1))
    assert (dots.min(0) < np.cos(np.radians(0.5) / 2)).all()


def test_camera_keeps_every_character_and_sees_their_shadows(scene):
    """Frame 0 at the configuration's camera: the reference's cull keeps
    all 32 posed characters, and the point light's shadow of at least 8
    characters' chests falls on ground the camera sees (the ray from that
    ground point to the light is blocked, the ray to the camera is not)."""
    from reference.render import Reference

    cfg = dict(_config(), width=SIZE[0], height=SIZE[1])
    path = traffic.CameraPath(traffic.load("static"), cfg)
    ref = Reference(scene, cfg, "cpu")
    (ref.tri_pos, ref.tri_n, ref.mesh_min,
     ref.mesh_max) = ref.posed(animation.joint_matrices(scene, 0, DT))
    T = ref.transforms(0, DT)
    cam = check.uniforms(path, cfg, [0])[0]
    inst, _ = ref.draws(T, cam)
    first = len(scene.transforms) - 32
    assert set(range(first, first + 32)) <= set(inst.tolist())

    light = torch.tensor(scene.point_lights[0][0], dtype=torch.float32)
    eye = torch.tensor(cfg["camera"]["position"], dtype=torch.float32)
    chest = T[first:, :3, :3] @ torch.tensor([0.0, 1.2, 0.0]) \
        + T[first:, :3, 3]
    ground = -1.0
    t = (light[1] - ground) / (light[1] - chest[:, 1])
    spot = light + (chest - light) * t[:, None] + torch.tensor([0, 1e-3, 0])
    blocked = ref.occluded(T, spot, light - spot)
    seen = ~ref.occluded(T, eye.expand_as(spot), (spot - eye) * 0.999)
    assert int((blocked & seen).sum()) >= 8


def _run(seed):
    c, per_layer = run.load_cell(CELL)
    out, per_frame = run.run_cell(c, per_layer, seed, 0.3, 0, "cpu",
                                  size=SIZE)
    return out, per_frame


def test_cut_crowd_run_is_correct(monkeypatch):
    """The cut configuration's whole run (set-up, window, check) at
    160x90: the window ends on a whole lap of the walk and every compared
    frame is correct."""
    _install_cut(monkeypatch)
    out, per_frame = _run(2 ** 31 + 5)
    assert out["correct"], out["check"]
    assert out["attempted"] % 15 == 0 and 0 in per_frame


def test_rolled_joint_rows_are_not_correct(monkeypatch):
    """A planted fault: the joint rows handed to Renderer.render rolled by
    one character's 55 rows, so that each character walks in the other's
    phase (7 of the walk's 15 keys apart). Frame 0, compared in every run,
    shows it: the two characters' legs and arms swing the other way."""
    _install_cut(monkeypatch)
    real = R.Renderer.render

    def rolled(self, camera, dt=DT, joint_mats=None):
        return real(self, camera, dt=dt,
                    joint_mats=torch.roll(joint_mats, N_JOINTS, 0))

    monkeypatch.setattr(R.Renderer, "render", rolled)
    out, _ = _run(2 ** 31 + 5)
    assert not out["correct"], out["check"]
