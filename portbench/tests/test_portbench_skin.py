"""Skinned scenes in the harness, on the CPU: the joint matrices of a
scene's animation (pb/animation.py), the program handed them through
Renderer.render, and the reference posing the same geometry itself. The
fixture is rtshadows' scene with its knot a skin of 2 joints
(skinned_fixture.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import run
import skinned_fixture as fx
from pb import animation, check, configs, program, traffic
from pb import scene as sc
from reference.render import Reference

torch.set_num_threads(2)
SIZE = (160, 90)
DT = 1.0 / 60.0


def _rz(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    return m


def _t(x, y, z):
    m = np.eye(4)
    m[:3, 3] = x, y, z
    return m


def _q(deg):
    a = np.radians(deg) / 2.0
    return np.array([0.0, 0.0, np.sin(a), np.cos(a)])


def _chain():
    """Two joints: a root at (1, 0, 0) turned 90 degrees about z and
    scaled 2, and its child, whose clip (keys at frames 0, 2, 4; period
    4) moves it from (0, 1, 0) to (0, 3, 0) and back and turns it to 90
    degrees about z and back, the middle key's quaternion stored negated
    (the same turn: slerp takes the short arc). Two skins list the joints
    as [1] and [0, 1]."""
    s = sc.Scene()
    s.skeleton = [
        sc.Joint(-1, np.array([1.0, 0, 0]), _q(90), np.full(3, 2.0),
                 np.eye(4)),
        sc.Joint(0, np.array([0, 1.0, 0]), _q(0), np.ones(3), _t(0, -1, 0))]
    root_t = np.tile([1.0, 0, 0], (3, 1))
    child_t = np.array([[0, 1.0, 0], [0, 3.0, 0], [0, 1.0, 0]])
    s.clip = sc.Clip(
        times=np.array([0.0, 2 * DT, 4 * DT]),
        translation=np.stack([root_t, child_t], 1),
        rotation=np.stack([np.tile(_q(90), (3, 1)),
                           np.stack([_q(0), -_q(90), _q(0)])], 1),
        scale=np.stack([np.full((3, 3), 2.0), np.ones((3, 3))], 1),
        period_frames=4)
    vw = np.zeros((1, 4), np.int32)
    s.skins = [sc.Skin(0, vw, np.ones((1, 4), np.float32), [1]),
               sc.Skin(0, vw, np.ones((1, 4), np.float32), [0, 1])]
    return s


@pytest.mark.parametrize("frame,child_deg,child_y", [
    (0, 0.0, 1.0),  # a key
    (2, 90.0, 3.0),  # a key, its quaternion stored negated
    (1, 45.0, 2.0),  # the slerp and lerp midpoint
    (5, 45.0, 2.0),  # the loop's wrap: frame 5 is frame 1
    (7, 45.0, 2.0),  # frame 3: between the middle and last keys
])
def test_joint_matrices_of_a_two_joint_chain(frame, child_deg, child_y):
    root = _t(1, 0, 0) @ _rz(90) @ np.diag([2.0, 2.0, 2.0, 1.0])
    child = root @ _t(0, child_y, 0) @ _rz(child_deg)
    want = np.stack([child @ _t(0, -1, 0), root, child @ _t(0, -1, 0)])
    got = animation.joint_matrices(_chain(), frame, DT)
    assert got.dtype == np.float32 and got.shape == (3, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # hand-worked: frame 1's child row is 2 Rz(135) about (-3 + sqrt 2,
    # sqrt 2, 0)
    if frame == 1:
        r2 = np.sqrt(2.0)
        np.testing.assert_allclose(got[0, :3, 3], [-3 + r2, r2, 0],
                                   atol=1e-6)
        np.testing.assert_allclose(got[0, :2, :2], [[-r2, -r2], [r2, -r2]],
                                   atol=1e-6)


def test_period_table_and_window_lap():
    s = _chain()
    assert animation.period(s) == 4
    table = animation.period_table(s, DT)
    assert table.shape == (4, 3, 4, 4)
    for f in range(9):
        assert np.array_equal(table[f % 4],
                              animation.joint_matrices(s, f, DT))
    cfg = configs.load("northstar")
    fly = traffic.CameraPath(traffic.load("fly"), cfg, 7)
    assert fly.lap == 240 * 7
    assert traffic.CameraPath(traffic.load("static"), cfg, 14).lap == 14
    assert traffic.CameraPath(traffic.load("fly"), cfg).lap == 240
    assert animation.period(sc.Scene()) == 1


def _fixture(seed=2 ** 31 + 9):
    cfg = dict(fx.config(), width=SIZE[0], height=SIZE[1])
    return cfg, fx.build(cfg["scene"], seed)


def _numpy_lbs(scene, jm):
    """(V, 3) f64 linear-blend skinning of the fixture knot's rest
    vertices by (J, 4, 4) joint matrices."""
    sk = scene.skins[0]
    v = np.concatenate([scene.meshes[sk.mesh].vertices.astype(np.float64),
                        np.ones((len(sk.joints), 1))], 1)
    w = sk.weights.astype(np.float64)
    w = w / w.sum(1, keepdims=True)
    M = jm.astype(np.float64)[np.asarray(sk.joints)]  # (V, 4, 4, 4)
    return np.einsum("vk,vkij,vj->vi", w, M, v)[:, :3]


def test_identity_pose_renders_as_the_rest_pose():
    """Under identity joint matrices the program's skinned frame is its
    unskinned frame, and the reference's posed pool its rest pool, to
    the rounding of a weighted blend (sum_k w_k v is v to an ulp) and of
    a normal's oct32 word (one step): the program's frame differs in 3
    of its 43,200 values, by 1.1e-5 at most, since its skinning blends
    in f32 and normalises the normals before it encodes them."""
    cfg, scene = _fixture()
    rest = dataclasses.replace(scene, skins=[], skeleton=[], clip=None)
    path = traffic.CameraPath(traffic.load("static"), cfg)
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    cam = program.camera(path.pose(0), *SIZE)
    skinned = program.make_renderer(cfg, scene, "cpu").render(
        cam, dt=path.dt, joint_mats=torch.from_numpy(eye))
    plain = program.make_renderer(cfg, rest, "cpu").render(cam, dt=path.dt)
    diff = (skinned - plain).abs()
    assert float(diff.max()) < 1e-4 and float(diff.mean()) < 1e-8, (
        float(diff.max()), float(diff.mean()))

    ref = Reference(scene, cfg, "cpu")
    tri_pos, tri_n, mn, mx = ref.posed(eye)
    r_pos, r_n, r_mn, r_mx = ref.rest
    assert float((tri_pos - r_pos).abs().max()) <= 2.4e-7
    assert float((mn - r_mn).abs().max()) <= 2.4e-7
    assert float((mx - r_mx).abs().max()) <= 2.4e-7
    # one oct32 step is 2 / 65535 in a component before the normalise
    assert float((tri_n - r_n).abs().max()) < 1e-4
    # the meshes without a skin keep their rows word for word
    b = int(ref.mesh_base[fx.KNOT])
    c = int(ref.mesh_count[fx.KNOT])
    assert torch.equal(tri_pos[:b], r_pos[:b])
    assert torch.equal(tri_pos[b + c:], r_pos[b + c:])
    assert torch.equal(tri_n[b + c:], r_n[b + c:])


@pytest.mark.parametrize("frame", [3, 7])
def test_reference_poses_as_numpy_linear_blend(frame):
    cfg, scene = _fixture()
    jm = animation.joint_matrices(scene, frame, DT)
    want = _numpy_lbs(scene, jm)
    ref = Reference(scene, cfg, "cpu")
    tri_pos, _, mn, mx = ref.posed(jm)
    b = int(ref.mesh_base[fx.KNOT])
    tri = scene.meshes[fx.KNOT].indices.reshape(-1, 3)
    got = tri_pos[b:b + len(tri)].numpy().astype(np.float64)
    np.testing.assert_allclose(got, want[tri], rtol=0, atol=1e-6)
    np.testing.assert_allclose(mn[fx.KNOT].numpy(), want.min(0), atol=1e-6)
    np.testing.assert_allclose(mx[fx.KNOT].numpy(), want.max(0), atol=1e-6)
    # the pose moved the knot: its top turned away from the rest
    assert float(np.abs(want - scene.meshes[fx.KNOT].vertices).max()) > 0.3


def test_skinned_run_is_correct(monkeypatch):
    """The fixture's whole run (set-up, window, check) at 160x90: the
    window ends on a whole lap of the animation, and every compared
    frame, the window's first (a bent pose) among them, is correct."""
    fx.install(monkeypatch)
    out, per_frame = run.run_cell(fx.CELL, [], 11, 0.3, 0, "cpu", size=SIZE)
    assert out["correct"], out["check"]
    assert out["attempted"] % 14 == 0
    assert 7 in per_frame and check.load_limits(fx.CELL["name"]) \
        == check.load_limits("rtshadows.static")
