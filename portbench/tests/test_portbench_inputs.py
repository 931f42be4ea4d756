"""The scene arrays and the camera path repeat exactly under one seed;
another seed draws other inputs for the same work."""

import numpy as np
import pytest

from pb import configs, traffic


def _arrays(scene):
    T, mesh, mat = scene.arrays()
    tex = [img for img, _ in scene.textures]
    lights = [np.concatenate([np.ravel(x) for x in light])
              for light in scene.point_lights]
    return T, mesh, mat, tex, lights, scene.moving


@pytest.mark.parametrize("name", ["northstar", "rtshadows"])
def test_scene_repeats_under_one_seed(name):
    cfg = configs.load(name)
    a = _arrays(configs.build_scene(cfg, 2 ** 31 + 77))
    b = _arrays(configs.build_scene(cfg, 2 ** 31 + 77))
    for x, y in zip(a, b):
        if isinstance(x, list):
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
        else:
            assert np.array_equal(x, y)


@pytest.mark.parametrize("name", ["northstar", "rtshadows"])
def test_other_seed_same_work(name):
    """The set of instances (so the triangles of a frame) is the seed's
    permutation of one set; what the seed draws differs."""
    cfg = configs.load(name)
    s1, s2 = configs.build_scene(cfg, 1), configs.build_scene(cfg, 2)
    T1, m1, _ = s1.arrays()
    T2, m2, _ = s2.arrays()
    key = lambda T, m: sorted(map(tuple, np.concatenate(  # noqa: E731
        [T.reshape(len(T), -1), m[:, None]], 1).round(5).tolist()))
    assert key(T1, m1) == key(T2, m2)
    assert not np.array_equal(T1, T2)
    assert len(s1.moving) == len(s2.moving)


def test_fly_loop_poses_repeat_and_close():
    cfg = configs.load("northstar")
    mix = traffic.load("fly")
    p = traffic.CameraPath(mix, cfg)
    q = traffic.CameraPath(mix, cfg)
    period = mix["camera"]["period_frames"]
    assert [p.pose(f) for f in range(0, 500, 7)] == \
        [q.pose(f) for f in range(0, 500, 7)]
    for f in (0, 13, 101):
        a, b = p.pose(f), p.pose(f + period)
        assert np.allclose(a[0], b[0]) and abs(a[1] - b[1]) < 1e-9
    pos0, _, pitch = p.pose(0)
    assert np.allclose(pos0, cfg["camera"]["position"])
    assert pitch == mix["camera"]["pitch"]
    # facing along the loop: the next pose lies ahead
    pos1 = p.pose(1)[0]
    yaw = np.radians(p.pose(0)[1])
    ahead = np.array([-np.sin(yaw), 0.0, -np.cos(yaw)])
    assert np.dot(np.subtract(pos1, pos0), ahead) > 0


def test_static_pose_is_the_configurations():
    for name in ("northstar", "rtshadows"):
        cfg = configs.load(name)
        p = traffic.CameraPath(traffic.load("static"), cfg)
        assert p.pose(0) == p.pose(999) == (cfg["camera"]["position"],
                                            cfg["camera"]["yaw"],
                                            cfg["camera"]["pitch"])


@pytest.mark.parametrize("mix,lap", [("fly", 240), ("static", 1)])
def test_window_ends_on_a_whole_lap(mix, lap):
    """A window ends at the first whole lap of the path once its seconds
    have passed, so a faster program covers the same poses as often."""
    p = traffic.CameraPath(traffic.load(mix), configs.load("northstar"))
    assert p.lap == lap
    assert not p.window_ends(lap, 24.9, 25.0)
    ends = [n for n in range(1, 3 * lap + 1) if p.window_ends(n, 25.0, 25.0)]
    assert ends[0] == lap and all(n % lap == 0 for n in ends)
