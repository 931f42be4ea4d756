"""The plain reference against the port, on a tiny frame of each
configuration on the CPU (the port's CPU twins stand in for its CUDA
kernels): every compared frame within the cell's limits, and the
reference's own TAA chain (from its own history) within them too."""

import numpy as np
import pytest
import torch

from pb import camera as pcam
from pb import check, configs, program, traffic
from reference.render import Reference

SIZE = (160, 90)


def _program_frames(cell, mix_name, n, seed):
    cfg = dict(configs.load(cell), width=SIZE[0], height=SIZE[1])
    mix = traffic.load(mix_name)
    path = traffic.CameraPath(mix, cfg)
    scene = configs.build_scene(cfg, seed)
    r = program.make_renderer(cfg, scene, "cpu")
    taa = cfg["renderer"]["enable_taa"]
    kept = {}
    for f in range(n):
        before = r.state.history.clone() if taa and r.state.history_valid \
            else None
        img = r.render(program.camera(path.pose(f), *SIZE), dt=path.dt)
        kept[f] = (img.clone(), before,
                   r.state.history.clone() if taa else None)
    return cfg, path, scene, kept


@pytest.mark.parametrize("cell,config,mix,n", [
    ("northstar.static", "northstar", "static", 3),
    ("northstar.fly", "northstar", "fly", 3),
    ("rtshadows.static", "rtshadows", "static", 1),
])
def test_port_matches_reference(cell, config, mix, n):
    cfg, path, scene, kept = _program_frames(config, mix, n, seed=2 ** 31 + 9)
    per_frame = check.reference_numbers(cfg, path, scene, kept, "cpu")
    ok, numbers = check.verdict(per_frame, check.load_limits(cell))
    assert ok, numbers


def test_reference_taa_chain_from_its_own_history():
    """Three TAA frames of the reference from its own history, against the
    port's three frames: the history's start and updates agree without
    the program's state."""
    cfg, path, scene, kept = _program_frames("northstar", "fly", 3, seed=4)
    ref = Reference(scene, cfg, "cpu")
    cams = check.uniforms(path, cfg, range(3))
    hist = None
    for f in range(3):
        img, hist = ref.frame(f, cams[f], path.dt, history=hist)
        nums = check.compare(kept[f][0], img)
        assert nums["mean_abs"] < 1e-4 and nums["off_share"] < 2e-3, nums


def test_reference_in_pixels_is_not_trivial():
    cfg, path, scene, kept = _program_frames("rtshadows", "static", 1, seed=3)
    img = kept[0][0]
    assert torch.isfinite(img).all() and float(img.std()) > 0.05
    # the brute-force any-hit: a ray from under a sphere up through it
    # hits; the same ray turned away does not
    ref = Reference(scene, cfg, "cpu")
    T = ref.transforms(0, path.dt)
    res = cfg["scene"]["sphere_resolution"]
    sphere = next(i for i, m in enumerate(scene.mesh_ids)
                  if scene.meshes[m].vertices.shape[0]
                  == (4 * res + 1) * (8 * res + 1))
    c = T[sphere, :3, 3]
    o = (c - torch.tensor([0.0, 5.0, 0.0]))[None]
    up = torch.tensor([[0.0, 10.0, 0.0]])
    assert bool(ref.occluded(T, o, up)[0])
    assert not bool(ref.occluded(T, o, -up)[0])
    assert np.isfinite(pcam.jitter(17, *SIZE)).all()
