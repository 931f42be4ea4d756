"""The precision control comes out not correct: the plain reference put
in the program's place and computed in bfloat16 (the nearest precision
below the float32 the configurations state), judged against the float32
reference with each cell's limits, at a size a test run holds."""

import pytest
import torch

from pb import check, configs, traffic
from reference.render import Reference

SIZE = (160, 90)


@pytest.mark.parametrize("cell,config,mix", [
    ("northstar.static", "northstar", "static"),
    ("northstar.fly", "northstar", "fly"),
    ("rtshadows.static", "rtshadows", "static"),
])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 77])
def test_bf16_control_fails(cell, config, mix, seed):
    cfg = dict(configs.load(config), width=SIZE[0], height=SIZE[1])
    path = traffic.CameraPath(traffic.load(mix), cfg)
    scene = configs.build_scene(cfg, seed)
    ctl = Reference(scene, cfg, "cpu", dtype=torch.bfloat16)
    kept = check.render_frames(ctl, path, cfg,
                               {f: (None, None, None) for f in range(2)},
                               scene)
    per_frame = check.reference_numbers(cfg, path, scene, kept, "cpu")
    ok, numbers = check.verdict(per_frame, check.load_limits(cell))
    assert not ok, numbers
