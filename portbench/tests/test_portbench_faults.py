"""A run of a cell with the timed path broken underneath comes out not
correct: the harness's whole run (set-up, window, check) on the CPU at a
tiny size, its look for a card skipped, once for each fault the cell can
have: a step that returns its state unchanged (the TAA history left as
it was), half of each frame
left out (the lower half of the image never written), and an answer
altered where it is produced (each frame's sRGB encode off by 8/255 in
red). The one-chip cells have no exchange between chips to leave out;
rtshadows carries no state from frame to frame.

A skinned scene (the fixture of skinned_fixture.py: rtshadows with its
knot a skin of 2 joints) has two more: a pose left stale (the program
handed frame 0's joint matrices every frame) and the refits left out
(the BLAS and TLAS keep the rest pose's boxes, so shadow rays miss what
the pose moved out of them)."""

import pytest

import run
import skinned_fixture as fx
from voidin_tpu_torch.framework import renderer as R
from voidin_tpu_torch.passes import taa
from voidin_tpu_torch.scene import skin

SIZE = (160, 90)


def _stale_history(monkeypatch):
    real = taa.taa

    def frozen(color, gbuffer, camera, state, **kw):
        if not state.history_valid:
            return real(color, gbuffer, camera, state, **kw)
        copy = state.__class__(state.history.clone(), True)
        out, _, ovf = real(color, gbuffer, camera, copy, **kw)
        return out, state, ovf

    monkeypatch.setattr(taa, "taa", frozen)


def _half_frame(monkeypatch):
    real = R.Renderer.render

    def half(self, *a, **k):
        img = real(self, *a, **k)
        img[img.shape[0] // 2:] = 0.0
        return img

    monkeypatch.setattr(R.Renderer, "render", half)


def _altered(monkeypatch):
    real = R.linear_to_srgb

    def off(c):
        out = real(c)
        out[..., 0] += 8.0 / 255.0
        return out

    monkeypatch.setattr(R, "linear_to_srgb", off)


def _stale_pose(monkeypatch):
    real = R.Renderer.render
    first = []

    def stale(self, camera, dt=1.0 / 60.0, joint_mats=None):
        if joint_mats is not None:
            if not first:
                first.append(joint_mats.clone())
            joint_mats = first[0]
        return real(self, camera, dt=dt, joint_mats=joint_mats)

    monkeypatch.setattr(R.Renderer, "render", stale)


def _no_refits(monkeypatch):
    monkeypatch.setattr(skin, "refit_blas", lambda meshes, sk, pos: meshes)
    monkeypatch.setattr(skin, "refit_tlas", lambda tlas, meshes, inst: tlas)


def _run(cell, seed=11):
    c, per_layer = run.load_cell(cell)
    out, _ = run.run_cell(c, per_layer, seed, 0.3, 0, "cpu", size=SIZE)
    return out


@pytest.mark.parametrize("cell", ["northstar.static", "rtshadows.static"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("northstar.static", _stale_history),
    ("northstar.fly", _stale_history),
    ("northstar.static", _half_frame),
    ("northstar.fly", _half_frame),
    ("rtshadows.static", _half_frame),
    ("northstar.static", _altered),
    ("northstar.fly", _altered),
    ("rtshadows.static", _altered),
])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", [_stale_pose, _no_refits])
def test_skin_fault_is_not_correct(fault, monkeypatch):
    """The window's first frame (frame 7) is compared in every run: its
    knot is bent by 70 degrees (frame 0's is at rest), and the bent
    knots' shadows fall on the ground."""
    fx.install(monkeypatch)
    fault(monkeypatch)
    out, _ = run.run_cell(fx.CELL, [], 11, 0.3, 0, "cpu", size=SIZE)
    assert not out["correct"], out["check"]
