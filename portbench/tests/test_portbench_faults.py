"""A run of a cell with the timed path broken underneath comes out not
correct: the harness's whole run (set-up, window, check) on the CPU at a
tiny size, its look for a card skipped, once for each fault the cell can
have: a step that returns its state unchanged (the TAA history left as
it was), half of each frame
left out (the lower half of the image never written), and an answer
altered where it is produced (each frame's sRGB encode off by 8/255 in
red). The one-chip cells have no exchange between chips to leave out;
rtshadows carries no state from frame to frame."""

import pytest

import run
from voidin_tpu_torch.framework import renderer as R
from voidin_tpu_torch.passes import taa

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
