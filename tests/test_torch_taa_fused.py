"""The one-launch TAA (ops/taa.py taa_resolve_fused) on the CPU, where it
runs the plain PyTorch twin its caller hands it (passes/taa.py
taa_fused_reference), and taa()'s choice of it.

The choice is a static test of the history fetch options: the
quad-block and in-window fetches keep the eager chain, the default fetch
takes the kernel, and the first frame (no valid history) launches
nothing. At the goldens' 160x96 scale, on a jittered camera that moves
or turns (history uv outside [0, 1]) and on a history holding -0.0, NaN
and infinite texels (chip_smoke.taa_edge_camera, taa_edge_inputs),
taa_resolve_fused gives the words of reproject -> taa_resolve as taa()
computed them before the kernel, and taa()'s default path gives those
words too. The card holds the kernel to this
twin word for word (tests/test_torch_cuda.py -k taa_kernel).
"""

import numpy as np
import pytest
import torch

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework import profiler
from voidin_tpu_torch.framework.renderer import FrameState
from voidin_tpu_torch.ops import taa as taa_op
from voidin_tpu_torch.passes import taa as t_taa
from voidin_tpu_torch.passes.gbuffer import GBuffer

from chip_smoke import taa_edge_camera, taa_edge_inputs

torch.set_num_threads(2)

H, W = 96, 160


def _camera(kind):
    return taa_edge_camera(pt, kind, H, W)


def _inputs(kind):
    return tuple(torch.from_numpy(a) for a in taa_edge_inputs(kind, H, W))


def _chain(color, depth, history, cam):
    """reproject -> taa_resolve, as taa() ran them before the kernel."""
    motion = t_taa.reproject(GBuffer(normal_uv=None, material=None,
                                     depth=depth), cam)
    return t_taa.taa_resolve(color, history, motion)[0], motion


def _words(t):
    return t.contiguous().view(torch.int32)


CASES = ["moving", "turning", "adversarial"]


@pytest.mark.parametrize("kind", CASES)
def test_twin_gives_the_chain(kind):
    color, depth, history = _inputs(kind)
    cam = _camera("turning" if kind == "turning" else "moving")
    want, motion = _chain(color, depth, history, cam)
    n = taa_op.LAUNCHES
    got = taa_op.taa_resolve_fused(color, depth, history, cam,
                                   weights=t_taa.NEIGHBOURHOOD,
                                   twin=t_taa.taa_fused_reference)
    assert taa_op.LAUNCHES == n  # the CPU runs the twin
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert torch.equal(_words(got), _words(want))
    valid = motion[..., 2]
    assert (valid == 1).any()
    hu = (torch.arange(W) + 0.5) / W - motion[..., 0] * 0.5
    if kind == "turning":  # history uv outside [0, 1], and flagged invalid
        assert ((hu < 0) | (hu > 1)).float().mean() > 0.2
        assert (valid == 0).any()
    if kind == "adversarial":  # the bad texels reach the output
        assert not torch.isfinite(got).all()
        assert torch.isfinite(got).float().mean() > 0.5


@pytest.mark.parametrize("kind", CASES)
def test_default_taa_resolves_through_the_op(kind, monkeypatch):
    """taa() on a valid history: one call of taa_resolve_fused with the
    twin and the neighbourhood's weights, the chain's words, written into
    the history in place."""
    color, depth, history = _inputs(kind)
    cam = _camera("turning" if kind == "turning" else "moving")
    want, _ = _chain(color, depth, history, cam)
    seen = []
    real = taa_op.taa_resolve_fused
    monkeypatch.setattr(
        taa_op, "taa_resolve_fused",
        lambda *a, **k: (seen.append(k), real(*a, **k))[1])
    state = FrameState(history=history.clone(), history_valid=True)
    buf = state.history
    out, state, ovf = t_taa.taa(color, GBuffer(None, None, depth), cam,
                                state)
    assert len(seen) == 1 and seen[0]["twin"] is t_taa.taa_fused_reference
    assert seen[0]["weights"] is t_taa.NEIGHBOURHOOD
    assert out is buf and state.history is buf and state.history_valid
    assert int(ovf) == 0
    assert torch.equal(_words(out), _words(want))


# (taa_quad_history, taa_inwindow, takes the kernel)
ROUTES = [(False, False, True), (True, False, False), (False, True, False),
          (True, True, False)]


@pytest.mark.parametrize("quad,inwindow,kernel", ROUTES,
                         ids=["default", "taa_quad_history", "taa_inwindow",
                              "both"])
def test_path_choice_is_static(quad, inwindow, kernel):
    assert t_taa.takes_taa_kernel(quad, inwindow) is kernel


@pytest.mark.parametrize("opts", [dict(quad_history=True),
                                  dict(quad_history=True,
                                       quad_select="where"),
                                  dict(inwindow=True)],
                         ids=["taa_quad_history", "taa_quad_where",
                              "taa_inwindow"])
def test_fetch_options_keep_the_chain(opts, monkeypatch):
    """The quad-block and in-window fetches resolve through the eager
    chain, taa_resolve_fused untouched, with their fetch's words."""
    monkeypatch.setattr(taa_op, "taa_resolve_fused", None)
    color, depth, history = _inputs("moving")
    cam = _camera("moving")
    motion = t_taa.reproject(GBuffer(None, None, depth), cam)
    want, _ = t_taa.taa_resolve(color, history, motion, **opts)
    state = FrameState(history=history.clone(), history_valid=True)
    out, _, ovf = t_taa.taa(color, GBuffer(None, None, depth), cam, state,
                            **opts)
    assert torch.equal(_words(out), _words(want))
    assert int(ovf) == 0


@pytest.mark.parametrize("opts", [{}, dict(inwindow=True)],
                         ids=["default", "taa_inwindow"])
def test_frame_zero_launches_nothing(opts, monkeypatch):
    """Without a valid history taa() seeds it with the frame: no call of
    taa_resolve_fused on either path, the frame's words out."""
    monkeypatch.setattr(taa_op, "taa_resolve_fused", None)
    color, depth, _ = _inputs("moving")
    state = FrameState(history=torch.zeros(H, W, 3), history_valid=False)
    out, state, ovf = t_taa.taa(color, GBuffer(None, None, depth),
                                _camera("moving"), state, **opts)
    assert torch.equal(_words(out), _words(color)) and state.history_valid
    assert int(ovf) == 0


@pytest.mark.parametrize("opts,valid,want", [
    ({}, True, {"taa.kernel_px": H * W}),
    ({}, False, {}),
    (dict(quad_history=True), True, {"taa.eager_px": H * W}),
    (dict(inwindow=True), True, {"taa.eager_px": H * W}),
    (dict(inwindow=True), False, {})],
    ids=["default", "default_frame0", "taa_quad_history", "taa_inwindow",
         "taa_inwindow_frame0"])
def test_counters_count_the_pixels_each_path_resolved(opts, valid, want):
    color, depth, history = _inputs("moving")
    state = FrameState(history=history.clone(), history_valid=valid)
    profiler.disable()
    profiler.collect()
    profiler.enable()
    try:
        t_taa.taa(color, GBuffer(None, None, depth), _camera("moving"),
                  state, **opts)
    finally:
        profiler.disable()
    got, scopes = {}, set()
    for d in profiler.collect():
        scopes.add(d["name"])
        for k, v in d["counters"].items():
            got[k] = got.get(k, 0) + v
    assert {k: v for k, v in got.items() if k.endswith("_px")} == want
    assert ("taa.kernel" in scopes) == ("taa.kernel_px" in want)


def test_constants_are_the_chains_f32_scalars():
    """The kernel's constants: the camera's f32 matrices and jitters, the
    in-bounds limits as torch's clamp casts the chain's f64 expressions,
    the weights rounded to f32, and f32 reciprocals of the Python divisors
    (the weights' f64 sums, the smoothstep spans, W and H)."""
    cam = _camera("moving")
    c = taa_op.constants(cam, H, W, t_taa.NEIGHBOURHOOD)
    assert c.dtype == np.float32 and c.shape == (64,)
    f32 = np.float32
    np.testing.assert_array_equal(c[:16], np.asarray(cam.clip_to_world,
                                                     f32).reshape(16))
    np.testing.assert_array_equal(c[16:32], np.asarray(
        cam.prev_world_to_clip, f32).reshape(16))
    np.testing.assert_array_equal(c[32:36], np.concatenate(
        [cam.jitter, cam.prev_jitter]).astype(f32))
    assert c[36] == f32(-1.0 + float(f32(1.0 / W))) and c[37] == -c[36]
    assert c[38] == f32(-1.0 + float(f32(1.0 / H))) and c[39] == -c[38]
    assert c[40] == f32(1.0 / W) and c[41] == f32(1.0 / H)
    w = [n[2] for n in t_taa.NEIGHBOURHOOD]
    wt = [n[3] for n in t_taa.NEIGHBOURHOOD]
    np.testing.assert_array_equal(c[42:51], np.asarray(w, f32))
    np.testing.assert_array_equal(c[51:60], np.asarray(wt, f32))
    assert c[60] == f32(1.0 / sum(w)) and c[61] == f32(1.0 / sum(wt))
    assert c[62] == f32(2.5) and c[63] == f32(0.5)
    assert c[46] == 1.0 and c[42] == c[44] == c[48] == c[50]
    with pytest.raises(ValueError, match="ORDER"):
        taa_op.constants(cam, H, W, t_taa.NEIGHBOURHOOD[::-1])


def test_inputs_taken_as_the_kernel_reads_them():
    t = torch.zeros(4, 6, 3)
    assert taa_op._image("color", t, (4, 6, 3), t.device) is t
    view = torch.zeros(4, 3, 6).transpose(1, 2)  # (4, 6, 3), not dense
    for bad in (t.to(torch.float64), t[:, :5], t[..., :2], view):
        with pytest.raises(ValueError, match="color"):
            taa_op._image("color", bad, (4, 6, 3), t.device)

    def twin(*args):
        raise AssertionError("the twin ran on inputs the kernel refuses")

    # the CPU path holds its inputs to the kernel's contract too
    with pytest.raises(ValueError, match="history"):
        taa_op.taa_resolve_fused(t, torch.zeros(4, 6), view, _camera(
            "moving"), weights=t_taa.NEIGHBOURHOOD, twin=twin)
