"""The profiler's frame scopes (voidin_tpu_torch/framework/profiler.py
scope / count / collect) on small north-star frames.

CPU: off, a frame records nothing, creates no CUDA event and computes no
counter; on, the tree of names, parents and frame numbers of a frame (the
sharded frame's and profile_frame's passes too), self time as the
duration less the children's, the work counters against the frame's own
aux, and an image and TAA history bit-identical to the frames rendered
with the switch off; GPU_PROFILING makes the App print the scope table
every DUMP_EVERY frames.

Card (marked `cuda`, skipped without a CUDA device): a scope's host clock
lines up with torch.profiler's device timestamps, .item() counts one sync
and a kernel alone none, and the cull's camera upload counts a sync where
it makes the host wait for the device. On the card:

    python -m pytest tests/test_torch_scopes.py --noconftest -q -m cuda
"""

import time
import warnings

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import voidin_tpu_torch as pt
from voidin_tpu_torch.framework import profiler
from voidin_tpu_torch.framework.app import App, Example
from voidin_tpu_torch.framework.renderer import Renderer, build_world
from voidin_tpu_torch.parallel import sharding as sh
from voidin_tpu_torch.passes import cull
from voidin_tpu_torch.passes.raster import RasterConfig

CFG = RasterConfig(width=64, height=32, tri_capacity=1 << 13,
                   pair_capacity=1 << 13)
CAMERA = dict(position=[0.0, 2.0, 30.0], pitch=-5.0, aspect=2.0)
# a frame's scopes and their parents, in entry order, for the default
# (pair path, TAA, post) frame that reads a history
TREE = [("frame", None), ("frame.begin", "frame"), ("update", "frame"),
        ("cull", "frame"), ("raster", "frame"), ("raster.setup", "raster"),
        ("raster.bin", "raster"), ("raster.k1", "raster"),
        ("raster.untile", "raster"), ("raster.untile", "raster"),
        ("resolve", "frame"), ("resolve.kernel", "resolve"),
        ("resolve.fetch", "resolve.kernel"),
        ("resolve.fields", "resolve.kernel"), ("shade", "frame"),
        ("shade.point", "shade"), ("shade.rect", "shade"),
        ("taa", "frame"), ("taa.kernel", "taa"),
        ("taa.reproject", "taa.kernel"), ("taa.history", "taa.kernel"),
        ("taa.resolve", "taa.kernel"), ("post", "frame"),
        ("post.tonemap", "post"), ("post.srgb", "post"),
        ("frame.end", "frame")]


@pytest.fixture
def scopes_on():
    """The switch on for the test, off after it."""
    profiler.disable()
    profiler.enable()
    try:
        yield
    finally:
        profiler.disable()
        profiler.collect()


def _renderer(mesh=None, cfg=CFG):
    world, moving = build_world(60, seed=1)
    return Renderer(world.device("cpu"), cfg, moving_ids=moving, mesh=mesh)


def _tree(records):
    return [(d["name"], None if d["parent"] is None
             else records[d["parent"]]["name"]) for d in records]


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call with the scopes off")

    profiler.disable()
    profiler.collect()
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", no_cuda)
    assert profiler.scope("a") is profiler.scope("b")
    r = _renderer()
    for _ in range(2):
        r.render(pt.Camera(**CAMERA))
    profiler.count("pairs", torch.ones(4))
    assert profiler.collect() == []


class _Ops(TorchDispatchMode):
    """The ATen operators a block of code dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_on_dispatches_the_operators_of_off():
    """The switch on adds no operator to a frame: its counters keep their
    tensors and collect() reduces them after the frames."""
    ops = []
    for on in (False, True):
        if on:
            profiler.enable()
        try:
            r = _renderer()
            r.render(pt.Camera(**CAMERA))
            with _Ops() as mode:
                r.render(pt.Camera(**CAMERA))
        finally:
            profiler.disable()
        ops.append(mode.ops)
    recs = profiler.collect()
    assert len(recs) > 2 * len(TREE) - 5  # frame 0 has no taa.kernel tree
    assert ops[0] == ops[1]
    assert len(ops[0]) > 100


def test_frame_tree_names_parents_and_frames(scopes_on):
    r = _renderer()
    for _ in range(3):
        r.render(pt.Camera(**CAMERA))
    recs = profiler.collect()
    frames = [d["frame"] for d in recs if d["parent"] is None]
    assert frames == [0, 1, 2]
    assert all(d["frame"] == recs[d["parent"]]["frame"]
               for d in recs if d["parent"] is not None)
    per_frame = {}
    for d, t in zip(recs, _tree(recs)):
        per_frame.setdefault(d["frame"], []).append(t)
    # the first frame seeds the history: its TAA reads none and launches
    # nothing
    assert per_frame[0] == [t for t in TREE if t[0] not in (
        "taa.kernel", "taa.reproject", "taa.history", "taa.resolve")]
    assert per_frame[1] == per_frame[2] == TREE
    cuda = torch.cuda.is_available()
    assert all((d["device_ms"] is None) != cuda for d in recs)
    assert all((d["device_allocs"] is None) != (cuda and d["parent"] is None)
               for d in recs)


def test_self_time_is_duration_less_children(scopes_on):
    with profiler.scope("outer", frame=7):
        time.sleep(0.01)
        with profiler.scope("inner"):
            time.sleep(0.02)
        with profiler.scope("inner"):
            pass
    r = _renderer()
    r.render(pt.Camera(**CAMERA))
    recs = profiler.collect()
    outer, inner = recs[0], recs[1]
    assert inner["frame"] == 7 and inner["parent"] == 0
    assert inner["host_ms"] >= 20.0
    assert outer["self_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"] - recs[2]["host_ms"])
    assert 10.0 <= outer["self_ms"] < outer["host_ms"] - 20.0
    for i, d in enumerate(recs):
        kids = sum(c["host_ms"] for c in recs if c["parent"] == i)
        assert d["self_ms"] == pytest.approx(d["host_ms"] - kids)
        assert d["host_ms"] == pytest.approx((d["t1"] - d["t0"]) / 1e6)
    rows, _, n = profiler.scope_rows(recs)
    assert n == 2  # frame 7 and the Renderer's frame 0
    assert rows[0][:2] == (0, "outer") and rows[1][:2] == (1, "inner")


def test_counters_only_when_on():
    profiler.disable()
    profiler.collect()
    r = _renderer()
    r.render(pt.Camera(**CAMERA))
    assert profiler.collect() == []
    profiler.enable()
    try:
        r.render(pt.Camera(**CAMERA))
        r.render(pt.Camera(**CAMERA))
    finally:
        profiler.disable()
    recs = profiler.collect()
    assert sorted({k for d in recs for k in d["counters"]}) == sorted([
        "draws", "overflow.setup", "pairs", "tile_max", "overflow.bin",
        "overflow.taa", "covered_px", "resolve.kernel_px", "taa.kernel_px"])
    assert all(type(v) is int for d in recs for v in d["counters"].values())
    last = {}
    for d in recs:
        if d["frame"] == 2:
            last.update(d["counters"])
    assert last["draws"] == int(r.aux["draw_count"])
    assert last["covered_px"] == int(r.aux["vis_coverage"])
    assert last["overflow.setup"] == last["overflow.bin"] == 0
    assert last["overflow.taa"] == 0
    assert 0 < last["tile_max"] <= last["pairs"]
    assert {d["name"] for d in recs if "overflow.setup" in d["counters"]} == {
        "raster.setup"}
    assert {d["name"] for d in recs if "pairs" in d["counters"]} == {
        "raster.bin"}
    # the default frame resolves every pixel through resolve_dense
    assert last["resolve.kernel_px"] == CFG.width * CFG.height
    assert {d["name"] for d in recs
            if "resolve.kernel_px" in d["counters"]} == {"resolve"}


def test_counter_tensors_reduced_after_the_frames(scopes_on):
    counts = torch.tensor([3, 9, 0, 2], dtype=torch.int32)
    with profiler.scope("raster.bin", frame=0):
        profiler.count("pairs", counts)
        profiler.count("tile_max", counts)
        profiler.count("pairs", torch.tensor(5))
        profiler.count("draws", torch.zeros(0, dtype=torch.int32))
        counts[1] = 4  # read when collected, after the frame
    with profiler.scope("raster.bin", frame=1):
        profiler.count("tile_max", torch.tensor([1, 7]))
    recs = profiler.collect()
    assert recs[0]["counters"] == dict(pairs=9 + 5, tile_max=4, draws=0)
    _, counters, frames = profiler.scope_rows(recs)
    assert frames == 2 and counters["tile_max"] == 7


def _warned(message):
    """Whether warnings.warn(message) reaches the showwarning that the
    test installed (the list `seen`)."""
    warnings.warn(message, UserWarning)
    return message in [str(m) for m in _SEEN]


_SEEN = []


def test_enable_disable_unnested_with_catch_warnings():
    """enable() and disable() leave the warnings module as they found it
    where a catch_warnings context opens between them and closes after,
    or the reverse: the sync filter goes, and other warnings reach the
    showwarning they reached before."""
    profiler.disable()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        _SEEN.clear()
        mine = (lambda message, *a, **k: _SEEN.append(message))
        warnings.showwarning = mine
        filters = list(warnings.filters)
        # enable, then a context that closes after disable
        profiler.enable()
        assert warnings.showwarning is not mine
        with warnings.catch_warnings():
            profiler.disable()
            assert warnings.showwarning is mine
        # the context restored enable()'s hook: it passes warnings on
        assert _warned("one")
        profiler.enable()
        profiler.disable()
        assert warnings.showwarning is mine
        assert warnings.filters == filters
        # a context that opens before enable and closes before disable
        with warnings.catch_warnings():
            profiler.enable()
        assert warnings.showwarning is mine
        assert _warned("two")
        profiler.disable()
        assert warnings.showwarning is mine
        assert warnings.filters == filters
        assert _warned("three")
    profiler.collect()


def test_frames_bit_identical_with_scopes_on_and_off():
    outs = []
    for on in (False, True):
        if on:
            profiler.enable()
        try:
            r = _renderer()
            imgs = [r.render(pt.Camera(**CAMERA)).clone() for _ in range(3)]
        finally:
            profiler.disable()
        outs.append((imgs, r.state.history.clone()))
    assert len(profiler.collect()) > 3 * len(TREE) - 5
    (a, ha), (b, hb) = outs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ha, hb)


def test_sharded_frame_and_profile_frame_record_pass_scopes(scopes_on):
    cfg = RasterConfig(width=64, height=32, tri_capacity=1 << 12,
                       pair_capacity=1 << 13)
    r = _renderer(mesh=sh.make_mesh(devices=["cpu"] * 2), cfg=cfg)
    r.render(pt.Camera(**CAMERA))
    r.render(pt.Camera(**CAMERA))
    recs = profiler.collect()
    tree = _tree(recs)
    second = [t for d, t in zip(recs, tree) if d["frame"] == 1]
    for t in (("raster", "frame"), ("raster.setup", "raster"),
              ("raster.bin", "raster"), ("raster.k1", "raster"),
              ("taa.reproject", "taa"), ("taa.history", "taa"),
              ("post.srgb", "post"), ("frame.end", "frame")):
        assert t in second, t
    # one resolve, shade, bin and K1 a slab; update on the one device
    assert second.count(("resolve", "frame")) == 2
    assert second.count(("shade", "frame")) == 2
    assert second.count(("raster.bin", "raster")) == 2
    assert [n for n, _ in tree].count("frame") == 2
    world, moving = build_world(60, seed=1)
    scene = world.device("cpu")
    profiler.profile_frame(scene, pt.Camera(**CAMERA).uniform(), CFG)
    got = {d["name"] for d in profiler.collect()}
    assert {"cull", "raster", "resolve", "shade", "taa",
            "post.tonemap"} <= got
    assert "frame" not in got


class _Field(Example):
    def setup_scene(self, app):
        app.world, moving = build_world(60, seed=1)
        app.moving_ids = list(moving)


def test_gpu_profiling_prints_the_table_every_dump_every(monkeypatch,
                                                         capsys):
    monkeypatch.setenv(profiler.PROFILING_ENV, "1")
    monkeypatch.setattr(profiler, "DUMP_EVERY", 2)
    profiler.disable()
    try:
        app = App(_Field(), camera=pt.Camera(**CAMERA), config=CFG,
                  device="cpu")
        assert app.profiling and profiler.ON
        app.step()
        assert "scope (a frame" not in capsys.readouterr().out
        app.step()
        out = capsys.readouterr().out
        app.step()
        assert capsys.readouterr().out == ""
        app.step()
        out2 = capsys.readouterr().out
    finally:
        profiler.disable()
        profiler.collect()
    for text in (out, out2):
        assert text.count("scope (a frame, 2 frames)") == 1
        lines = text.splitlines()
        assert lines[1].split()[0] == "frame"
        assert any(line.startswith("    raster.k1") for line in lines)
        assert "counters a frame: draws" in text
    monkeypatch.delenv(profiler.PROFILING_ENV)
    assert not App(_Field(), camera=pt.Camera(**CAMERA), config=CFG,
                   device="cpu").profiling


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the scopes' events and the sync "
                    "counter run only on the card)")
    profiler.disable()
    profiler.enable()
    try:
        yield torch.device("cuda:0")
    finally:
        profiler.disable()
        profiler.collect()


def _device_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
def test_scope_clock_lines_up_with_the_device_trace(cuda):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with profiler.scope("sleep"):
            torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    rec = next(d for d in profiler.collect() if d["name"] == "sleep")
    kernels = _device_events(prof)
    assert len(kernels) == 1, [e.name() for e in kernels]
    start = kernels[0].start_ns()
    assert rec["t0"] <= start
    assert abs(start - rec["t1"]) < 1_000_000
    assert rec["device_ms"] > 1.0  # the event pair spans the sleep


@pytest.mark.cuda
def test_item_counts_one_sync_and_a_kernel_none(cuda):
    x = torch.ones(1 << 20, device=cuda)
    x.sum().item()
    with profiler.scope("item"):
        x.sum().item()
    with profiler.scope("kernel"):
        x.mul_(2.0)
    torch.cuda.synchronize()
    recs = {d["name"]: d for d in profiler.collect()}
    assert recs["item"]["syncs"] == 1
    (site, n), = recs["item"]["sync_sites"].items()
    assert site.startswith("test_torch_scopes.py:") and n == 1
    assert recs["kernel"]["syncs"] == 0 and recs["kernel"]["sync_sites"] == {}


@pytest.mark.cuda
def test_camera_upload_counts_a_sync_where_the_host_waits(cuda):
    world, _ = build_world(200, seed=1)
    scene = world.device("cuda")
    cam = pt.Camera(**CAMERA).uniform()
    cull.view_sphere(scene.meshes, scene.instances, cam)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # tens of ms of device work queued
    t = time.perf_counter()
    with profiler.scope("cull.upload"):
        torch.as_tensor(cam.view, device=scene.device)
    waited = time.perf_counter() - t
    torch.cuda.synchronize()
    rec = next(d for d in profiler.collect() if d["name"] == "cull.upload")
    # the upload is a sync exactly where the host waited for the sleep
    assert rec["syncs"] == (1 if waited > 0.01 else 0), waited
    print(f"camera upload: {rec['syncs']} sync, host waited "
          f"{waited * 1e3:.3f} ms")
