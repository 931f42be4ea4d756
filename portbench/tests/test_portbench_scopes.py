"""The scope readers (pb/scopes.py) on synthetic intervals: the idle split
partitions the window's idle time, scopes outside the window are dropped,
nested scopes go to the innermost one, and every reader answers None
against a program that records no scopes."""

import importlib

import pytest

from pb import scopes

MS = 1_000_000  # ns


def _rec(name, parent, t0, t1, syncs=0, counters=None, host_ms=None):
    return dict(name=name, parent=parent, frame=0, t0=t0 * MS, t1=t1 * MS,
                host_ms=(t1 - t0) if host_ms is None else host_ms,
                syncs=syncs, counters=counters or {})


def _frame(t, base):
    """One 10 ms frame from t: frame.begin, cull, raster > raster.bin,
    post, frame.end (records indexed from `base`)."""
    return [
        _rec("frame", None, t, t + 10, syncs=1),
        _rec("frame.begin", base, t, t + 1),
        _rec("cull", base, t + 1, t + 3, syncs=2, counters={"draws": 40}),
        _rec("raster", base, t + 3, t + 7),
        _rec("raster.bin", base + 3, t + 4, t + 6,
             counters={"pairs": 900}),
        _rec("post", base, t + 7, t + 9),
        _rec("frame.end", base, t + 9, t + 10),
    ]


def _records():
    recs = _frame(0, 0)  # before the window: dropped
    recs += _frame(20, len(recs)) + _frame(35, 14)
    recs.append(_rec("cull", None, 47, 48))  # a pass outside any frame
    return recs


def test_layers_of_the_tree():
    recs = _records()
    labels = scopes.layer_labels(recs)
    assert labels[:7] == ["driver", "driver", "cull", "raster", "raster",
                          "post", "driver"]
    assert labels[-1] == "outside"


def test_innermost_segments_of_nested_scopes():
    segs = scopes.innermost_segments([(0, 10, "a"), (2, 8, "b"),
                                      (3, 5, "c"), (12, 14, "d")])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 5, "c"), (5, 8, "b"),
                    (8, 10, "a"), (12, 14, "d")]


def test_idle_split_partitions_the_idle_time():
    # window 0..100; busy 10-30 and 60-70: idle 0-10, 30-60, 70-100
    spans = [(5, 40, "x"), (20, 35, "y"), (65, 80, "z")]
    out = scopes.idle_by_layer(0, 100, [[10, 30], [60, 70]], spans)
    assert out == {"x": 5 + 5, "y": 5, "z": 10, "outside": 5 + 20 + 20}
    assert sum(out.values()) == 70


def test_window_drops_outside_scopes_and_reads_a_frame():
    recs = _records()
    # window 18..52 ms: frames at 20 and 35 and the loose cull at 47
    busy = [[21 * MS, 22 * MS], [26 * MS, 28 * MS], [38 * MS, 47 * MS]]
    w = scopes.Window(recs, 18 * MS, 52 * MS, busy, frames=2)
    assert w.n_frames == 2
    assert [d["name"] for d in w.records][:2] == ["frame", "frame.begin"]
    assert w.records[7]["parent"] is None and w.records[8]["parent"] == 7
    assert w.frame_host_ms() == pytest.approx(10.0)
    assert w.syncs() == pytest.approx(3.0)
    assert w.counter("draws") == pytest.approx(40.0)
    assert w.counter("pairs") == pytest.approx(900.0)
    # idle, frame at 20: 20-21 begin, 22-23 cull, 23-24 raster,
    # 24-26 raster.bin, 28-29 post, 29-30 frame.end (26-28 busy);
    # frame at 35: 35-36 begin, 36-38 cull; busy to 47; 47-48 the loose
    # cull and 48-52 outside; 18-20 and 30-35 outside
    ms = {k: v / MS for k, v in w.idle_ns.items()}
    assert ms == {"driver": 1 + 1 + 1, "cull": 1 + 2, "raster": 3,
                  "post": 1, "outside": 2 + 5 + 1 + 4}
    total_idle = 34 - (1 + 2 + 9)
    assert sum(ms.values()) == pytest.approx(total_idle)
    assert w.idle_ms("raster") == pytest.approx(1.5)
    assert w.idle_ms("taa") == 0


class _Trace:
    t0, t1 = 0, 10 * MS
    window_s, busy_s = 0.01, 0.004

    def busy_intervals(self):
        return [[2 * MS, 6 * MS]]


class _Ctx:
    frames = 1
    trace = _Trace()


NEW = ["frame_host_ms", "host_syncs_per_frame", "driver_idle_ms",
       "cull_idle_ms", "raster_idle_ms", "resolve_idle_ms", "shade_idle_ms",
       "taa_idle_ms", "post_idle_ms", "draws_per_frame", "pairs_per_frame"]


@pytest.mark.parametrize("metric", NEW)
def test_reader_is_silent_without_program_scopes(metric, monkeypatch):
    monkeypatch.setattr(scopes, "PROFILER", None)
    monkeypatch.setattr(scopes, "_READ", {})
    mod = importlib.import_module(f"metrics.{metric}")
    assert mod.WRAPS == []
    assert mod.read(_Ctx) is None


class _Prof:
    def __init__(self, records):
        self.records = records

    def collect(self):
        return self.records


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_the_window(metric, monkeypatch):
    recs = [_rec("frame", None, 1, 9, syncs=2),
            _rec("cull", 0, 1, 3, counters={"draws": 7}),
            _rec("raster", 0, 3, 8, counters={"pairs": 30})]
    monkeypatch.setattr(scopes, "PROFILER", _Prof(recs))
    monkeypatch.setattr(scopes, "_READ", {})
    got = importlib.import_module(f"metrics.{metric}").read(_Ctx)
    # idle: 0-1 outside, 1-2 cull, 6-8 raster, 8-9 driver, 9-10 outside
    want = {"frame_host_ms": 8.0, "host_syncs_per_frame": 2.0,
            "driver_idle_ms": 1.0, "cull_idle_ms": 1.0,
            "raster_idle_ms": 2.0, "resolve_idle_ms": 0.0,
            "shade_idle_ms": 0.0, "taa_idle_ms": 0.0, "post_idle_ms": 0.0,
            "draws_per_frame": 7.0, "pairs_per_frame": 30.0}[metric]
    assert got == pytest.approx(want)
