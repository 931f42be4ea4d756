"""The metric arithmetic on synthetic spans and traces: the window rate,
the 95th percentile, the device's busy union and idle gaps, kernels a
frame, and span totals a frame."""

import statistics

import pytest

from pb import spans as sp
from pb import stats
from pb.trace import FRAME, PREFIX, WINDOW, Trace

MS = 1_000_000  # ns


def test_frame_rate_is_window_over_frames():
    times = [0.040] * 99 + [0.140]
    ms, p95 = stats.frame_stats(times, 4.5)
    assert ms == pytest.approx(45.0)
    assert p95 == pytest.approx(statistics.quantiles(
        [t * 1e3 for t in times], n=20)[-1])
    assert p95 == pytest.approx(40.0)  # one slow frame in 100 is no 5%


def test_p95_sees_the_slow_twentieth():
    times = [0.030] * 90 + [0.090] * 10
    _, p95 = stats.frame_stats(times, 3.6)
    assert p95 == pytest.approx(90.0)


def _trace():
    dev = [  # (start, end, name, kernel) inside a 100 ms window at 0
        (5 * MS, 15 * MS, "k_a", True),
        (10 * MS, 20 * MS, "k_b", True),  # overlaps k_a: busy 5-20
        (40 * MS, 50 * MS, "Memcpy HtoD", False),
        (90 * MS, 120 * MS, "k_a", True),  # clipped at the window's end
        (-20 * MS, -10 * MS, "k_c", True),  # before the window
    ]
    host = [(0, 100 * MS, WINDOW), (0, 50 * MS, FRAME),
            (50 * MS, 100 * MS, FRAME),
            (20 * MS, 40 * MS, PREFIX + "resolve.resolve_gbuffer")]
    return Trace(dev, host)


def test_busy_union_and_idle_share():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.015 + 0.010 + 0.010)
    assert tr.kernel_count() == 3
    assert tr.kernel_count("k_a") == 2
    assert tr.kernel_ms("k_a") == pytest.approx(10 + 10)


def test_idle_gaps_named_by_the_host_span():
    tr = _trace()
    gaps = dict((round(s * 1e3), n) for n, s in tr.idle_gaps())
    # 50-90 ms: the host was in the second frame, outside every pass
    assert gaps[40] == "frame_driver"
    # 20-40 ms: inside resolve
    assert gaps[20] == "resolve.resolve_gbuffer"
    assert gaps[5] == "frame_driver"
    top = tr.top_ops()
    assert top[0][0] == "k_a" and top[0][1] == pytest.approx(0.020)


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_span_totals_a_frame():
    s = sp.Spans()
    s.events[("m", "f")] = [(_Ev(0.0), _Ev(2.5)), (_Ev(10.0), _Ev(13.5))]
    s.events[("m", "g")] = [(_Ev(0.0), _Ev(1.0))]
    assert s.total_ms(("m", "f")) == pytest.approx(6.0)
    assert s.total_ms(("m", "missing")) is None
    import run

    assert run.span_ms_per_frame(s, [("m", "f"), ("m", "g"),
                                     ("m", "missing")], 2) == \
        pytest.approx(3.5)
    assert run.span_ms_per_frame(s, [("m", "missing")], 2) is None


def test_check_frames_are_drawn_from_the_seed():
    from pb import check

    a = check.sample_frames(2 ** 31 + 3, 7, 500, 2)
    assert a == check.sample_frames(2 ** 31 + 3, 7, 500, 2)
    assert len(set(a)) == 3 and a[0] == 7 and max(a) < 7 + 400
    assert any(check.sample_frames(s, 7, 500, 2) != a for s in range(5))
    assert len(set(check.sample_frames(1, 7, 1, 2))) == 3
