"""The end-to-end arithmetic of a window of frames."""

import statistics


def frame_stats(times_s, window_s):
    """(frame_ms, frame_ms_p95) of a window: its wall time over the frames
    completed in it, and the 95th percentile of the frames' wall times
    (Python's exclusive quantiles; the largest frame below 20 frames)."""
    n = len(times_s)
    ms = sorted(t * 1e3 for t in times_s)
    p95 = statistics.quantiles(ms, n=20)[-1] if n >= 20 else ms[-1]
    return window_s * 1e3 / n, p95
