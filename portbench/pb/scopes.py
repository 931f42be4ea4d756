"""The program's own frame scopes (voidin_tpu_torch/framework/profiler.py
scope / count), read in the traced window.

Importing this module turns the program's scope switch on, and only the
traced run imports it (run.py imports the cell's metric readers with
--trace 1 alone), so a --trace 0 run records nothing. It turns on the
host's side alone (enable(device=False): no CUDA event, no allocator read;
the device's side is the profiler's trace), and the program launches
nothing more with it on, so the trace's kernels and the passes' spans read
as with the switch off. The program records every frame from then on;
the readers keep the scopes closed inside the window of ctx.trace
(t0..t1, the last traced attempt), on the clock of the profiler's device
timestamps (time.time_ns).

Every idle interval of the device in the window (the complement of
ctx.trace.busy_intervals()) is put down to the layer of the innermost
program scope the host was in: the pass under "frame" (update and cull
count as one layer), "driver" where the host was in "frame" but in no pass
(frame.begin and frame.end included), "outside" where it was in no frame
(the caller's time between frames). These partition the window's idle
time.

Against a program without scopes (profiler.collect missing) the readers
return None and raise nothing.
"""

import importlib
import sys

# the pass scopes under "frame", by the layer of BENCHMARK.json they time
LAYERS = {"update": "cull", "cull": "cull", "raster": "raster",
          "resolve": "resolve", "shade": "shade", "taa": "taa",
          "post": "post"}
DRIVER, OUTSIDE = "driver", "outside"


def _profiler():
    try:
        prof = importlib.import_module("voidin_tpu_torch.framework.profiler")
    except ImportError:
        return None
    if not all(hasattr(prof, a) for a in ("enable", "collect")):
        return None
    return prof


PROFILER = _profiler()
if PROFILER is not None:
    PROFILER.enable(device=False)

_READ = {}  # id(ctx.trace) -> Window


def layer_labels(records):
    """The layer of each record (profiler.collect()'s dicts): its pass's
    layer under a root "frame", DRIVER for the frame itself and its
    scopes that are no pass, OUTSIDE where its root is no frame."""
    labels = []
    for d in records:
        p = d["parent"]
        if p is None:
            labels.append(DRIVER if d["name"] == "frame" else OUTSIDE)
        elif records[p]["parent"] is None:
            root = labels[p]
            labels.append(LAYERS.get(d["name"], DRIVER)
                          if root == DRIVER else OUTSIDE)
        else:
            labels.append(labels[p])
    return labels


def innermost_segments(spans):
    """[(start, end, label)] over the time the host was in some span, each
    piece labelled by the innermost span open then. `spans`: (start, end,
    label) properly nested, as one thread's scopes are."""
    segs, stack, t = [], [], None

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, lab = stack.pop()
            if end > t:
                segs.append((t, end, lab))
                t = end

    for a, b, lab in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack and a > t:
            segs.append((t, a, stack[-1][1]))
        t = a if t is None else max(t, a)
        stack.append((b, lab))
    close_until(float("inf"))
    return segs


def idle_by_layer(t0, t1, busy, spans):
    """{label: ns} of the device's idle time in [t0, t1] (the complement
    of `busy`, sorted disjoint [a, b] intervals), each instant put down to
    the innermost span the host was in (OUTSIDE where none). The values
    add up to the window's idle time."""
    idle, prev = [], t0
    for a, b in busy:
        if a > prev:
            idle.append((prev, min(a, t1)))
        prev = max(prev, b)
    if t1 > prev:
        idle.append((prev, t1))
    segs = innermost_segments(spans)
    out = {OUTSIDE: 0}
    j = 0
    for a, b in idle:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0) + hi - lo
                covered += hi - lo
            k += 1
        out[OUTSIDE] += (b - a) - covered
    return out


class Window:
    """The program's records inside the traced window, a frame."""

    def __init__(self, records, t0, t1, busy, frames):
        inside = [i for i, d in enumerate(records)
                  if d["t0"] >= t0 and d["t1"] <= t1]
        keep = {i: n for n, i in enumerate(inside)}
        recs = []
        for i in inside:
            d = dict(records[i])
            d["parent"] = keep.get(d["parent"])
            recs.append(d)
        self.records = recs
        self.frames = frames
        labels = layer_labels(recs)
        self.in_frame = [lab != OUTSIDE for lab in labels]
        self.idle_ns = idle_by_layer(
            t0, t1, busy, [(d["t0"], d["t1"], lab)
                           for d, lab in zip(recs, labels)])
        self.n_frames = sum(1 for d in recs
                            if d["parent"] is None and d["name"] == "frame")

    def idle_ms(self, layer):
        """Device idle ms a frame with the host in `layer`."""
        return self.idle_ns.get(layer, 0) / 1e6 / self.frames

    def frame_host_ms(self):
        return sum(d["host_ms"] for d in self.records
                   if d["parent"] is None and d["name"] == "frame"
                   ) / self.frames

    def syncs(self):
        """Host-device syncs a frame inside "frame"."""
        return sum(d["syncs"] for d, f in zip(self.records, self.in_frame)
                   if f) / self.frames

    def counter(self, name):
        """Counter `name` a frame, summed over the frames' scopes."""
        return sum(d["counters"].get(name, 0)
                   for d, f in zip(self.records, self.in_frame)
                   if f) / self.frames


def window(ctx):
    """The Window of ctx's traced run, or None where the program records
    no scopes (or no frame fell inside the window)."""
    key = id(ctx.trace)
    if key not in _READ:
        _READ.clear()
        _READ[key] = _read(ctx)
    return _READ[key]


def _read(ctx):
    if PROFILER is None:
        return None
    tr = ctx.trace
    w = Window(PROFILER.collect(), tr.t0, tr.t1, tr.busy_intervals(),
               ctx.frames)
    if w.n_frames == 0:
        return None
    parts = {lab: w.idle_ms(lab) for lab in
             (DRIVER, *sorted(set(LAYERS.values())), OUTSIDE)}
    total = (tr.window_s - tr.busy_s) * 1e3 / ctx.frames
    print("scopes: device idle ms a frame by the host's layer: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f}, the window's idle "
        f"{total:.4f} (device_idle_pct x window / frames); "
        f"{w.n_frames} frames in the window of {ctx.frames}",
        file=sys.stderr, flush=True)
    return w
