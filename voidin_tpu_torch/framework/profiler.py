"""Per-pass GPU-time profiler.

Counterpart of ``voidin_tpu/framework/profiler.py``: the reference's
wgpu_profiler scope tree (ProfilerCommandEncoder, app.rs:660-729),
per-pass timings printed as an indented table, gated on the GPU_PROFILING
env var with a 500-frame cadence (app.rs:417-424).

``time_fn`` times one pass by itself. The device of its inputs chooses the
clock: on the card, CUDA events around each call (``torch.cuda.Event``,
after a warm-up call, the median of n calls); on the CPU, the host's
``perf_counter``. So a caller never gets a host time for a card pass. The
JAX package's slope timing exists because ``block_until_ready`` does not
wait on its TPU host; CUDA events need no such detour. Each row measures
the pass's own time, not its overlap inside a frame — the semantic of the
reference's timestamp scopes.

``profile_frame`` gives the JAX package's rows in its order, over the path
the config renders: pair binning and K1 (``backend="pallas"``, the
default), or block binning and K2 (``"xla"``). The JAX profiler times its
block binning and K2 whatever the config; its row "fine raster (pallas)"
is "fine raster (cuda)" here.

``scope`` records the scope tree inside real frames (``Renderer.render``
and every pass open theirs at their entry), with work and host-stall
counters, behind one switch (``enable`` / ``disable``, off by default);
``collect`` reads the records after the frames and ``print_scope_table``
prints them as the reference's table. With GPU_PROFILING set the App turns
the switch on and prints the table every DUMP_EVERY frames.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import os
import statistics
import time
import warnings
from typing import Callable, List, Optional, Tuple

import torch

PROFILING_ENV = "GPU_PROFILING"
DUMP_EVERY = 500  # frames (app.rs:417)


def profiling_enabled() -> bool:
    return bool(os.environ.get(PROFILING_ENV))


def _device_of(obj) -> Optional[torch.device]:
    """The device of the first tensor in `obj` (tensors, sequences, dicts
    and dataclasses searched in order), or None."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        for o in obj:
            d = _device_of(o)
            if d is not None:
                return d
    return None


def time_fn(fn: Callable, *args, n: int = 5) -> float:
    """Milliseconds of one call of fn(*args): the median of `n` calls
    after one warm-up call. Card inputs are timed by CUDA events around
    each call, CPU inputs (or none) by the host clock."""
    dev = _device_of(args)
    cuda = dev is not None and dev.type == "cuda"
    fn(*args)
    times = []
    for _ in range(n):
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_frame(scene, camera, config, state=None, moving_ids=None
                  ) -> List[Tuple[str, float]]:
    """Per-pass timing table for one frame's stages at `camera` (a
    CameraUniform). `state` (a FrameState) is copied, not advanced;
    `moving_ids` is accepted as in the JAX package and unused there too
    (the update pass is not a row)."""
    from ..ops import fine_raster as fr
    from ..passes import cull, postprocess as pp, raster, resolve, shading
    from ..passes import taa as taa_m
    from .renderer import FrameState

    del moving_ids
    cfg = dataclasses.replace(config, alpha_mask=scene.alpha_masked)
    if state is None:
        state = FrameState.initial(cfg.width, cfg.height, scene.device)
    else:
        state = FrameState(state.history.clone(), state.history_valid)
    inst_rec = resolve._inst_rec_f16(scene) if cfg.slim_rec else None
    pairs = cfg.backend == "pallas"
    track2 = cfg.alpha_mask

    def setup(s, draws):
        return raster.triangle_setup(s.meshes, s.instances, draws, camera,
                                     cfg, materials=s.materials,
                                     inst_rec=inst_rec)

    def binning(st):
        return (raster.bin_triangles_pairs(st, cfg) if pairs
                else raster.bin_triangles(st, cfg))

    def fine(binned):
        if pairs:
            return fr.fine_raster_pairs(*binned[:3], track2=track2)
        return fr.fine_raster_blocks(*binned[:2], track2=track2)

    rows: List[Tuple[str, float]] = []
    draws = cull.emit_draws(scene.meshes, scene.instances, camera)
    rows.append(("emit_draws (cull+compact)", time_fn(
        lambda s: cull.emit_draws(s.meshes, s.instances, camera), scene)))
    st = setup(scene, draws)
    rows.append(("triangle setup + clip", time_fn(setup, scene, draws)))
    binned = binning(st)
    rows.append(("binning (pairs+sort)", time_fn(binning, st)))
    rows.append(("fine raster (cuda)", time_fn(fine, binned)))
    vis = raster.rasterize(scene.meshes, scene.instances, draws, camera, cfg,
                           materials=scene.materials, inst_rec=inst_rec)
    rows.append(("gbuffer resolve", time_fn(
        lambda s, v: resolve.resolve_gbuffer(s, v, cfg), scene, vis)))
    gb, aux = resolve.resolve_gbuffer(scene, vis, cfg)
    rows.append(("deferred shade (LTC)", time_fn(
        lambda s, g: shading.shade(s, g, camera, aux), scene, gb)))
    hdr = shading.shade(scene, gb, camera, aux)
    rows.append(("taa (reproject+resolve)", time_fn(
        lambda h, g: taa_m.taa(h, g, camera, state)[0], hdr, gb)))
    rows.append(("postprocess", time_fn(pp.postprocess, hdr)))
    return rows


def print_table(rows: List[Tuple[str, float]]):
    total = sum(t for _, t in rows)
    print(f"{'pass':30s} {'ms':>9s}")
    for name, t in rows:
        print(f"  {name:28s} {t:9.3f}")
    print(f"{'total (sum of passes)':30s} {total:9.3f}")


# ---------------------------------------------------------------------------
# Frame scopes: the scope tree recorded inside real frames
# ---------------------------------------------------------------------------
#
# Renderer.render opens "frame"; each pass opens its scope at its own entry
# and its stages open theirs inside it:
#
#   frame > frame.begin, update (update.skin, update.refit), cull,
#           raster (raster.setup, raster.bin, raster.k1, raster.untile),
#           resolve (resolve.fetch, resolve.fields, resolve.fallback),
#           shade (shade.point, shade.rect, shade.rays, shade.ring),
#           taa (taa.kernel, or the chain's taa.reproject, taa.history,
#           taa.resolve; on the CPU they open inside taa.kernel),
#           post (post.tonemap, post.srgb), frame.end
#
# Off (the default) scope() reads ON and returns one shared null context: no
# CUDA event, no allocation, no launch, no sync. On, each scope records its
# name, its parent, the frame's number (Renderer.frame_count, which every
# scope of the frame shares) and the host's entry and exit on time.time_ns()
# (the clock of torch.profiler's timestamps, so scopes line up with a device
# trace); with enable(device=True) on a CUDA device, also a CUDA event pair on
# the stream current at its root scope's entry (events reused from a pool
# that collect() refills) and, at a root scope (the frame), the caching
# allocator's cudaMalloc calls. The passes add work counters (count()), and
# two host-stall counters go to the innermost open scope: host-device syncs
# (the warnings of torch.cuda.set_sync_debug_mode("warn"), not printed, each
# with the source line of the Python call that synced) and Python's garbage
# collections (gc.callbacks). The on path launches nothing: a counter that
# needs a reduction keeps its tensor, and collect() reduces it and reads the
# events after the frames.

ON = False  # the scopes' switch: enable() / disable()
SYNC_WARNING = "called a synchronizing CUDA operation"
MAX_COUNTERS = ("tile_max",)  # combined over a frame by max, others summed
_NULL = contextlib.nullcontext()
_REC = None  # the _Recorder of the last enable()
_EVENTS = []  # CUDA events collect() has read, for the next scopes
_show = None  # the warnings.showwarning that _on_warning passes others to


class ScopeRecord:
    """One scope's entry: what it records while open."""

    __slots__ = ("name", "parent", "frame", "t0", "t1", "events",
                 "sync_sites", "gc_ms", "collections", "allocs", "counters")

    def __init__(self, name, parent, frame):
        self.name, self.parent, self.frame = name, parent, frame
        self.t0 = self.t1 = None
        self.events = None  # (start, end) torch.cuda.Event
        self.collections = 0
        self.sync_sites = {}  # "file.py:line" of each sync -> count
        self.gc_ms = 0.0
        self.allocs = None  # cudaMalloc calls (a root scope on the card)
        self.counters = {}  # name -> [int or device tensor]


class _Recorder:
    """The records of one enable() and what disable() undoes."""

    def __init__(self, device):
        self.device = device  # event pairs and the allocator's count
        self.stream = None  # the current stream at the root scope's entry
        self.records = []
        self.stack = []
        self.gc_t0 = None
        self.sync_filter = None  # the warnings filter enable() added
        self.sync_mode = None  # the sync debug mode enable() replaced


def _cuda_mallocs():
    return torch.cuda.memory_stats_as_nested_dict()["segment"]["all"][
        "allocated"]


def _event():
    return _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)


class _Scope:
    __slots__ = ("name", "frame", "rec")

    def __init__(self, name, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        t0 = time.time_ns()
        r = _REC
        parent = r.stack[-1] if r.stack else None
        frame = self.frame
        if frame is None and parent is not None:
            frame = parent.frame
        s = self.rec = ScopeRecord(self.name, parent, frame)
        s.t0 = t0
        if r.device:
            if parent is None:
                r.stream = torch.cuda.current_stream()
                s.allocs = _cuda_mallocs()
            start = _event()
            start.record(r.stream)
            s.events = (start, None)
        r.records.append(s)
        r.stack.append(s)
        return s

    def __exit__(self, *exc):
        r, s = _REC, self.rec
        if s.events is not None:
            end = _event()
            end.record(r.stream)
            s.events = (s.events[0], end)
            if s.allocs is not None:
                s.allocs = _cuda_mallocs() - s.allocs
        if r.stack and r.stack[-1] is s:
            r.stack.pop()
        s.t1 = time.time_ns()
        return False


def scope(name: str, frame: Optional[int] = None):
    """Context manager: the code inside runs in scope `name` (a child of
    the innermost open scope; `frame` numbers a root scope, and a child
    takes its parent's). Off: the shared null context."""
    if not ON:
        return _NULL
    return _Scope(name, frame)


def scoped(name: str):
    """Decorator: every call of the function runs in scope `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with _Scope(name, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value):
    """Adds `value` to counter `name` of the innermost open scope: an int,
    a device scalar, or a device tensor that collect() reduces after the
    frames (its sum; its max for MAX_COUNTERS). The tensor is kept, not
    reduced here, so that the frame launches nothing more with the switch
    on; keep it small (the per-tile counts, 65 KB a 1080p frame): each
    kept byte makes the caching allocator grow inside the frames, and a
    live-triangle count (the 0.6 MB alive mask) cost the traced frame's
    raster ~1.4 ms that way, so it is not counted. Off: nothing."""
    r = _REC
    if ON and r.stack:
        r.stack[-1].counters.setdefault(name, []).append(value)


def _on_gc(phase, info):
    r = _REC
    if phase == "start":
        r.gc_t0 = time.perf_counter_ns()
    elif r.gc_t0 is not None:
        ms = (time.perf_counter_ns() - r.gc_t0) / 1e6
        r.gc_t0 = None
        if r.stack:
            r.stack[-1].gc_ms += ms
            r.stack[-1].collections += 1


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if ON and str(message).startswith(SYNC_WARNING):
        r = _REC
        if r.stack:
            sites = r.stack[-1].sync_sites
            site = f"{os.path.basename(filename)}:{lineno}"
            sites[site] = sites.get(site, 0) + 1
        return
    _show(message, category, filename, lineno, file, line)


def enable(device: bool = True):
    """Turns the scopes on, with a new, empty record. `device` (where a
    CUDA device exists): each scope records a CUDA event pair, and each
    root scope the allocator's cudaMalloc calls; without it the scopes
    record the host's side alone (times, syncs, collections, counters),
    for a caller that traces the device itself."""
    global ON, _REC, _show
    if ON:
        return
    cuda = torch.cuda.is_available()
    rec = _Recorder(device and cuda)
    if cuda:
        rec.sync_mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "a prototype feature"
            torch.cuda.set_sync_debug_mode("warn")
    warnings.filterwarnings("always", message=SYNC_WARNING)
    rec.sync_filter = warnings.filters[0]
    if warnings.showwarning is not _on_warning:
        _show = warnings.showwarning
    warnings.showwarning = _on_warning
    gc.callbacks.append(_on_gc)
    _REC = rec
    ON = True


def disable():
    """Turns the scopes off; the records stay for collect(). Takes out
    the filter and the warning hook that enable() put in, whatever
    warnings.catch_warnings contexts opened or closed since."""
    global ON
    if not ON:
        return
    ON = False
    r = _REC
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    if r.sync_mode is not None:
        torch.cuda.set_sync_debug_mode(r.sync_mode)
    # also a copy that a catch_warnings context closed since put back
    warnings.filters[:] = [f for f in warnings.filters
                           if f != r.sync_filter]
    if warnings.showwarning is _on_warning:
        warnings.showwarning = _show


def _value(name, v):
    """A counter's value as count() got it, reduced where it is a tensor
    of more than one element."""
    if isinstance(v, torch.Tensor) and v.numel() != 1:
        if v.numel() == 0:
            return 0
        v = v.max() if name in MAX_COUNTERS else v.sum()
    return int(v)


def _combine(name, values):
    vals = [_value(name, v) for v in values]
    return max(vals) if name in MAX_COUNTERS else sum(vals)


def collect() -> List[dict]:
    """The scopes closed since enable() (or since the last collect), in
    entry order, as dicts: name, parent (index in the list, or None), frame,
    t0 / t1 (time.time_ns at entry and exit), host_ms, device_ms (None
    without events), self_ms (host_ms less the children's), syncs,
    sync_sites ({"file.py:line": syncs}), gc_ms, collections,
    device_allocs (None off the root scopes or without events) and counters
    ({name: int}). Waits for the device once, to read the events and reduce
    the counters: call it after the frames it reads, never inside one."""
    r = _REC
    if r is None:
        return []
    done = [s for s in r.records if s.t1 is not None]
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    index = {id(s): i for i, s in enumerate(done)}
    out = []
    for s in done:
        host = (s.t1 - s.t0) / 1e6
        out.append(dict(
            name=s.name,
            parent=None if s.parent is None else index.get(id(s.parent)),
            frame=s.frame, t0=s.t0, t1=s.t1, host_ms=host,
            device_ms=(None if s.events is None
                       else s.events[0].elapsed_time(s.events[1])),
            self_ms=host, syncs=sum(s.sync_sites.values()),
            sync_sites=dict(s.sync_sites),
            gc_ms=s.gc_ms,
            collections=s.collections, device_allocs=s.allocs,
            counters={k: _combine(k, v) for k, v in s.counters.items()}))
        if s.events is not None:
            _EVENTS.extend(s.events)
    for d in out:
        if d["parent"] is not None:
            out[d["parent"]]["self_ms"] -= d["host_ms"]
    r.records = [s for s in r.records if s.t1 is None]
    return out


def scope_rows(records: List[dict]):
    """The records (collect()) a frame: ([(depth, name, host_ms, device_ms,
    self_ms, syncs, gc_ms, device_allocs)], one row per scope path in tree
    order, each the mean a frame (device_ms and device_allocs None where
    not recorded), {counter: a frame's mean, tile_max its largest}, the
    number of frames)."""
    frames = len({d["frame"] for d in records}) or 1
    paths, sums = [], {}
    for d in records:
        p = (d["name"],)
        if d["parent"] is not None:
            p = paths[d["parent"]] + p
        paths.append(p)
        acc = sums.setdefault(p, [0.0, None, 0.0, 0, 0.0, None])
        acc[0] += d["host_ms"]
        acc[2] += d["self_ms"]
        acc[3] += d["syncs"]
        acc[4] += d["gc_ms"]
        for i, key in ((1, "device_ms"), (5, "device_allocs")):
            if d[key] is not None:
                acc[i] = (acc[i] or 0) + d[key]
    children = collections.defaultdict(list)
    for p in sums:
        children[p[:-1]].append(p)
    rows = []

    def walk(prefix):
        for p in children[prefix]:
            acc = sums[p]
            rows.append((len(p) - 1, p[-1], acc[0] / frames,
                         None if acc[1] is None else acc[1] / frames,
                         acc[2] / frames, acc[3] / frames, acc[4] / frames,
                         None if acc[5] is None else acc[5] / frames))
            walk(p)

    walk(())
    counters = {}
    for d in records:
        for k, v in d["counters"].items():
            counters[k] = (max(counters.get(k, v), v) if k in MAX_COUNTERS
                           else counters.get(k, 0) + v)
    counters = {k: v if k in MAX_COUNTERS else v / frames
                for k, v in counters.items()}
    return rows, counters, frames


def print_scope_table(records: List[dict]):
    """The scope table (the reference's wgpu_profiler dump): host ms,
    device ms, self ms, syncs, garbage-collection ms and cudaMalloc calls
    (on the frame's row) of each scope, a frame, indented by parent; then
    the counters, the
    garbage collections and the syncs by the source line that made them."""
    rows, counters, frames = scope_rows(records)

    def num(v, width, prec):
        return "-".rjust(width) if v is None else f"{v:{width}.{prec}f}"

    print(f"{'scope (a frame, ' + str(frames) + ' frames)':34s} "
          f"{'host ms':>9s} {'device ms':>9s} {'self ms':>9s} "
          f"{'syncs':>7s} {'gc ms':>7s} {'allocs':>7s}")
    for depth, name, host, dev, self_ms, syncs, gc_ms, allocs in rows:
        print(f"{'  ' * depth + name:34s} {host:9.3f} {num(dev, 9, 3)} "
              f"{self_ms:9.3f} {syncs:7.2f} {gc_ms:7.3f} "
              f"{num(allocs, 7, 2)}")
    if counters:
        print("counters a frame: " + ", ".join(
            f"{k} {v:.1f}" + (" (largest)" if k in MAX_COUNTERS else "")
            for k, v in counters.items()))
    sites = collections.Counter()
    for d in records:
        sites.update(d["sync_sites"])
    n_gc = sum(d["collections"] for d in records)
    if n_gc:
        print(f"garbage collections a frame: {n_gc / frames:.2f}")
    if sites:
        print("syncs a frame by line: " + ", ".join(
            f"{k} {v / frames:.2f}" for k, v in sites.most_common()))
