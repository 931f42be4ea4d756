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
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
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
