"""Optional bounds validation of data-dependent gather indices.

Counterpart of ``voidin_tpu/core/checks.py`` (RasterConfig.debug_bounds).
The frame is full of data-dependent indexing (resolve records, texel rows,
BVH nodes) guarded in production only by capacity and overflow counters.
With ``RasterConfig.debug_bounds`` the Renderer sets a thread-local flag
for the frame it runs, and every ``check_index`` call then holds its
indices to ``[0, n)``, raising an IndexError that names the gather; with
the flag off the helper is a passthrough and the frame pays nothing.

The JAX package functionalizes the checks under checkify and throws after
the frame; the port checks eagerly, one device-to-host read per checked
gather. The hand-written traversal kernels read nothing but table
indices, and on CUDA an out-of-range read is no error the host sees (and
an out-of-range torch gather is a device-side assert that kills the
context), so their wrappers hold the packed tables to the table sizes
before the launch instead (``check_indices``, rt/traverse.py
``check_threaded_table`` and ``check_stack_tables``).

Thread-local, as in the JAX package: a frame on another thread (a
PipelineCache rebuild, a test) does not inherit the mode.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCAL = threading.local()


def bounds_enabled() -> bool:
    return getattr(_LOCAL, "bounds", False)


def set_bounds_enabled(v: bool) -> None:
    _LOCAL.bounds = bool(v)


@contextlib.contextmanager
def bounds(enabled: bool = True):
    """The bounds mode for the duration of the block, restored after."""
    before = bounds_enabled()
    set_bounds_enabled(enabled)
    try:
        yield
    finally:
        set_bounds_enabled(before)


def _out_of_range(idx, n):
    """True where idx is not in [0, n); NaN counts as out of range."""
    idx = torch.as_tensor(idx)
    return ~((idx >= 0) & (idx < n))


def check_index(idx, n, name: str):
    """Raise IndexError unless every value of `idx` is a valid row of an
    `n`-row table; returns `idx` unchanged, so call sites read
    ``table[check_index(i, table.shape[0], "resolve.rec")]``. A
    passthrough unless the bounds mode is on."""
    if bounds_enabled():
        check_indices([(idx, n, name)])
    return idx


def check_indices(items):
    """Raise IndexError naming the first of `items` that holds an index
    outside [0, n), whatever the mode: (idx, n, name) or (idx, n, name,
    where), where a bool tensor `where` selects the entries of idx that
    are indices. One device-to-host read for all of them."""
    items = list(items)
    if not items:
        return
    flags = []
    for it in items:
        bad = _out_of_range(it[0], it[1])
        if len(it) > 3:
            bad = bad & it[3]
        flags.append(bad.any())
    bad = torch.stack([f.to(flags[0].device) for f in flags]).tolist()
    for flag, (_, n, name, *_) in zip(bad, items):
        if flag:
            raise IndexError(f"{name}: gather index out of range [0, {n})")
