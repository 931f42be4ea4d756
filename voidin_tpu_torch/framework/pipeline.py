"""Pipeline cache + hot reload.

Counterpart of ``voidin_tpu/framework/pipeline.py``: the reference's
PipelineArena + Watcher (app/pipeline.rs:32-360, components/src/watcher.rs).
Pass functions are Python modules instead of WGSL files, so "shader hot
reload" is a module re-import. The cache maps names to callables, tracks
which source files produced each entry, and a polling watcher swaps in a
freshly built version when a file changes — keeping the previous good
version if the reload raises (pipeline.rs:304-311 semantics).

The port runs eagerly, so ``build()`` returns the callable itself and a
reload is the re-import plus a new ``build()``; the JAX package's
``jit_kwargs`` (donation and other jit options) mean nothing here and are
gone. Only Python modules reload: an edited CUDA source (``csrc/*.cu``) is
rebuilt at the next process start, not hot-reloaded, and no ``ops/``
module may be listed as a source (a reload would reset its launch
counters and drop the loaded kernel library's handle).
"""

from __future__ import annotations

import importlib
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

log = logging.getLogger("voidin.pipeline")


@dataclass
class _Entry:
    build: Callable[[], Callable]  # returns a fresh fn
    fn: Callable  # current fn
    sources: list = field(default_factory=list)  # files watched for changes
    mtimes: Dict[str, float] = field(default_factory=dict)
    reload_count: int = 0


class PipelineCache:
    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def register(self, name: str, build: Callable[[], Callable],
                 source: Optional[str] = None, sources=None) -> Callable:
        """Register a pass; `build()` returns the function to call.

        `source`/`sources`: file(s) whose change triggers a reload — the
        import_mapping analogue of the reference arena (pipeline.rs:35-36,
        one pipeline may depend on several shader files). Registering a
        name again replaces its entry. Returns a stable dispatcher that
        always calls the current version.
        """
        srcs = list(sources) if sources else ([source] if source else [])
        fn = build()
        mtimes = {s: os.path.getmtime(s) for s in srcs if os.path.exists(s)}
        with self._lock:
            self._entries[name] = _Entry(build, fn, srcs, mtimes)

        def dispatch(*args, **kwargs):
            return self._entries[name].fn(*args, **kwargs)

        return dispatch

    def discard(self, name: str) -> None:
        """Drop an entry (and what its build closure holds)."""
        with self._lock:
            self._entries.pop(name, None)

    def reload(self, name: str, changed: Optional[str] = None) -> bool:
        """Rebuild one pipeline; keep the old one on failure.

        `changed`: reimport only that source module (None = all sources)."""
        e = self._entries[name]
        try:
            for src in [changed] if changed else e.sources:
                if not src:
                    continue
                mod_name = _module_for(src)
                if mod_name:
                    importlib.reload(importlib.import_module(mod_name))
            new_fn = e.build()
            with self._lock:
                e.fn = new_fn
                e.reload_count += 1
            log.info("reloaded pipeline %s", name)
            return True
        except Exception as exc:  # keep last good pipeline
            log.error("reload of %s failed, keeping previous: %s", name, exc)
            return False

    def poll(self):
        """Reload any pipeline whose source file changed."""
        for name, e in list(self._entries.items()):
            for src in e.sources:
                if not os.path.exists(src):
                    continue
                m = os.path.getmtime(src)
                if m > e.mtimes.get(src, 0.0):
                    e.mtimes[src] = m
                    self.reload(name, changed=src)

    def names(self):
        return list(self._entries)


def _module_for(path: str) -> Optional[str]:
    path = os.path.abspath(path)
    for name, mod in list(sys.modules.items()):
        if getattr(mod, "__file__", None) and os.path.abspath(mod.__file__) == path:
            return name
    return None


class Watcher:
    """Polling file watcher driving PipelineCache.poll (watcher.rs:11-58)."""

    def __init__(self, cache: PipelineCache, interval: float = 0.5):
        self.cache = cache
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self.cache.poll()
            time.sleep(self.interval)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join()
