"""Per-layer spans recorded by the benchmark's own code, around the
program's functions that render_frame calls for each layer: the module
attribute is replaced, as tools/torch_stage_split.py does (copied here),
by a wrapper that records a CUDA event and the host's wall clock
(time.time_ns, the clock of torch.profiler's timestamps) at entry and at
exit. Only the traced run wraps anything. A CUDA event pair times the
span on the device's timeline: from when the stream reaches the entry to
when it reaches the exit, host gaps inside the pass included. The host
times name the device's idle gaps by the pass the host was in."""

import importlib
import time

import torch

PREFIX = "portbench."


def span_name(module, attr):
    return f"{PREFIX}{module.rsplit('.', 1)[-1]}.{attr}"


class Spans:
    def __init__(self):
        self.events = {}  # (module, attr) -> [(start event, end event)]
        self.host = []  # (start ns, end ns, span name) of every span
        self._saved = []
        self.on = False

    def mark(self, name, t0):
        """A host interval of the benchmark's own (a frame, the window)
        from t0 (time.time_ns) to now."""
        self.host.append((t0, time.time_ns(), name))

    def clear(self):
        for store in self.events.values():
            store.clear()
        self.host.clear()

    def wrap(self, module, attr):
        key = (module, attr)
        if key in self.events:
            return
        mod = importlib.import_module(module)
        real = getattr(mod, attr)
        name = span_name(module, attr)
        store = self.events.setdefault(key, [])

        def wrapper(*args, **kwargs):
            if not self.on:
                return real(*args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.time_ns()
            e0.record()
            out = real(*args, **kwargs)
            e1.record()
            self.host.append((t0, time.time_ns(), name))
            store.append((e0, e1))
            return out

        setattr(mod, attr, wrapper)
        self._saved.append((mod, attr, real))

    def restore(self):
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved = []

    def total_ms(self, key):
        """The span's total device-timeline ms (None where never entered)."""
        evs = self.events.get(tuple(key), [])
        if not evs:
            return None
        return sum(a.elapsed_time(b) for a, b in evs)


class Capture:
    """What a roofline reader needs of every call of a program function
    while on: `reduce(args, kwargs, result)` keeps the call's tensors and
    shapes that its work is counted from, and launches nothing (no device
    work and no host sync inside the traced frames); the readers reduce
    them once the profiler has stopped."""

    def __init__(self):
        self.calls = {}
        self._saved = []
        self.on = False

    def wrap(self, module, attr, reduce):
        key = (module, attr)
        if key in self.calls:
            return
        mod = importlib.import_module(module)
        real = getattr(mod, attr)
        store = self.calls.setdefault(key, [])

        def wrapper(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.on:
                store.append(reduce(args, kwargs, out))
            return out

        setattr(mod, attr, wrapper)
        self._saved.append((mod, attr, real))

    def restore(self):
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved = []
