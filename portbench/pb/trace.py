"""Reading the traced window: the device's activity intervals (kernels,
copies, sets) from torch.profiler's kineto events, the benchmark's own
host spans (pb/spans.py, on the same wall clock), and from them the busy
and idle time, kernels per frame, each kernel's device time and the idle
gaps named by the layer the host was in when the device went idle."""

import torch

from .spans import PREFIX

WINDOW = PREFIX + "window"
FRAME = PREFIX + "frame"


def _is_kernel(e):
    try:
        kind = str(e.activity_type()).lower()
        if "memcpy" in kind or "memset" in kind:
            return False
    except (AttributeError, RuntimeError):
        pass
    n = e.name()
    return not (n.startswith("Memcpy") or n.startswith("Memset"))


def device_events(prof):
    """(start ns, end ns, name, is a kernel) of the device's activity in a
    torch.profiler run (user annotations, which kineto mirrors on the
    device's timeline, left out)."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name()
        try:
            if "annotation" in str(e.activity_type()).lower():
                continue
        except (AttributeError, RuntimeError):
            pass
        if n.startswith(PREFIX):
            continue
        s, d = e.start_ns(), e.duration_ns()
        dev.append((s, s + d, n, _is_kernel(e)))
    return dev


class Trace:
    def __init__(self, dev, host):
        win = [h for h in host if h[2] == WINDOW]
        if not win:
            raise RuntimeError("the profiler trace holds no window span")
        self.t0, self.t1 = win[0][0], win[0][1]
        self.dev = sorted((max(a, self.t0), min(b, self.t1), n, k)
                          for a, b, n, k in dev if b > self.t0 and a < self.t1)
        self.host = [h for h in host if h[2] not in (WINDOW,)]

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        out = []
        for a, b, _, _ in self.dev:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_count(self, name=None):
        return sum(1 for _, _, n, k in self.dev
                   if k and (name is None or name in n))

    def kernel_ms(self, name):
        return sum(b - a for a, b, n, k in self.dev if k and name in n) / 1e6

    def top_ops(self, k=10):
        tot = {}
        for a, b, n, _ in self.dev:
            tot[n] = tot.get(n, 0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    def _host_layer(self, t):
        """The innermost benchmark span the host was in at time t."""
        best = None
        for a, b, n in self.host:
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        if best is None:
            return "between_frames"
        name = best[2][len(PREFIX):]
        return "frame_driver" if name == "frame" else name

    def idle_gaps(self, k=10):
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((a - prev, prev))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((self.t1 - prev, prev))
        gaps.sort(reverse=True)
        return [[self._host_layer(t), g / 1e9] for g, t in gaps[:k]]
