"""Benchmark of voidin_tpu_torch (the PyTorch + CUDA port of voidin) on one
cell of BENCHMARK.json.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is a configuration (configs/<config>.json: the scene's recipe and
sizes, the Renderer's options and capacities) under a traffic mix
(traffic/<mix>.json: the camera's path and the frame step). The run
makes the scene from the seed, builds the port's Renderer on the card,
renders the traffic's warm-up frames (set-up ends there), then renders
frames in a closed loop for --seconds, ending on a whole lap of the
camera's path and the scene's animation: a frame is one Renderer.render
(handed that frame's joint matrices where the scene has skins: set-up
computes one lap of them, pb/animation.py) followed by the host's read
of that frame's gate counters (overflow, exhausted shadow rays,
coverage, a finite image), which waits for the frame to finish. A frame
fails a gate where overflow or exhausted rays are non-zero, nothing is
covered or the image is not finite.

--trace 0 prints the cell's end-to-end metrics: frame_ms (window wall
time / frames), frame_ms_p95 (95th percentile of the frames' wall
times), peak_mem_gib (torch.cuda.max_memory_allocated over set-up and
window) and setup_s (process start to the first timed frame).
--trace 1 wraps the passes named by the cell's per-layer metrics
(metrics/<metric>.py) in spans, profiles the window (capped at the
traffic's trace_frames) with torch.profiler and prints the per-layer
metrics, the device's busy and window seconds and a breakdown.

Either way the frames are then checked against the plain reference
(pb/check.py), and the last line of standard output is one JSON object:
correct, attempted (frames), failed (frames that failed a gate),
metrics, device, [breakdown], check (each compared number with its
limit). The run refuses to run without a CUDA card, and fails if JAX or
the JAX package is loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "voidin_tpu")
CACHE = os.path.join(HERE, ".cache")


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package
    (compared whole: voidin_tpu_torch is not voidin_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def die(msg, code):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def load_cell(name):
    path = os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        die(f"no workload {name!r} in BENCHMARK.json", 2)
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    return cells[name], per_layer


class Frames:
    """The closed frame loop over the traffic's camera path."""

    def __init__(self, renderer, path, config, joints=None):
        from pb import program

        self.r = renderer
        self.path = path
        # a skinned scene's joint matrices of one lap of its animation
        # ((P, J, 4, 4), joint_table): frame f is handed row f % P
        self.joints = joints
        self.program = program
        self.W, self.H = config["width"], config["height"]
        self.taa = config["renderer"]["enable_taa"]
        self.next = 0
        self.failed = 0
        self.slots = {}
        self.kept = {}

    def reserve(self, frames):
        """Host buffers for the frames to keep: (image, the TAA history
        the frame read, the one it left), made in set-up and pinned on a
        card, so that keeping a frame allocates nothing and the device's
        peak memory holds the program's bytes alone."""
        import torch

        hist = self.r.state.history
        pin = hist.device.type == "cuda"

        def buf():
            return torch.empty(hist.shape, dtype=hist.dtype, pin_memory=pin)

        for f in frames:
            self.slots[f] = (buf(), buf() if self.taa else None,
                             buf() if self.taa else None)

    def one(self):
        """Render the next frame and read its gates; a frame with a
        reserved buffer is copied there (self.kept[frame]: image, the
        history read or None on the first frame, the history left or
        None without TAA), and the gates' read waits for the copies."""
        import torch

        f = self.next
        slot = self.slots.get(f)
        before = None
        if slot is not None and self.taa and self.r.state.history_valid:
            before = slot[1].copy_(self.r.state.history, non_blocking=True)
        cam = self.program.camera(self.path.pose(f), self.W, self.H)
        if self.joints is None:
            img = self.r.render(cam, dt=self.path.dt)
        else:
            img = self.r.render(cam, dt=self.path.dt,
                                joint_mats=self.joints[f % len(self.joints)])
        aux = self.r.aux
        zero = torch.zeros((), dtype=torch.int64, device=img.device)
        g = torch.stack([aux["overflow"].to(torch.int64).reshape(()),
                         aux.get("rt_exhausted", zero).to(torch.int64)
                         .reshape(()),
                         (aux["vis_coverage"] == 0).to(torch.int64),
                         (~torch.isfinite(img).all()).to(torch.int64)])
        if slot is not None:
            left = None
            if self.taa:
                left = slot[2].copy_(self.r.state.history, non_blocking=True)
            self.kept[f] = (slot[0].copy_(img, non_blocking=True), before,
                            left)
        bad = bool(g.cpu().any())
        self.failed += bad
        self.next += 1
        return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # load from one host thread: the frame loop is the program's Python
    # dispatch, and idle worker threads of CPU pools only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for sub in ("triton", "torch_kernels"):
        os.makedirs(os.path.join(CACHE, sub), exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(CACHE,
                                                           "torch_kernels")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)

    cell, per_layer = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        die("no CUDA device: torch.cuda.is_available() is False", 2)
    if torch.cuda.device_count() < int(cell["chips"]):
        die(f"the cell needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present", 2)
    if not os.path.isdir(os.path.join(ROOT, "voidin_tpu_torch")):
        die("the program (voidin_tpu_torch) is not in this checkout", 2)
    out, per_frame = run_cell(cell, per_layer, args.seed, args.seconds,
                              args.trace, "cuda")
    for k in sorted(per_frame):
        print(f"check frame {k}: " + ", ".join(
            f"{n} {v:.6g}" for n, v in per_frame[k].items()),
            file=sys.stderr)
    for name, c in out["check"].items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def joint_table(scene, path, device):
    """A skinned scene's joint matrices of every frame of one lap of its
    animation (pb/animation.py period_table), (P, J, 4, 4) f32 in host
    memory, pinned where the frames run on a card; None without skins."""
    import torch

    from pb import animation

    if not scene.skins:
        return None
    table = torch.from_numpy(animation.period_table(scene, path.dt))
    return table.pin_memory() if torch.device(device).type == "cuda" \
        else table


def run_cell(cell, per_layer, seed, seconds, trace, device, size=None):
    """One run of `cell` on `device`: (the result's JSON object, the
    check's numbers of each compared frame). `size` ((width, height))
    overrides the configuration's, for the CPU tests' tiny frames."""
    import torch

    from pb import animation, check, configs, program, stats, traffic

    stamps = [("import", time.perf_counter())]
    config = configs.load(cell["config"])
    if size is not None:
        config = dict(config, width=size[0], height=size[1])
    mix = traffic.load(cell["traffic"])
    limits = check.load_limits(cell["name"])
    scene = configs.build_scene(config, seed)
    path = traffic.CameraPath(mix, config, animation.period(scene))
    stamps.append(("scene", time.perf_counter()))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    renderer = program.make_renderer(config, scene, device)
    stamps.append(("renderer", time.perf_counter()))
    loop = Frames(renderer, path, config, joint_table(scene, path, device))
    metric_mods = {m["name"]: importlib.import_module(f"metrics.{m['name']}")
                   for m in per_layer} if trace else {}

    # set-up: frame 0 (kept for the check) and the warm-up frames
    loop.reserve([0])
    loop.one()
    stamps.append(("frame0", time.perf_counter()))
    warm = []
    for _ in range(int(mix["warmup_frames"])):
        t = time.perf_counter()
        loop.one()
        warm.append(time.perf_counter() - t)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    stamps.append(("warmup", time.perf_counter()))
    print("setup: " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (name, t), (_, t_prev)
        in zip(stamps, [("start", T_START)] + stamps[:-1])),
        file=sys.stderr, flush=True)
    setup_failed = loop.failed
    est_frame = sorted(warm)[len(warm) // 2]
    n_est = max(1, int(seconds / est_frame))
    if trace:
        n_est = min(n_est, int(mix["trace_frames"]))
    loop.reserve(check.sample_frames(seed, loop.next, n_est,
                                     int(mix["check_frames"])))

    metrics, breakdown, device_extra = {}, None, {}
    if not trace:
        times = []
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            loop.one()
            te = time.perf_counter()
            times.append(te - ts)
            if path.window_ends(len(times), te - t0, seconds):
                break
        n = len(times)
        frame_ms, p95 = stats.frame_stats(times, te - t0)
        fifths = [sum(times[i * n // 5:(i + 1) * n // 5]) * 1e3
                  / max(1, (i + 1) * n // 5 - i * n // 5) for i in range(5)]
        print("window: ms a frame by fifths " + " ".join(
            f"{v:.3f}" for v in fifths), file=sys.stderr, flush=True)
        metrics = {"frame_ms": {"value": frame_ms, "unit": "ms"},
                   "frame_ms_p95": {"value": p95, "unit": "ms"}}
    else:
        n, (metrics, breakdown, device_extra) = traced_window(
            loop, seconds, mix, metric_mods, per_layer)
    failed = loop.failed - setup_failed

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if not trace:
        metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    bad = forbidden_modules()
    if bad:
        die(f"JAX or the JAX package is loaded in the timed process: {bad}",
            3)

    # the check, once the window has closed and the program's state is freed
    kept = loop.kept
    del renderer, loop
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    per_frame = check.reference_numbers(config, path, scene, kept, dev)
    print(f"check: the reference took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    correct, numbers = check.verdict(per_frame, limits)
    correct = correct and failed == 0 and setup_failed == 0
    bad = forbidden_modules()
    if bad:
        die(f"JAX or the JAX package is loaded in the process: {bad}", 3)

    out = {"correct": correct, "attempted": n, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if cuda
                               else "cpu"),
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": int(peak), **device_extra,
                      "power_limit_w": card_power_limit() if cuda else None}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {name: {"value": v, "limit": lim}
                    for name, (v, lim) in numbers.items()}
    out["check"]["failed_frames"] = {"value": failed + setup_failed,
                                     "limit": 0}
    return out, per_frame


def traced_window(loop, seconds, mix, metric_mods, per_layer):
    """The traced window: spans around the passes the cell's per-layer
    metrics name, launch captures for its rooflines, torch.profiler
    tracing the device's activity (CUDA only: recording every host op
    would slow the host-bound frame by half) over the traffic's
    trace_frames frames, or fewer whole laps once `seconds` have passed.
    A trace whose count of a
    roofline's kernels differs from the port's launch counters (the
    profiler drops records now and then) is taken again, up to three
    times; a roofline is never read from such a trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pb import spans as sp
    from pb.trace import FRAME, WINDOW, Trace, device_events

    spans, capture = sp.Spans(), sp.Capture()
    rooflines = {}
    for name, mod in metric_mods.items():
        for module, attr in mod.WRAPS:
            spans.wrap(module, attr)
        k = getattr(mod, "KERNEL", None)
        if k is not None:
            rooflines[name] = k
            for (module, attr), red in k.CALLS.items():
                capture.wrap(module, attr, getattr(k, red))
    cap = int(mix["trace_frames"])
    for attempt in range(3):
        spans.clear()
        for store in capture.calls.values():
            store.clear()
        counters0 = {name: counter_total(k) for name, k in rooflines.items()}
        n = 0
        spans.on = capture.on = True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tw = time.time_ns()
            t0 = time.perf_counter()
            while True:
                tf = time.time_ns()
                loop.one()
                spans.mark(FRAME, tf)
                n += 1
                if n >= cap or loop.path.window_ends(
                        n, time.perf_counter() - t0, seconds):
                    break
            spans.mark(WINDOW, tw)
            torch.cuda.synchronize()
        spans.on = capture.on = False
        tr = Trace(device_events(prof), spans.host)
        launches = {name: counter_total(k) - counters0[name]
                    for name, k in rooflines.items()}
        lost = [name for name, k in rooflines.items()
                if sum(tr.kernel_count(kn) for kn in k.KERNELS)
                != launches[name]]
        if not lost:
            break
        print(f"portbench: the trace lost kernel records of {lost}"
              f"{'; tracing again' if attempt < 2 else ''}",
              file=sys.stderr, flush=True)
    spans.restore()
    capture.restore()
    torch.cuda.synchronize()

    class Ctx:
        frames = n
        trace = tr

        @staticmethod
        def span_ms_per_frame(wraps):
            return span_ms_per_frame(spans, wraps, n)

        @staticmethod
        def roofline(k):
            name = next(nm for nm, kk in rooflines.items() if kk is k)
            if name in lost or launches[name] == 0:
                return None
            dev_ms = sum(tr.kernel_ms(kn) for kn in k.KERNELS)
            return 100.0 * k.bound_ms(capture.calls) / dev_ms

    metrics = {}
    for m in per_layer:
        v = metric_mods[m["name"]].read(Ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    return n, (metrics, breakdown, extra)


def span_ms_per_frame(spans, wraps, frames):
    """The total of the spans of `wraps` over the traced frames, a frame
    (None where none of them was entered)."""
    tot = [spans.total_ms(w) for w in wraps]
    tot = [t for t in tot if t is not None]
    return sum(tot) / frames if tot else None


def counter_total(k):
    return sum(getattr(importlib.import_module(module), attr)
               for module, attr in k.COUNTERS)


if __name__ == "__main__":
    sys.exit(main())
