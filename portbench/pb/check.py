"""What decides `correct`: the frames the timed path produced, against the
plain reference (reference/render.py) rendering the same frames of the
same scene from the benchmark's own arrays.

Frames compared: frame 0 (the first frame the Renderer draws, in set-up:
its image depends on nothing before it), the window's first frame and
frames of the measured window drawn from the seed. A TAA frame reads the
history of every frame before it. The reference renders frame 0 to the
window's first frame as a chain of its own, each from the history its
own frame before left, so that frame's image and the history it leaves
hold the program's whole history from its start against the reference.
A later compared frame it renders from the program's own history as it
stood before that frame (copied off the device during the window), so
that its one step is judged alone and the reference need not replay
every frame of the window. A skinned scene's reference poses each frame
it renders from that frame's joint matrices, the program's own input
(pb/animation.py).

Numbers, each the largest over the compared frames of a run and over a
frame's image and the history it leaves (encoded as an image is: post
and sRGB), on (H, W, 3) sRGB images:
  mean_abs   mean |program - reference| over every pixel and channel;
  p99_abs    its 99th percentile;
  off_share  the share of pixels with a channel off by more than 0.05
             (the two rasterizers may part on pixels exactly on an edge
             or at a depth tie, and nowhere else).
Limits: limits/<workload>.json, set from the readings PERF.md gives.
"""

import json
import os

import numpy as np
import torch

from . import animation
from . import camera as pcam

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBERS = ("mean_abs", "p99_abs", "off_share")
OFF = 0.05


def load_limits(workload):
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        lim = json.load(f)
    return {k: float(lim[k]) for k in NUMBERS}


def sample_frames(seed, first, n_est, n):
    """The window's first frame and `n` other frame indices of the window
    [first, first + n_est), distinct, drawn from the seed within its first
    four fifths (so a slower run still reaches them): n + 1 frames in
    every run."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 7919])
    span = max(n + 1, int(0.8 * n_est))
    picks = rng.choice(np.arange(1, span), size=n, replace=False)
    return sorted([first] + [first + int(k) for k in picks])


def compare(img, ref):
    d = (img.to(torch.float32) - ref.to(torch.float32)).abs()
    flat = d.reshape(-1)
    return dict(mean_abs=float(flat.mean()),
                p99_abs=float(torch.quantile(flat[::max(1, flat.numel()
                                                       // (1 << 24))]
                                             .to(torch.float64), 0.99)),
                off_share=float((d.amax(-1) > OFF).to(torch.float32).mean()))


def uniforms(path, config, frames):
    """The reference's camera uniform of each frame in `frames` (with the
    frame before it, which the uniform carries as the previous one)."""
    W, H = config["width"], config["height"]
    taa = config["renderer"]["enable_taa"]
    out = {}
    for k in frames:
        prev = None
        for f in ([k - 1] if k > 0 else []) + [k]:
            pos, yaw, pitch = path.pose(f)
            jit = pcam.jitter(f, W, H) if taa else np.zeros(2, np.float32)
            prev = pcam.Uniform(pos, yaw, pitch, W / H, jit, previous=prev)
        out[k] = prev
    return out


def chain_end(kept, taa):
    """The last frame of the reference's own chain: the window's first
    kept frame (the first after frame 0) with TAA, frame 0 without."""
    later = [k for k in kept if k > 0]
    return min(later) if taa and later else 0


def render_frames(ref, path, config, kept, scene):
    """{frame: (image, the history it read, the history it left)} of the
    reference `ref` of `scene` for each frame of `kept`, as the check
    renders them: frames 0 to chain_end in a chain from its own history,
    each later frame from the program's history that kept[frame] holds.
    A skinned scene's reference is posed at each frame by that frame's
    joint matrices (pb/animation.py, the program's own input)."""

    def pose(k):
        if not ref.skins:
            return {}
        return {"joint_mats": animation.joint_matrices(scene, k, path.dt)}

    end = chain_end(kept, config["renderer"]["enable_taa"])
    cams = uniforms(path, config, sorted(set(range(end + 1)) | set(kept)))
    out, hist = {}, None
    for k in range(end + 1):
        read = hist
        img, hist = ref.frame(k, cams[k], path.dt, history=read, **pose(k))
        if k in kept:
            out[k] = (img, read, hist)
    for k in sorted(kept):
        if k > end:
            read = kept[k][1]
            img, left = ref.frame(k, cams[k], path.dt, history=None
                                  if read is None else read.to(ref.dev),
                                  **pose(k))
            out[k] = (img, read, left)
    return out


def reference_numbers(config, path, scene, kept, device):
    """{frame: numbers} of the kept frames ({frame: (image, the TAA
    history the frame read or None, the history it left or None)})
    against the float32 reference (render_frames): the image, and the
    history left (both histories through the reference's post and sRGB
    encode), the larger reading of the two."""
    from reference.render import Reference

    ref = Reference(scene, config, device)
    want = render_frames(ref, path, config, kept, scene)
    out = {}
    for k in sorted(kept):
        img, _, left = kept[k]
        got, _, got_left = want.pop(k)
        nums = compare(img.to(ref.dev), got)
        if left is not None:
            h = compare(ref.encode(left.to(ref.dev, ref.ft)),
                        ref.encode(got_left))
            nums = {n: max(nums[n], h[n]) for n in NUMBERS}
        out[k] = nums
        del got, got_left
    return out


def verdict(per_frame, limits):
    """(correct, {number: (value, limit)}): each number's largest reading
    over the frames, against its limit."""
    worst = {n: max(v[n] for v in per_frame.values()) for n in NUMBERS}
    ok = all(worst[n] <= limits[n] for n in NUMBERS)
    return ok, {n: (worst[n], limits[n]) for n in NUMBERS}
