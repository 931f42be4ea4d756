"""Fullscreen raymarched fractal, the port's twin of examples/fractal.py
(src/bin/fractal.rs + fractal.wgsl): a 'fullscreen shader' demo in plain
PyTorch on the device — no geometry, just a per-pixel raymarch, as the
JAX example is plain jnp.

    python -m voidin_tpu_torch.examples.fractal [--cpu] [--width W]
        [--height H] [--time T] [--out PATH]
"""

from __future__ import annotations

import argparse

import torch

from ..io.image import save_png
from ..scene.texture import linear_to_srgb


def sdf(p, t):
    """Mandelbulb-ish folded box distance field at points (..., 3)."""
    z = p
    dr = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    for _ in range(10):
        z = torch.clamp(z, -1.0, 1.0) * 2.0 - z  # box fold
        r2 = (z * z).sum(-1, keepdim=True)
        k = torch.clamp(1.0 / torch.clamp(r2, min=0.25), 1.0, 4.0)
        z = z * k * 2.2 + p * (0.4 + 0.1 * torch.sin(t))
        dr = dr * torch.abs(k[..., 0]) * 2.2 + 1.0
    return (torch.linalg.norm(z, dim=-1) - 2.0) / dr


def render(width, height, t, device):
    """The (H, W, 3) sRGB image at time t."""
    t = torch.tensor(t, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    u = (torch.arange(width, **f32) + 0.5) / width * 2 - 1
    v = (1 - (torch.arange(height, **f32) + 0.5) / height * 2) * height / width
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    ro = torch.tensor([0.0, 0.0, -6.0], **f32)
    rd = torch.stack([uu, vv, torch.ones_like(uu)], -1)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    tt = torch.full((height, width), 2.0, **f32)
    for _ in range(64):
        tt = tt + sdf(ro + rd * tt[..., None], t) * 0.7
    p = ro + rd * tt[..., None]
    eps = 1e-3
    axes = torch.eye(3, **f32) * eps
    n = torch.stack([sdf(p + axes[i], t) - sdf(p - axes[i], t)
                     for i in range(3)], -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    light = torch.tensor([0.5, 0.7, -0.5], **f32)
    lit = torch.clamp((n * light).sum(-1), 0, 1)
    hit = tt < 20.0
    fog = torch.exp(-0.08 * tt)
    base = torch.stack([lit * 0.9 + 0.05, lit * 0.6 + 0.08, lit * 0.4 + 0.15],
                       -1)
    col = torch.where(hit[..., None], base * fog[..., None],
                      torch.tensor(0.02, **f32))
    return linear_to_srgb(col)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--time", type=float, default=1.5)
    ap.add_argument("--out", default="fractal.png")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    img = render(args.width, args.height, args.time,
                 torch.device("cpu" if args.cpu else "cuda"))
    save_png(args.out, img.cpu().numpy())
    print("wrote", args.out)


if __name__ == "__main__":
    main()
