"""On-image HUD: frame statistics burned into the frame by a final pass.

Counterpart of ``voidin_tpu/passes/hud.py``. The reference shows an egui
debug window with the frame time (src/bin/model.rs:221-228); a headless
host has no window system, so the HUD is a tiny 5x7 bitmap-font blit
composited into the frame (SURVEY.md §5.5). Supports digits, '.', ':',
'm', 's', 'f', 'p' — enough for "FPS: 60.0" / "ms: 16.6". ``draw_hud``
composites on a tensor on its own device (the JAX ``.at[].set`` is a
write into a clone), ``draw_hud_np`` on a host array."""

from __future__ import annotations

import numpy as np
import torch

_GLYPHS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"],
    ":": ["000", "010", "000", "010", "000"],
    " ": ["000", "000", "000", "000", "000"],
    "m": ["000", "110", "111", "101", "101"],
    "s": ["011", "100", "010", "001", "110"],
    "f": ["011", "010", "111", "010", "010"],
    "p": ["110", "101", "110", "100", "100"],
}


def text_bitmap(text: str, scale: int = 2) -> np.ndarray:
    """(H, W) float mask for a string."""
    rows = [[] for _ in range(5)]
    for ch in text.lower():
        g = _GLYPHS.get(ch, _GLYPHS[" "])
        for r in range(5):
            rows[r] += [int(c) for c in g[r]] + [0]
    arr = np.array(rows, np.float32)
    if scale > 1:
        arr = np.repeat(np.repeat(arr, scale, axis=0), scale, axis=1)
    return arr


def draw_hud(image: torch.Tensor, text: str, origin=(4, 4), scale: int = 2,
             color=(1.0, 1.0, 0.2)) -> torch.Tensor:
    """Composite `text` onto an (H, W, 3) tensor; returns a new tensor on
    the image's device (the input is left as it was)."""
    mask = torch.from_numpy(text_bitmap(text, scale)).to(image.device)
    h, w = mask.shape
    y0, x0 = origin
    region = image[y0:y0 + h, x0:x0 + w, :]
    col = torch.tensor(color, dtype=image.dtype, device=image.device)
    m = mask[..., None]
    blended = region * (1.0 - m * 0.85) + col * m * 0.85
    out = image.clone()
    out[y0:y0 + h, x0:x0 + w, :] = blended
    return out


def draw_hud_np(image: np.ndarray, text: str, origin=(4, 4), scale: int = 2,
                color=(1.0, 1.0, 0.2)) -> np.ndarray:
    """Host-side variant for per-frame dynamic text, on a host copy of
    the frame (the recorder's path)."""
    img = np.array(image, copy=True)
    mask = text_bitmap(text, scale)
    h, w = mask.shape
    y0, x0 = origin
    h = min(h, img.shape[0] - y0)
    w = min(w, img.shape[1] - x0)
    m = mask[:h, :w, None] * 0.85
    img[y0 : y0 + h, x0 : x0 + w, :3] = (
        img[y0 : y0 + h, x0 : x0 + w, :3] * (1 - m) + np.asarray(color) * m
    )
    return img
