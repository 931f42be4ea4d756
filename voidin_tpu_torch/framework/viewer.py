"""Interactive terminal viewer — the winit-window + event-loop analogue.

Counterpart of ``voidin_tpu/framework/viewer.py`` (numpy on the host; each
frame is copied from the App's device to the host once). The reference
opens a winit window with an egui overlay (crates/app/src/lib.rs:120-205);
a headless host has no display, but any
terminal can show 24-bit color: each character cell renders two vertical
pixels via the upper-half-block glyph (fg = top pixel, bg = bottom pixel).
This module draws App frames that way and drives the camera from raw-tty
keys — a live, flyable preview over ssh.

Keys: WASD move, Q/E down/up, arrows look, +/- speed, F3 screenshot,
Esc / Ctrl-C quit (the reference's keymap, lib.rs:90-101 + state.rs:68-78).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .input import CameraController, Input, default_keymap

ESC = "\x1b"
# terminals send no key-up events; a pressed key stays held this long
KEY_HOLD_S = 0.30


def _host(img) -> np.ndarray:
    """A frame as a host array: a tensor (on any device) copied once."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _nearest_grid(h, w, rows_px, cols):
    ys = (np.arange(rows_px) + 0.5) * (h / rows_px)
    xs = (np.arange(cols) + 0.5) * (w / cols)
    return ys.astype(np.int64).clip(0, h - 1), xs.astype(np.int64).clip(0, w - 1)


def ansi_frame(img: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) image (u8 or float [0,1]) -> ANSI half-block string of
    `rows` lines by `cols` cells (2 pixels per cell vertically)."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    ys, xs = _nearest_grid(h, w, rows * 2, cols)
    small = img[ys][:, xs]  # (2*rows, cols, 3)
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for r in range(rows):
        parts = []
        last = None
        for c in range(cols):
            ft = tuple(int(v) for v in top[r, c])
            fb = tuple(int(v) for v in bot[r, c])
            if (ft, fb) != last:
                parts.append(
                    f"{ESC}[38;2;{ft[0]};{ft[1]};{ft[2]}m"
                    f"{ESC}[48;2;{fb[0]};{fb[1]};{fb[2]}m"
                )
                last = (ft, fb)
            parts.append("▀")
        parts.append(f"{ESC}[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def _term_size(img_shape, max_cols=None, max_rows=None):
    try:
        ts = os.get_terminal_size()
        cols, rows = ts.columns, ts.lines - 2  # leave room for the HUD line
    except OSError:
        cols, rows = 100, 30
    if max_cols:
        cols = min(cols, max_cols)
    if max_rows:
        rows = min(rows, max_rows)
    # preserve aspect (cells are ~2x tall even with half blocks: 2 px/cell)
    h, w = img_shape[:2]
    want_rows = max(int(cols * h / w / 2), 1)
    return cols, max(min(rows, want_rows), 1)


class _RawTty:
    """Raw, non-blocking stdin; restores the terminal on exit."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(
                sys.stdin.fileno(), termios.TCSADRAIN, self._saved
            )

    def read_keys(self):
        """Drain pending bytes -> list of key names ('w', 'up', 'esc'...)."""
        import select

        keys = []
        if not self.enabled:
            return keys
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == ESC:
                # arrow keys arrive as ESC [ A/B/C/D
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    seq = sys.stdin.read(1)
                    if seq == "[" and select.select([sys.stdin], [], [], 0.01)[0]:
                        code = sys.stdin.read(1)
                        keys.append(
                            {"A": "up", "B": "down", "C": "right",
                             "D": "left"}.get(code, "esc")
                        )
                        continue
                keys.append("esc")
            else:
                keys.append(ch.lower())
        return keys


def run_terminal(app, max_frames=None, fps_cap=30.0, look_step=4.0,
                 out=None):
    """Drive App.step() from the terminal until Esc (or max_frames).

    `out`: stream for the ANSI frames (default stdout). Returns the number
    of frames shown."""
    out = out or sys.stdout
    inp = Input()
    keymap = default_keymap()
    cc = CameraController(app.state.camera)
    held_until: dict = {}
    shown = 0
    out.write(f"{ESC}[?25l{ESC}[2J")  # hide cursor, clear
    try:
        with _RawTty() as tty_in:
            while max_frames is None or shown < max_frames:
                t_frame = time.perf_counter()
                now = time.perf_counter()
                for k in tty_in.read_keys():
                    if k in ("esc", "\x03"):
                        return shown
                    if k == "up":
                        app.state.camera.pitch = float(
                            np.clip(app.state.camera.pitch + look_step,
                                    -89, 89))
                    elif k == "down":
                        app.state.camera.pitch = float(
                            np.clip(app.state.camera.pitch - look_step,
                                    -89, 89))
                    elif k == "left":
                        app.state.camera.yaw += look_step
                    elif k == "right":
                        app.state.camera.yaw -= look_step
                    elif k == "+":
                        cc.speed *= 1.5
                    elif k == "-":
                        cc.speed /= 1.5
                    elif k == "3":  # F3-equivalent screenshot
                        app.screenshot(f"viewer_{shown:04d}.png")
                    else:
                        held_until[k] = now + KEY_HOLD_S
                        inp.press(k)
                for k, until in list(held_until.items()):
                    if now > until:
                        inp.release(k)
                        del held_until[k]

                actions = keymap.map(inp)
                cc.update(actions, inp, 1.0 / 60.0)
                img = _host(app.step())
                cols, rows = _term_size(img.shape)
                fps = app.fps.tick()
                out.write(f"{ESC}[H" + ansi_frame(img, cols, rows))
                out.write(
                    f"\n{ESC}[0m fps {fps:5.1f}  pos "
                    f"{np.round(app.state.camera.position, 1)}  "
                    f"yaw {app.state.camera.yaw:.0f} pitch "
                    f"{app.state.camera.pitch:.0f}   [WASD/QE move, "
                    f"arrows look, Esc quit]{ESC}[K"
                )
                out.flush()
                inp.tick()
                shown += 1
                dt = time.perf_counter() - t_frame
                if dt < 1.0 / fps_cap:
                    time.sleep(1.0 / fps_cap - dt)
    finally:
        out.write(f"{ESC}[?25h{ESC}[0m\n")
        out.flush()
    return shown
