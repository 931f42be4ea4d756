"""Frame recorder: pipes raw frames into ffmpeg on a background thread.

Counterpart of ``voidin_tpu/framework/recorder.py``, with its three
routes. Same design as the reference Recorder
(components/src/recorder.rs:24-224): a worker thread drains a queue of RGB
frames into a spawned ffmpeg. When ffmpeg is unavailable (the reference
degrades to PNG screenshots, recorder.rs:33-46) video paths still produce
a VIDEO via the dependency-free MJPEG-AVI writer (io/avi.py, the port's own
JPEG encoder); directory paths produce PNG sequences (io/image.save_png).
`push` takes a tensor on any device or a host array and copies a tensor to
the host once; the queue and the worker hold host arrays only, so a
backed-up queue pins no device memory.
"""

from __future__ import annotations

import os
import queue
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch


class Recorder:
    def __init__(self, width: int, height: int, fps: int = 60):
        self.width = width
        self.height = height
        self.fps = fps
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=16)
        self._thread: Optional[threading.Thread] = None
        self._proc = None
        self._png_dir: Optional[str] = None
        self._avi = None
        self._count = 0
        self.out_path: Optional[str] = None  # actual destination, set by start()

    @property
    def ffmpeg_available(self) -> bool:
        return shutil.which("ffmpeg") is not None

    def start(self, path: str) -> str:
        """Begin recording; returns the ACTUAL output path (without ffmpeg
        a video path is rewritten to .avi, a non-video path becomes a PNG
        directory — callers must use the return value, not `path`)."""
        self._count = 0
        self.out_path = path
        if self.ffmpeg_available and path.endswith((".mp4", ".mkv", ".webm")):
            self._proc = subprocess.Popen(
                [
                    "ffmpeg",
                    "-y",
                    "-f",
                    "rawvideo",
                    "-pix_fmt",
                    "rgb24",
                    "-s",
                    f"{self.width}x{self.height}",
                    "-r",
                    str(self.fps),
                    "-i",
                    "-",
                    "-pix_fmt",
                    "yuv420p",
                    "-crf",
                    "18",
                    path,
                ],
                stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        elif path.endswith((".mp4", ".mkv", ".webm", ".avi")):
            # no ffmpeg: still deliver a video, not a PNG pile
            from ..io.avi import MjpegAviWriter

            out = path if path.endswith(".avi") else (
                os.path.splitext(path)[0] + ".avi"
            )
            if out != path:
                import logging

                logging.getLogger(__name__).warning(
                    "no ffmpeg: recording MJPEG-AVI to %s instead of %s",
                    out, path,
                )
            self.out_path = out
            self._avi = MjpegAviWriter(out, self.width, self.height, self.fps)
        else:
            self._png_dir = path if os.path.isdir(path) else os.path.splitext(path)[0]
            os.makedirs(self._png_dir, exist_ok=True)
            self.out_path = self._png_dir
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self.out_path

    def push(self, frame):
        """Queue one (H, W, 3) frame: a host array as it is, a tensor as a
        host copy (one explicit copy, wherever the tensor lives)."""
        if isinstance(frame, torch.Tensor):
            frame = frame.detach().to("cpu", copy=True).numpy()
        self._queue.put(np.asarray(frame))

    def _worker(self):
        from ..io.image import save_png

        while True:
            frame = self._queue.get()
            if frame is None:
                break
            rgb = (np.clip(np.nan_to_num(frame[..., :3]), 0, 1) * 255 + 0.5).astype(
                np.uint8
            )
            if self._proc is not None:
                try:
                    self._proc.stdin.write(rgb.tobytes())
                except BrokenPipeError:
                    pass
            elif self._avi is not None:
                self._avi.write(rgb)
            else:
                save_png(
                    os.path.join(self._png_dir, f"frame_{self._count:05d}.png"), rgb
                )
            self._count += 1

    def finish(self):
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join()
        self._thread = None
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
            self._proc = None
        if self._avi is not None:
            self._avi.close()
            self._avi = None
