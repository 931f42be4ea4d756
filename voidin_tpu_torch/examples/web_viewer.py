"""Browser live viewer, the port's twin of examples/web_viewer.py — the
winit-window + egui-overlay analogue served over HTTP
(crates/app/src/lib.rs:120-205 event loop, app.rs:601-651 egui debug
window). Open the printed URL; frames stream live, the page overlays
fps/camera stats, and WASD/QE + drag (or arrows) fly the camera.

    python -m voidin_tpu_torch.examples.web_viewer [--cpu] [--width W]
        [--height H] [--port P] [--frames N]

On the card by default; --cpu runs the kernels' twins.
"""

from __future__ import annotations

import argparse

from ..framework.webviewer import run_web
from .viewer import make_app  # the same demo scene as the terminal viewer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: until Esc//quit)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' twins)")
    args = ap.parse_args(argv)
    app = make_app(args.width, args.height, "cpu" if args.cpu else "cuda")
    print(f"serving http://127.0.0.1:{args.port}/  (Esc in page quits)")
    n = run_web(app, port=args.port, max_frames=args.frames)
    print(f"viewer closed after {n} frames")


if __name__ == "__main__":
    main()
