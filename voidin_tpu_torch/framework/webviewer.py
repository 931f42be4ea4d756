"""Browser live viewer over HTTP — the winit-window + egui analogue.

Counterpart of ``voidin_tpu/framework/webviewer.py``: the same page,
endpoints and frame loop; each frame is copied from the App's device to the
host once and encoded by the port's own PNG writer (io/image.encode_png at
zlib level 1, fast enough for 1080p frames), without PIL. The reference
opens a native winit window with an egui debug overlay
(crates/app/src/lib.rs:120-205, app.rs:601-651). A render host is headless,
but every workstation has a browser: `run_web(app)` serves one page that
streams rendered frames (multipart PNG), forwards keyboard + pointer-drag
input into the same Input/KeyboardMap/CameraController stack the terminal
viewer uses, and overlays live stats (fps, frame, camera pose — the egui
debug window's contents). stdlib `http.server` only; no new dependencies.

Endpoints: `/` page, `/stream` multipart frame stream, `/frame.png` latest
frame, `/stats` JSON overlay data, POST `/input` events, POST `/quit`.
Keys follow the reference map: WASD/QE move, Shift boost, arrows look,
drag to look, 3 screenshot, Esc quit (lib.rs:90-101, state.rs:68-78).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..io.image import encode_png
from .input import CameraController, Input, default_keymap
from .viewer import _host

PNG_LEVEL = 1  # zlib level of the served frames

_PAGE = """<!doctype html>
<title>voidin-tpu viewer</title>
<body style="margin:0;background:#101014;color:#dde;font:12px monospace">
<img id="v" src="/stream"
     style="image-rendering:pixelated;width:100vw;display:block">
<div id="hud" style="position:fixed;top:8px;left:8px;background:#000a;
     padding:6px 8px;border-radius:4px;white-space:pre"></div>
<script>
const post = o => fetch('/input',
    {method:'POST', body: JSON.stringify(o)});
addEventListener('keydown', e => {
  if (!e.repeat || e.key.startsWith('Arrow'))
    post({type:'down', key:e.key.toLowerCase()});
  e.preventDefault();
});
addEventListener('keyup', e => post({type:'up', key:e.key.toLowerCase()}));
let drag = null;
v.addEventListener('pointerdown', e => {
  drag = [e.clientX, e.clientY]; v.setPointerCapture(e.pointerId);
});
v.addEventListener('pointerup', () => drag = null);
v.addEventListener('pointermove', e => {
  if (!drag) return;
  post({type:'look', dx:e.clientX - drag[0], dy:e.clientY - drag[1]});
  drag = [e.clientX, e.clientY];
});
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  hud.textContent = `fps ${s.fps.toFixed(1)}   frame ${s.frame}\\n` +
    `pos ${s.pos.map(x => x.toFixed(1))}  yaw ${s.yaw.toFixed(0)} ` +
    `pitch ${s.pitch.toFixed(0)}\\n[WASD/QE move, drag/arrows look, ` +
    `shift boost, 3 shot, esc quit]`;
}, 500);
</script>
"""


class _Shared:
    """Frame + stats published by the render loop, events from HTTP."""

    def __init__(self):
        self.cond = threading.Condition()
        self.frame_png: bytes | None = None
        self.frame_no = 0
        self.stats: dict = {"fps": 0.0, "frame": 0, "pos": [0, 0, 0],
                            "yaw": 0.0, "pitch": 0.0}
        self.events: list = []
        self.stop = False

    def publish(self, png: bytes, stats: dict):
        with self.cond:
            self.frame_png = png
            self.frame_no += 1
            self.stats = stats
            self.cond.notify_all()

    def next_frame(self, after: int, timeout: float = 2.0):
        with self.cond:
            self.cond.wait_for(
                lambda: self.stop
                or (self.frame_no > after and self.frame_png is not None),
                timeout,
            )
            return self.frame_png, self.frame_no

    def push_event(self, ev: dict):
        with self.cond:
            self.events.append(ev)

    def drain_events(self) -> list:
        with self.cond:
            evs, self.events = self.events, []
            return evs

    def shutdown(self):
        with self.cond:
            self.stop = True
            self.cond.notify_all()


def _make_handler(shared: _Shared):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, "text/html", _PAGE.encode())
            elif self.path.startswith("/frame.png"):
                # generous wait: the FIRST frame includes the jit compile
                png, _ = shared.next_frame(after=-1, timeout=120.0)
                if png is None:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif self.path.startswith("/stats"):
                with shared.cond:
                    body = json.dumps(shared.stats).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                seen = -1
                try:
                    while not shared.stop:
                        png, seen = shared.next_frame(after=seen)
                        if png is None:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/png\r\n"
                            b"Content-Length: %d\r\n\r\n" % len(png)
                        )
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            body = self.rfile.read(n) if n else b"{}"
            if self.path.startswith("/input"):
                try:
                    shared.push_event(json.loads(body or b"{}"))
                except json.JSONDecodeError:
                    pass
                self._send(200, "text/plain", b"ok")
            elif self.path.startswith("/quit"):
                self._send(200, "text/plain", b"bye")
                shared.shutdown()
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def _encode_png(img: np.ndarray) -> bytes:
    return encode_png(img, level=PNG_LEVEL)


def run_web(app, host="127.0.0.1", port=8642, max_frames=None,
            fps_cap=30.0, look_step=4.0, ready=None):
    """Serve the viewer and drive App.step() until /quit, Esc in the page,
    or `max_frames`. `ready` (optional threading.Event) is set once the
    server is listening (its port is in `ready.port`). Returns frames shown.
    """
    shared = _Shared()
    server = ThreadingHTTPServer((host, port), _make_handler(shared))
    if ready is not None:
        ready.port = server.server_address[1]
        ready.set()
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()

    inp = Input()
    keymap = default_keymap()
    cc = CameraController(app.state.camera)
    shown = 0
    try:
        while not shared.stop and (max_frames is None or shown < max_frames):
            t_frame = time.perf_counter()
            cam = app.state.camera
            for ev in shared.drain_events():
                t, key = ev.get("type"), ev.get("key", "")
                if t == "look":
                    cam.yaw -= float(ev.get("dx", 0.0)) * cc.sens
                    cam.pitch = float(np.clip(
                        cam.pitch - float(ev.get("dy", 0.0)) * cc.sens,
                        -89, 89,
                    ))
                elif t == "down":
                    if key == "escape":
                        shared.shutdown()
                    elif key == "arrowup":
                        cam.pitch = float(np.clip(cam.pitch + look_step,
                                                  -89, 89))
                    elif key == "arrowdown":
                        cam.pitch = float(np.clip(cam.pitch - look_step,
                                                  -89, 89))
                    elif key == "arrowleft":
                        cam.yaw += look_step
                    elif key == "arrowright":
                        cam.yaw -= look_step
                    elif key == "+":
                        cc.speed *= 1.5
                    elif key == "-":
                        cc.speed /= 1.5
                    elif key == "3":  # F3-equivalent (state.rs:68-78)
                        app.screenshot(f"viewer_{shown:04d}.png")
                    else:
                        inp.press(key)
                elif t == "up":
                    inp.release(key)
            if shared.stop:
                break
            cc.update(keymap.map(inp), inp, 1.0 / 60.0)
            img = _host(app.step())
            fps = app.fps.tick()
            shared.publish(_encode_png(img), {
                "fps": float(fps),
                "frame": int(app.state.frame_count),
                "pos": [float(x) for x in np.asarray(cam.position)],
                "yaw": float(cam.yaw),
                "pitch": float(cam.pitch),
            })
            inp.tick()
            shown += 1
            dt = time.perf_counter() - t_frame
            if dt < 1.0 / fps_cap:
                time.sleep(1.0 / fps_cap - dt)
    finally:
        shared.shutdown()
        server.shutdown()
        server.server_close()
    return shown
