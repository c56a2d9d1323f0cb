"""Live progressive viewer: browser canvas fed by a local HTTP server
(PyTorch port of ``raytracer_tpu/viewer.py``).

The equivalent of the reference's two interactive frontends:

- the native minifb window with its render-thread/GUI-thread split
  (reference: raytracer/src/main.rs:179-253) becomes a render thread
  plus an HTTP server sharing the latest tonemapped frame under a lock;
- the WASM/browser canvas driven by requestAnimationFrame
  (reference: raytracer_wasm/src/lib.rs:28-55, www/index.html:10-23)
  becomes a page polling /frame.png.

Routes: `/` (the page), `/frame.png` (the latest frame, encoded with
utils/png_io's zlib encoder), `/stats` (frames, fps, rays/s and the
program's counters, `utils.profiling.counters()`, as JSON) and
`/key/<k>`.  Keyboard camera controls mirror main.rs:107-169: arrows +
comma/period move, WASD rotates; every move clears the film.

`Viewer` holds the server and the render thread, so a caller can start
both on a free port (port=0) and close them; `serve` is the blocking
front end of the CLI.  The raytracer (its device tensors and
intersector) is built by the caller before the render thread starts;
only that thread renders.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from raytracer_tpu_torch.utils.png_io import encode_png
from raytracer_tpu_torch.utils.profiling import counters
from raytracer_tpu_torch.utils.stats import Stats

INDEX_HTML = """<!doctype html>
<html><head><title>raytracer_tpu_torch</title></head>
<body style="background:#222;color:#ddd;font-family:monospace">
<div id="stats"></div>
<img id="view" style="image-rendering:pixelated"/>
<div>keys: arrows/comma/period move &middot; WASD rotate</div>
<script>
const img = document.getElementById('view');
const stats = document.getElementById('stats');
function tick() {
  img.src = '/frame.png?' + Date.now();
  fetch('/stats').then(r => r.json()).then(s => {
    stats.textContent = `frame ${s.frames}  ${s.fps.toFixed(1)} fps  ` +
                        `${(s.rays_per_sec/1e6).toFixed(2)} Mrays/s`;
  });
}
img.onload = () => requestAnimationFrame(tick);
img.onerror = () => setTimeout(tick, 250);
document.addEventListener('keydown', e => fetch('/key/' + e.key));
tick();
</script></body></html>"""

# key -> (method, args); mirrors handle_events (main.rs:123-163)
_KEYMAP = {
    "ArrowLeft": ("move", (-0.1, 0.0, 0.0)),
    "ArrowRight": ("move", (0.1, 0.0, 0.0)),
    "ArrowUp": ("move", (0.0, 0.1, 0.0)),
    "ArrowDown": ("move", (0.0, -0.1, 0.0)),
    ",": ("move", (0.0, 0.0, 0.1)),
    ".": ("move", (0.0, 0.0, -0.1)),
    "w": ("rot", (0.1, 0.0)),
    "s": ("rot", (-0.1, 0.0)),
    "a": ("rot", (0.0, 0.1)),
    "d": ("rot", (0.0, -0.1)),
}


class Viewer:
    """The live view of one RayTracer `rt`: an HTTP server bound to
    127.0.0.1:`port` (0 picks a free port, see `.port`) and a render
    thread that traces progressive frames until `frame_iterations`
    frames (0 = until closed), applying queued camera keys before each
    frame.  Nothing runs until `start`; `close` stops both."""

    def __init__(self, rt, port: int = 8000, frame_iterations: int = 0):
        self.rt = rt
        self.frame_iterations = frame_iterations
        self.state = {"frames": 0, "fps": 0.0, "rays_per_sec": 0.0,
                      "png": b""}
        self.error = None       # traceback text if the render loop failed
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._events = []       # pending camera events (main.rs:180 mpsc)
        self.server = ThreadingHTTPServer(("127.0.0.1", port),
                                          self._handler())
        self._render = threading.Thread(target=self._render_loop,
                                        name="viewer-render", daemon=True)
        self._http = None

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def start(self, serve: bool = False):
        """Start the render thread; with `serve`, also the HTTP server in
        a thread of its own (else call `self.server.serve_forever()`)."""
        self._render.start()
        if serve:
            self._http = threading.Thread(target=self.server.serve_forever,
                                          name="viewer-http", daemon=True)
            self._http.start()
        return self

    def close(self, timeout: float = 60.0):
        """Stop the render loop (after its current frame) and the server,
        and wait for their threads."""
        self._stop.set()
        if self._http is not None:
            self.server.shutdown()
            self._http.join(timeout)
        self.server.server_close()
        if self._render.is_alive():
            self._render.join(timeout)

    def _render_loop(self):
        rt = self.rt
        stats = Stats()
        try:
            while not self._stop.is_set():
                with self._lock:
                    pending, self._events[:] = self._events[:], []
                for kind, args in pending:      # handle_events parity
                    if kind == "move":
                        rt.move_camera(*args)
                    else:
                        rt.rotate_camera(*args)
                n = rt.trace_frame_additive()
                # the readback below waits for the frame's device work
                png = encode_png(rt.get_tonemapped_image())
                dt = time.perf_counter() - stats.last_iteration
                stats.stats(n)
                with self._lock:
                    self.state["frames"] += 1
                    self.state["fps"] = 1.0 / dt if dt > 0 else 0.0
                    self.state["rays_per_sec"] = n / dt if dt > 0 else 0.0
                    self.state["png"] = png
                    done = self.state["frames"]
                if self.frame_iterations and done >= self.frame_iterations:
                    break
        except Exception:
            # the server stays up; the failure is reported, not lost
            self.error = traceback.format_exc()
            print(f"viewer render loop failed:\n{self.error}",
                  file=sys.stderr)

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html", INDEX_HTML.encode())
                elif self.path.startswith("/frame.png"):
                    with viewer._lock:
                        png = viewer.state["png"]
                    if png:
                        self._send(200, "image/png", png)
                    else:
                        self._send(404, "text/plain", b"no frame yet")
                elif self.path.startswith("/stats"):
                    with viewer._lock:
                        state = {k: viewer.state[k] for k in
                                 ("frames", "fps", "rays_per_sec")}
                    body = json.dumps(dict(state, counters=counters()))
                    self._send(200, "application/json", body.encode())
                elif self.path.startswith("/key/"):
                    action = _KEYMAP.get(self.path[len("/key/"):])
                    if action:
                        with viewer._lock:
                            viewer._events.append(action)
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler


def serve(rt, port: int = 8000, frame_iterations: int = 0):
    """Run the render loop in a thread and serve frames until Ctrl-C."""
    viewer = Viewer(rt, port=port, frame_iterations=frame_iterations)
    viewer.start()
    print(f"serving live view on http://127.0.0.1:{viewer.port}")
    try:
        viewer.server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()
    return 0
