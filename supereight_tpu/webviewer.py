"""Live interactive viewer over HTTP/MJPEG — the pod-friendly
equivalent of the reference's Qt/GLUT windows.

Behavioral reference: se_apps/qt/QtGUI.cpp:84-258 + mainQt.cpp:201-313
(live image view, pause/resume frame pump, reset via
newDenseSLAMSystem, model/camera view toggle) and draw.h:51-112 (the
2x2 composite). A headless accelerator host has no display server, so the "window" is a
tiny in-process HTTP server: browsers render a multipart
``x-mixed-replace`` JPEG stream natively, giving a live view with zero
client software; controls are plain HTTP GETs the SLAM loop polls.

Usage (wired into cli.py via ``--serve PORT``):

    viewer = LiveViewer(port)
    viewer.start()
    ...
    viewer.push(composite_rgba, stats_dict)   # each rendered frame
    if viewer.take_reset(): <rebuild pipeline>
    while viewer.paused: <idle>               # frame pump pause
    viewer.view_mode                          # "follow" | "static"
"""

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>supereight-tpu</title><style>
 body { background:#111; color:#ddd; font-family:monospace; }
 img  { image-rendering:pixelated; width:90%%; max-width:1280px; }
 button { margin:2px; }
 #stats { white-space:pre; }
</style></head><body>
<h3>supereight-tpu live view</h3>
<img src="/stream">
<div>
<button onclick="fetch('/ctl?cmd=pause')">pause</button>
<button onclick="fetch('/ctl?cmd=resume')">resume</button>
<button onclick="fetch('/ctl?cmd=reset')">reset</button>
<button onclick="fetch('/ctl?cmd=view=follow')">camera view</button>
<button onclick="fetch('/ctl?cmd=view=static')">static view</button>
</div>
<div id="stats"></div>
<script>
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('stats').textContent =
      JSON.stringify(await r.json(), null, 1);
}, 1000);
</script>
</body></html>"""


class LiveViewer:
    """Threaded MJPEG server + control flags polled by the SLAM loop."""

    def __init__(self, port: int = 8080, quality: int = 80):
        self._port = port
        self._quality = quality
        self._lock = threading.Condition()
        self._jpeg = None
        self._seq = 0
        self._stats = {}
        self.paused = False
        self.view_mode = "follow"      # "follow" | "static"
        self._reset = False
        self._server = None
        self._thread = None

    # -- SLAM-loop side -------------------------------------------------
    def push(self, rgba, stats=None):
        """Encode + publish the latest composite frame (numpy RGBA/RGB)."""
        from PIL import Image
        arr = np.asarray(rgba)[..., :3]
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(arr)).save(
            buf, "JPEG", quality=self._quality)
        with self._lock:
            self._jpeg = buf.getvalue()
            self._seq += 1
            if stats is not None:
                self._stats = {k: (float(v) if hasattr(v, "__float__")
                                   else v) for k, v in stats.items()}
            self._lock.notify_all()

    @property
    def reset_pending(self) -> bool:
        with self._lock:
            return self._reset

    def take_reset(self) -> bool:
        """True once per reset request (QtGUI newDenseSLAMSystem path)."""
        with self._lock:
            r, self._reset = self._reset, False
            return r

    # -- server side ----------------------------------------------------
    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/stats":
                    body = json.dumps(viewer._stats).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/ctl":
                    cmd = parse_qs(u.query).get("cmd", [""])[0]
                    with viewer._lock:
                        if cmd == "pause":
                            viewer.paused = True
                        elif cmd == "resume":
                            viewer.paused = False
                        elif cmd == "reset":
                            viewer._reset = True
                        elif cmd.startswith("view="):
                            viewer.view_mode = cmd.split("=", 1)[1]
                    self.send_response(204)
                    self.end_headers()
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=se8frame")
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            with viewer._lock:
                                if viewer._seq == last:
                                    viewer._lock.wait(timeout=5.0)
                                if viewer._jpeg is None \
                                        or viewer._seq == last:
                                    continue
                                jpeg, last = viewer._jpeg, viewer._seq
                            self.wfile.write(b"--se8frame\r\n")
                            self.wfile.write(b"Content-Type: image/jpeg\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(jpeg)}\r\n\r\n"
                                .encode())
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer(("0.0.0.0", self._port), Handler)
        self._port = self._server.server_address[1]   # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._port

    @property
    def port(self):
        return self._port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
