"""Live HTTP frame viewer (mirrors ``rgbd_recon_tpu/io/viewer.py``) — the
headless stand-in for the reference's interactive GLFW window
(kinect_client.cpp:938-977).

  GET /            minimal page with the live <img> stream + control panel
  GET /stream      multipart/x-mixed-replace PNG stream (one part per *new*
                   frame — clients block on a condition variable)
  GET /frame.png   latest frame, single shot
  POST /control    runtime control channel — the headless equivalent of the
                   reference's keybindings + ImGui panel
                   (kinect_client.cpp:732-807, :318-480). Body: JSON object
                   or urlencoded pairs, e.g. {"tsdf_limit": 0.02}. Commands
                   queue here; the render loop drains them between frames
                   (poll_controls).
  GET /state       JSON of the app-published control state

The server listens on ``127.0.0.1`` unless the caller names another host:
``POST /control`` is unauthenticated, so it is not served to the network by
default (the JAX package's viewer binds ``0.0.0.0``).

Usage: ``python -m rgbd_recon_torch.app scene.ks run.conf -serve 8089`` then
open http://localhost:8089/ (or curl /frame.png).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl

import numpy as np

from ..utils.png import encode_png

_PAGE = b"""<!doctype html>
<html><head><title>rgbd-recon-torch live</title>
<style>body{margin:0;background:#111;display:flex;flex-direction:column;
align-items:center;color:#ccc;font:13px monospace}
img{max-width:100vw;max-height:80vh;image-rendering:pixelated}
#ctl{display:flex;flex-wrap:wrap;gap:6px;max-width:90vw;padding:6px}
#ctl label{display:flex;gap:4px;align-items:center}
input,select,button{background:#222;color:#ccc;border:1px solid #555;
font:12px monospace;width:5em}select{width:auto}</style>
</head><body>
<p>rgbd-recon-torch &mdash; live reconstruction stream</p>
<img src="/stream" onerror="setTimeout(()=>{this.src='/stream?'+Date.now()},1000)">
<div id="ctl">
<label>mode<select id="recon_mode"><option value=0>points</option>
<option value=1 selected>integration</option><option value=2>trigrid</option>
<option value=3>mvt</option></select></label>
<label>shade<select id="shade_mode"><option value=0 selected>textured</option>
<option value=1>shaded</option><option value=2>normals</option></select></label>
<label>voxel<input id="voxel_size" value="0.01"></label>
<label>brick<input id="brick_size" value="0.1"></label>
<label>tsdf<input id="tsdf_limit" value="0.01"></label>
<label>minvox<input id="min_voxels_per_brick" value="10"></label>
<label>zoom<input id="zoom" value="2.5"></label>
<label>colorfill<input type="checkbox" id="colorfill" checked></label>
<label>bricks<input type="checkbox" id="bricking" checked></label>
<label>skip<input type="checkbox" id="skip_space" checked></label>
<label>bilateral<input type="checkbox" id="bilateral" checked></label>
<label>animate<input type="checkbox" id="animate"></label>
<label>grid<input type="checkbox" id="draw_grid"></label>
<button style="width:auto" onclick="apply()">apply</button>
</div>
<script>
function apply(){
  const ids=["recon_mode","shade_mode","voxel_size","brick_size","tsdf_limit",
             "min_voxels_per_brick","zoom"];
  const chk=["colorfill","bricking","skip_space","bilateral","animate",
             "draw_grid"];
  const body={};
  for(const i of ids){body[i]=parseFloat(document.getElementById(i).value);}
  for(const i of chk){body[i]=document.getElementById(i).checked;}
  fetch("/control",{method:"POST",body:JSON.stringify(body)});
}
fetch("/state").then(r=>r.json()).then(s=>{
  for(const k in s){const e=document.getElementById(k);if(!e)continue;
    if(e.type==="checkbox")e.checked=!!s[k];else e.value=s[k];}}).catch(()=>{});
</script>
</body></html>"""

_BOUNDARY = b"rgbdframe"


class LiveViewer:
    """Publish/subscribe frame fan-out plus the HTTP server thread."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._lock = threading.Condition()
        self._frame: np.ndarray | None = None
        self._seq = 0
        self._controls: list[dict] = []
        self._state: dict = {}
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                path = self.path.split("?")[0]
                if path != "/control":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    raw = self.rfile.read(n).decode("utf-8", "replace")
                    try:
                        cmd = json.loads(raw)
                        if not isinstance(cmd, dict):
                            raise ValueError("not an object")
                    except ValueError:
                        cmd = dict(parse_qsl(raw))
                    viewer.push_control(cmd)
                    body = b'{"ok": true}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.send_header("Content-Length", str(len(_PAGE)))
                        self.end_headers()
                        self.wfile.write(_PAGE)
                    elif path == "/frame.png":
                        png = viewer._encode_latest()
                        if png is None:
                            self.send_response(503)
                            self.end_headers()
                            return
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.send_header("Content-Length", str(len(png)))
                        self.end_headers()
                        self.wfile.write(png)
                    elif path == "/state":
                        body = json.dumps(viewer._state).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif path == "/stream":
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "multipart/x-mixed-replace; boundary="
                            + _BOUNDARY.decode(),
                        )
                        self.end_headers()
                        seen = -1
                        while True:
                            frame, seen = viewer._wait_frame(seen)
                            png = encode_png(frame, level=1)
                            self.wfile.write(
                                b"--" + _BOUNDARY + b"\r\n"
                                b"Content-Type: image/png\r\n"
                                b"Content-Length: "
                                + str(len(png)).encode() + b"\r\n\r\n"
                                + png + b"\r\n"
                            )
                            self.wfile.flush()
                    else:
                        self.send_response(404)
                        self.end_headers()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # viewer tab closed

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]  # resolved if port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="live-viewer", daemon=True
        )
        self._thread.start()

    # --- render-loop side -------------------------------------------------
    def publish(self, rgba: np.ndarray) -> None:
        """Store the newest frame (float [H, W, 3/4] in [0, 1] or u8) and
        wake streaming clients. O(copy) for the caller."""
        frame = np.asarray(rgba)
        with self._lock:
            self._frame = frame
            self._seq += 1
            self._lock.notify_all()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # --- control channel --------------------------------------------------
    def push_control(self, cmd: dict) -> None:
        """Queue a control command (HTTP handler side; also usable directly
        by tests/embedders)."""
        with self._lock:
            self._controls.append(dict(cmd))

    def poll_controls(self) -> list[dict]:
        """Drain queued control commands (render-loop side)."""
        with self._lock:
            out, self._controls = self._controls, []
            return out

    def publish_state(self, state: dict) -> None:
        """App-side: publish the current control state for GET /state."""
        with self._lock:
            self._state = dict(state)

    # --- connection-thread side -------------------------------------------
    def _wait_frame(self, seen: int, timeout: float = 30.0):
        with self._lock:
            self._lock.wait_for(
                lambda: self._frame is not None and self._seq != seen, timeout
            )
            return self._frame, self._seq

    def _encode_latest(self):
        with self._lock:
            frame = self._frame
        return None if frame is None else encode_png(frame, level=1)
