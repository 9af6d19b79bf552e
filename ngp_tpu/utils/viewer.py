"""Minimal web viewer — the framework's interactive frontend.

The reference's GUI is an ImGui/GLFW/OpenGL application wired into the
CUDA render loop (``src/testbed.cu:1003-2743``). A native window is the
wrong shape for an accelerator host (usually a remote VM), so the
frontend is a tiny HTTP server around ``Testbed.frame()``: the browser
polls ``/frame.jpg`` (each poll advances training by a chunk and renders
at the dynamic resolution) and posts orbit-camera updates. Single-
threaded on purpose — one JAX context, requests serialize.

Usage::

    python scripts/viewer.py data/nerf/fox --port 8080

Endpoints:
  GET  /            the HTML/JS client (canvas + mouse orbit + keys)
  GET  /frame.jpg   one heartbeat frame as JPEG (?w=&h=&train=0/1)
  GET  /state       JSON: step, loss, meters, camera, crop, path length
  POST /camera      JSON: {yaw, pitch, radius, fov} (partial ok)
  POST /crop        JSON: {min:[3], max:[3]} render crop box
                    (m_render_aabb / the GUI crop gizmo,
                    src/testbed.cu:1409-1541)
  GET  /histograms  JSON: per-level hash-table weight histograms
                    (the GUI's encoding view, src/testbed.cu:1932)
  POST /path        JSON: {op: add|clear|play|stop} camera-path editor
                    (src/testbed.cu:1019-1147); `add` keyframes the
                    current orbit camera
  GET  /path.json   the keyframes in the reference's camera-path JSON
                    dialect (load into run.py --video_camera_path)
"""

from __future__ import annotations

import io
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>ngp_tpu viewer</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace; }
#hud { position:fixed; top:8px; left:8px; white-space:pre; }
#side { position:fixed; top:8px; right:8px; width:230px; }
#side div { margin-bottom:4px; }
input[type=range] { width:110px; vertical-align:middle; }
button { font:12px monospace; background:#222; color:#ccc;
         border:1px solid #555; margin-right:3px; }
canvas.view { display:block; margin:auto; image-rendering:pixelated; }
#hist { background:#181818; }
a { color:#8cf; }
</style></head><body>
<div id="hud"></div>
<canvas id="c" class="view" width="512" height="512"></canvas>
<div id="side">
 <div><b>crop box</b> <span id="cropv"></span></div>
 <div id="crop"></div>
 <div><b>camera path</b> (<span id="nkeys">0</span> keys)
  <button onclick="pathOp('add')">add [k]</button>
  <button onclick="pathOp('clear')">clear</button>
  <button id="playbtn" onclick="togglePlay()">play</button>
  <a href="/path.json" download="base_cam.json">export</a></div>
 <div><b>hash levels</b> (log|w|)</div>
 <canvas id="hist" width="230" height="120"></canvas>
</div>
<script>
let yaw=0, pitch=0.3, radius=1.6, fov=50, training=1, dragging=false, lx=0, ly=0;
let playing=false;
const c=document.getElementById('c'), ctx=c.getContext('2d');
c.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{ if(!dragging) return;
  yaw+=(e.clientX-lx)*0.01; pitch+=(e.clientY-ly)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX; ly=e.clientY;
  postCam(); };
window.onwheel=e=>{ radius*=Math.exp(e.deltaY*0.001); postCam(); };
window.onkeydown=e=>{ if(e.key==='t'){training^=1;}
  if(e.key==='k'){pathOp('add');} };
function postCam(){ fetch('/camera',{method:'POST',
  body:JSON.stringify({yaw:yaw,pitch:pitch,radius:radius,fov:fov})}); }
function pathOp(op){ fetch('/path',{method:'POST',
  body:JSON.stringify({op:op})}).then(r=>r.json()).then(s=>{
    document.getElementById('nkeys').textContent=s.n_keyframes; }); }
function togglePlay(){ playing=!playing;
  document.getElementById('playbtn').textContent=playing?'stop':'play';
  pathOp(playing?'play':'stop'); }
// crop sliders: 6 ranges in [0,1]
const cropDiv=document.getElementById('crop');
const cropVals=[0,0,0,1,1,1];
'xmin ymin zmin xmax ymax zmax'.split(' ').forEach((n,i)=>{
  const r=document.createElement('input');
  r.type='range'; r.min=0; r.max=1; r.step=0.01; r.value=cropVals[i];
  r.oninput=()=>{ cropVals[i]=parseFloat(r.value); postCrop(); };
  const d=document.createElement('div');
  d.textContent=n+' '; d.appendChild(r); cropDiv.appendChild(d); });
function postCrop(){
  document.getElementById('cropv').textContent=cropVals.map(v=>v.toFixed(2)).join(',');
  fetch('/crop',{method:'POST',body:JSON.stringify(
    {min:cropVals.slice(0,3), max:cropVals.slice(3,6)})}); }
async function drawHist(){
  try {
    const h=await (await fetch('/histograms')).json();
    const hc=document.getElementById('hist'), g=hc.getContext('2d');
    g.clearRect(0,0,hc.width,hc.height);
    const L=h.levels.length, bh=hc.height/L;
    h.levels.forEach((lev,li)=>{
      const mx=Math.max(...lev,1e-9), n=lev.length;
      g.fillStyle='hsl('+(li*37%360)+',60%,55%)';
      lev.forEach((v,bi)=>{ const bw=hc.width/n;
        g.fillRect(bi*bw, (li+1)*bh-(v/mx)*(bh-2), bw, (v/mx)*(bh-2)); });
    });
  } catch(e) {}
  setTimeout(drawHist, 4000);
}
drawHist();
async function loop(){
  const img=new Image();
  img.onload=()=>{ ctx.drawImage(img,0,0,c.width,c.height); loop(); };
  img.onerror=()=>setTimeout(loop,500);
  img.src='/frame.jpg?train='+training+'&t='+Date.now();
  const s=await (await fetch('/state')).json();
  document.getElementById('nkeys').textContent=s.n_keyframes;
  document.getElementById('hud').textContent=
    'step '+s.step+'  loss '+(s.loss||0).toFixed(5)+
    '  '+(s.frame_ms||0).toFixed(0)+' ms/frame  [t] train='+training+
    (s.playing?'  [path playback]':'');
}
loop();
</script></body></html>"""


class ViewerState:
    def __init__(self, center=(0.5, 0.5, 0.5), radius=1.6):
        self.yaw = 0.0
        self.pitch = 0.3
        self.radius = radius
        self.fov = 50.0
        self.center = np.asarray(center, np.float32)
        self.last = {}

    def xform(self) -> np.ndarray:
        """Orbit camera → (3, 4) camera-to-world (NGP convention: x right,
        y down, z forward, like the dataset loaders produce)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        eye = self.center + self.radius * np.asarray(
            [cy * cp, sy * cp, sp], np.float32
        )
        f = self.center - eye
        f /= np.linalg.norm(f)
        up = np.asarray([0.0, 0.0, 1.0], np.float32)
        r = np.cross(f, up)
        n = np.linalg.norm(r)
        r = r / n if n > 1e-6 else np.asarray([1.0, 0.0, 0.0], np.float32)
        d = np.cross(f, r)
        m = np.zeros((3, 4), np.float32)
        m[:, 0], m[:, 1], m[:, 2], m[:, 3] = r, d, f, eye
        return m


def make_server(testbed, host: str = "127.0.0.1", port: int = 8080,
                n_train_steps: int = 8) -> HTTPServer:
    """Build (not start) the HTTP server; ``serve_forever()`` to run, or
    use :func:`serve` for the blocking CLI path."""
    cam = ViewerState()
    lock = threading.Lock()

    # camera-path editor state (src/testbed.cu:1019-1147 counterpart):
    # keyframes in the reference's CameraKeyframe parametrization, playback
    # advances a normalized t each frame.
    from ngp_tpu.utils.camera_path import CameraKeyframe, CameraPath

    path = CameraPath()
    play = {"on": False, "t": 0.0, "dt": 1.0 / 120.0}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
                return
            if u.path == "/state":
                m = getattr(testbed.engine, "meters", None)
                fm = getattr(testbed, "_frame_meters", None)
                try:
                    box = testbed.render_aabb  # nerf mode only
                except Exception:  # noqa: BLE001
                    box = None
                body = json.dumps({
                    "step": testbed.training_step,
                    "loss": None if testbed.loss != testbed.loss else testbed.loss,
                    "loss_ema": m.loss_ema if m else None,
                    "frame_ms": fm["frame_ms"].value if fm else None,
                    "camera": {"yaw": cam.yaw, "pitch": cam.pitch,
                               "radius": cam.radius, "fov": cam.fov},
                    "crop": None if box is None else
                        [np.asarray(box[0]).tolist(),
                         np.asarray(box[1]).tolist()],
                    "n_keyframes": len(path.keyframes),
                    "playing": play["on"],
                }).encode()
                self._send(200, body, "application/json")
                return
            if u.path == "/histograms":
                # per-level hash-table weight histograms (the reference
                # GUI's encoding panel, src/testbed.cu:1932)
                try:
                    enc = testbed.engine.network.pos_encoding
                    params = testbed.engine.inference_params(testbed.state)
                    counts, means = enc.level_histograms(
                        params["model"]["pos_encoding"], n_bins=32
                    )
                    levels = np.asarray(counts).tolist()
                    means = np.asarray(means).tolist()
                    self._send(200, json.dumps(
                        {"levels": levels, "mean_abs_w": means}
                    ).encode(), "application/json")
                except Exception as e:  # noqa: BLE001
                    self._send(200, json.dumps(
                        {"levels": [], "error": repr(e)[:120]}
                    ).encode(), "application/json")
                return
            if u.path == "/path.json":
                import tempfile

                with tempfile.NamedTemporaryFile(
                    mode="r", suffix=".json", delete=False
                ) as f:
                    tmp = f.name
                try:
                    path.save(tmp)
                    with open(tmp) as f:
                        body = f.read().encode()
                finally:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                self._send(200, body, "application/json")
                return
            if u.path == "/frame.jpg":
                q = parse_qs(u.query)
                w = int(q.get("w", ["512"])[0])
                h = int(q.get("h", ["512"])[0])
                train = q.get("train", ["1"])[0] == "1"
                with lock:
                    testbed.shall_train = train
                    cm = cam.xform()
                    if play["on"] and len(path.keyframes) >= 2:
                        kf = path.eval_camera_path(play["t"])
                        cm = np.asarray(kf.matrix(), np.float32)
                        play["t"] += play["dt"]
                        if play["t"] >= 1.0:
                            play["t"] = 0.0
                    out = testbed.frame(
                        width=w, height=h,
                        n_train_steps=n_train_steps if train else 0,
                        camera_matrix=cm, fov_deg=cam.fov,
                    )
                    cam.last = {
                        "resolution": out["resolution"],
                        "frame_ms": out["frame_ms"],
                    }
                img = np.asarray(out["image"])
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=90)
                self._send(200, buf.getvalue(), "image/jpeg")
                return
            self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path == "/camera":
                n = int(self.headers.get("Content-Length", "0"))
                upd = json.loads(self.rfile.read(n) or b"{}")
                for k in ("yaw", "pitch", "radius", "fov"):
                    if k in upd:
                        setattr(cam, k, float(upd[k]))
                self._send(200, b"{}", "application/json")
                return
            if self.path == "/crop":
                n = int(self.headers.get("Content-Length", "0"))
                upd = json.loads(self.rfile.read(n) or b"{}")
                with lock:  # nerf mode only; other modes 404 like the GUI
                    if getattr(testbed, "mode", None) != "nerf":
                        self._send(404, b"nerf mode only", "text/plain")
                        return
                    testbed.render_aabb = (
                        np.asarray(upd["min"], np.float32),
                        np.asarray(upd["max"], np.float32),
                    )
                self._send(200, b"{}", "application/json")
                return
            if self.path == "/path":
                n = int(self.headers.get("Content-Length", "0"))
                upd = json.loads(self.rfile.read(n) or b"{}")
                op = upd.get("op")
                if op == "add":
                    path.keyframes.append(CameraKeyframe.from_matrix(
                        cam.xform(), fov=cam.fov))
                elif op == "clear":
                    path.keyframes.clear()
                    play["on"] = False
                elif op == "play":
                    play["on"] = True
                    play["t"] = 0.0
                elif op == "stop":
                    play["on"] = False
                self._send(200, json.dumps(
                    {"n_keyframes": len(path.keyframes), "playing": play["on"]}
                ).encode(), "application/json")
                return
            self._send(404, b"not found", "text/plain")

    srv = HTTPServer((host, port), Handler)
    srv.viewer_camera = cam  # exposed for tests/tools
    return srv


def serve(testbed, host: str = "127.0.0.1", port: int = 8080, **kw) -> None:
    srv = make_server(testbed, host, port, **kw)
    print(f"ngp_tpu viewer on http://{host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
