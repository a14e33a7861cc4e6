"""Interactive progressive viewer served over HTTP.  Counterpart of
`tpu_pathtracer/viewer.py`.

A background thread renders progressive subframes; the browser polls the
accumulated frame as PNG (the port's own encoder, `utils/image.py`) and
posts camera events.  The render loop and the HTTP handlers share the
renderer under one lock, and both work on the renderer's device; a
request builds no device constant (a camera change uploads the new
camera's four vectors, a resize allocates the new buffer).

Controls:
  drag        orbit around the look-at point
  wheel       dolly toward/away
  shift+drag  pan in the view plane
  G           toggle depth of field
  D           toggle the denoiser
  R           reset accumulation
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from tpu_pathtracer_torch.utils import logging as plog
from tpu_pathtracer_torch.utils.image import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>tpu_pathtracer_torch</title><style>
 body{margin:0;background:#111;color:#ccc;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;border-radius:4px}
 img{display:block;width:100vw;height:100vh;object-fit:contain;image-rendering:pixelated}
</style></head><body>
<div id="hud">connecting…</div><img id="view" draggable="false">
<script>
const img=document.getElementById('view'),hud=document.getElementById('hud');
let drag=false,px=0,py=0,shift=false;
function refresh(){img.src='/frame.png?t='+Date.now();}
img.onload=()=>setTimeout(refresh,100);
img.onerror=()=>setTimeout(refresh,500);
refresh();
setInterval(async()=>{const r=await fetch('/stats');const s=await r.json();
 hud.textContent=`${s.spp} spp | ${s.ms_per_frame?.toFixed(1)??'…'} ms/frame | `+
   `${((s.paths_per_sec??0)/1e6).toFixed(2)} Mpaths/s`+
   (s.preview_scale?` | pv 1/${s.preview_scale} ${s.preview_ms?.toFixed(0)}ms`:'')+
   ` | dof:${s.dof?'on':'off'} dn:${s.denoise?'on':'off'} (G dof, D denoise, R resets)`;},500);
img.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;shift=e.shiftKey;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 fetch((shift?`/pan?dx=${-dx*0.01}&dy=${dy*0.01}`:`/orbit?dyaw=${-dx*0.4}&dpitch=${dy*0.4}`));};
window.onwheel=e=>fetch(`/zoom?f=${e.deltaY>0?1.1:0.9}`);
window.onkeydown=e=>{if(e.key==='g'||e.key==='G')fetch('/toggle_dof');
 if(e.key==='d'||e.key==='D')fetch('/toggle_denoise');
 if(e.key==='r'||e.key==='R')fetch('/reset');};
// Window resize re-renders at the new resolution (reference handleResize,
// optixSphere.cpp:250-265: reallocate + reset on every GLFW resize).
// Debounced so a drag-resize issues one reallocation, not dozens.
let rszTimer=null,rszW=0,rszH=0;
window.onresize=()=>{clearTimeout(rszTimer);rszTimer=setTimeout(()=>{
 const s=window.devicePixelRatio||1;
 const w=Math.max(8,Math.round(innerWidth*s/8)*8),
       h=Math.max(8,Math.round(innerHeight*s/8)*8);
 if(w===rszW&&h===rszH)return; rszW=w;rszH=h;
 fetch(`/resize?w=${w}&h=${h}`);},300);};
</script></body></html>"""



def serve(renderer, port: int = 8000, host: str = "127.0.0.1", block: bool = True,
          converge_ramp: bool = True):
    """Serve the interactive viewer for a ProgressiveRenderer.

    block=False returns (httpd, stop) with the server and the render loop
    running in daemon threads: `stop.set()` ends the loop and
    `httpd.shutdown()` the server.  converge_ramp=False skips the
    post-settle 1/2/4-spp ramp."""
    lock = threading.Lock()
    stop = threading.Event()
    last_move = [0.0]  # wall time of the last camera interaction

    def render_loop():
        # While the camera moved within the last 0.5 s, render low-res
        # 1-spp previews; settle back to full-res accumulation when idle.
        while not stop.is_set():
            interacting = (time.time() - last_move[0]) < 0.5
            with lock:
                if not (interacting and renderer.step_preview()):
                    if converge_ramp:
                        renderer.step_converge()
                    else:
                        renderer.step()
            time.sleep(0.001)

    worker = threading.Thread(target=render_loop, daemon=True, name="viewer-render")
    worker.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _camera(self, camera):
            last_move[0] = time.time()
            with lock:
                renderer.set_camera(camera(renderer.camera))
            self._send(200, b"ok")

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif url.path == "/frame.png":
                    with lock:
                        arr = renderer.image_u8()
                    self._send(200, encode_png(arr, level=1), "image/png")
                elif url.path == "/stats":
                    with lock:
                        st = renderer.stats()
                        st.update(dof=renderer.cfg.dof, denoise=renderer.denoise, spp=renderer.spp)
                    self._send(200, json.dumps(st).encode(), "application/json")
                elif url.path == "/orbit":
                    dyaw, dpitch = float(q.get("dyaw", 0)), float(q.get("dpitch", 0))
                    self._camera(lambda c: c.orbit(dyaw, dpitch))
                elif url.path == "/zoom":
                    f = float(q.get("f", 1.0))
                    self._camera(lambda c: c.zoom(f))
                elif url.path == "/pan":
                    dx, dy = float(q.get("dx", 0)), float(q.get("dy", 0))
                    self._camera(lambda c: c.pan(dx, dy))
                elif url.path == "/toggle_denoise":
                    # Display path only: no accumulation reset.
                    with lock:
                        renderer.denoise = not renderer.denoise
                    self._send(200, b"ok")
                elif url.path == "/toggle_dof":
                    with lock:
                        renderer.cfg = renderer.cfg.replace(dof=not renderer.cfg.dof)
                        renderer.reset()
                    self._send(200, b"ok")
                elif url.path == "/reset":
                    with lock:
                        renderer.reset()
                    self._send(200, b"ok")
                elif url.path == "/resize":
                    # A resize reallocates the accumulation and resets.
                    w = max(8, int(q.get("w", renderer.cfg.width)))
                    h = max(8, int(q.get("h", renderer.cfg.height)))
                    with lock:
                        renderer.cfg = renderer.cfg.replace(width=w, height=h)
                        renderer.accum = torch.zeros((h, w, 3), dtype=torch.float32, device=renderer.device)
                        renderer.set_camera(renderer.camera.with_aspect(w, h))
                    self._send(200, b"ok")
                else:
                    self._send(404, b"not found")
            except BrokenPipeError:
                pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    plog.info("viewer", f"serving on http://{host}:{httpd.server_address[1]}")
    if block:
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            stop.set()
            httpd.shutdown()
        return None
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    return httpd, stop
