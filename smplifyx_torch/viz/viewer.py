"""Interactive 3D results viewer: a self-contained WebGL HTML page.

Counterpart of `smplifyx_tpu/viz/viewer.py`.  The reference ships an
interactive pyrender window (mesh_viewer.py:26-97, a live-updating viewer
thread) and two mesh browsers (render_results.py, render_pkl.py).  Fits
run headless on a remote card, so the equivalent here is an exported
viewer: one HTML file (no external JS, no network) that embeds every
fitted mesh and draws it with WebGL: orbit, zoom, pan, smooth shading, a
wireframe toggle, and stepping or playback through the result set.  The
meshes are built from the result pickles by the port's forward, in
batches of at most `FORWARD_CHUNK` lanes on the card (`--platform cpu`
on a host without one).  `--live` serves the page over HTTP and reloads
it whenever the results tree changes (pair with viz/live.py::stream_fit).

    python -m smplifyx_torch.viz.viewer --results out/results --out view.html \
        [--stages] [--model_folder models --gender neutral | --synthetic_model] \
        [--platform cpu]
    python -m smplifyx_torch.viz.viewer --results out/results --live [--port 8008]
"""

from __future__ import annotations

import argparse
import base64
import glob
import hashlib
import json
import os
import os.path as osp
import pickle

import numpy as np
import torch

from smplifyx_torch.models.forward import smplx_forward
from smplifyx_torch.utils.device import (
    device_for_platform,
    full_f32_matmuls,
    resolve_device,
)
from smplifyx_torch.utils.io import load_result_pickle
from smplifyx_torch.viz.render import params_of_records

# Lanes per forward when the viewer builds its meshes.
FORWARD_CHUNK = 256

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 html,body{{margin:0;height:100%;background:#14171c;color:#cfd6e1;
   font:13px/1.4 system-ui,sans-serif;overflow:hidden}}
 #c{{display:block;width:100vw;height:100vh}}
 #hud{{position:fixed;top:10px;left:12px;user-select:none}}
 #hud b{{color:#fff}}
 #help{{position:fixed;bottom:10px;left:12px;opacity:.65}}
 button{{background:#2a3140;color:#cfd6e1;border:1px solid #3c475c;
   border-radius:4px;margin-right:4px;cursor:pointer}}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b id="name"></b> <span id="idx"></span><br>
 <button id="prev">&#9664;</button><button id="play">&#9654;</button>
 <button id="next">&#9654;&#9654;</button>
 <button id="wire">wireframe</button><button id="spin">spin</button></div>
<div id="help">drag: orbit &middot; wheel: zoom &middot; right-drag /
 shift-drag: pan &middot; &larr;/&rarr;: frame &middot; space: play</div>
<script>
const MESHES = {meshes_json};
function decode(b64, T) {{
  const s = atob(b64), a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return new T(a.buffer);
}}
for (const m of MESHES) {{
  m.v = decode(m.v, Float32Array);
  m.f = decode(m.f, Uint32Array);
}}
// --- per-mesh smooth vertex normals (area-weighted) ---
function normals(v, f) {{
  const n = new Float32Array(v.length);
  for (let t = 0; t < f.length; t += 3) {{
    const a = 3*f[t], b = 3*f[t+1], c = 3*f[t+2];
    const ux = v[b]-v[a], uy = v[b+1]-v[a+1], uz = v[b+2]-v[a+2];
    const wx = v[c]-v[a], wy = v[c+1]-v[a+1], wz = v[c+2]-v[a+2];
    const nx = uy*wz-uz*wy, ny = uz*wx-ux*wz, nz = ux*wy-uy*wx;
    n[a]+=nx; n[a+1]+=ny; n[a+2]+=nz; n[b]+=nx; n[b+1]+=ny; n[b+2]+=nz;
    n[c]+=nx; n[c+1]+=ny; n[c+2]+=nz;
  }}
  for (let i = 0; i < n.length; i += 3) {{
    const l = Math.hypot(n[i], n[i+1], n[i+2]) || 1;
    n[i]/=l; n[i+1]/=l; n[i+2]/=l;
  }}
  return n;
}}
// --- tiny mat4 helpers (column-major) ---
const M = {{
  mul(a,b){{const o=new Float32Array(16);
    for(let c=0;c<4;c++)for(let r=0;r<4;r++){{let s=0;
      for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}}return o;}},
  persp(fov,asp,n,f){{const t=1/Math.tan(fov/2);return new Float32Array(
    [t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1, 0,0,2*f*n/(n-f),0]);}},
  ident(){{return new Float32Array([1,0,0,0,0,1,0,0,0,0,1,0,0,0,0,1]);}},
}};
const cv = document.getElementById('c');
const gl = cv.getContext('webgl');
gl.getExtension('OES_element_index_uint');
const VS = `attribute vec3 p; attribute vec3 n; uniform mat4 mvp, mv;
 varying vec3 vn; varying vec3 vp;
 void main(){{ gl_Position = mvp*vec4(p,1.0);
   vn = mat3(mv[0].xyz, mv[1].xyz, mv[2].xyz)*n;
   vp = (mv*vec4(p,1.0)).xyz; }}`;
const FS = `precision mediump float; varying vec3 vn; varying vec3 vp;
 uniform vec3 col;
 void main(){{ vec3 N = normalize(vn);
   if (!gl_FrontFacing) N = -N;
   vec3 L1 = normalize(vec3(0.4, 0.7, 0.6));
   vec3 L2 = normalize(vec3(-0.6, -0.2, 0.4));
   float d = 0.75*max(dot(N,L1),0.0)+0.35*max(dot(N,L2),0.0)+0.18;
   vec3 V = normalize(-vp);
   float s = pow(max(dot(normalize(L1+V), N), 0.0), 32.0)*0.25;
   gl_FragColor = vec4(col*d + vec3(s), 1.0); }}`;
function shader(type, src) {{
  const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const loc = {{p: gl.getAttribLocation(prog,'p'),
  n: gl.getAttribLocation(prog,'n'),
  mvp: gl.getUniformLocation(prog,'mvp'),
  mv: gl.getUniformLocation(prog,'mv'),
  col: gl.getUniformLocation(prog,'col')}};
gl.enableVertexAttribArray(loc.p); gl.enableVertexAttribArray(loc.n);
gl.enable(gl.DEPTH_TEST);

// --- upload buffers per mesh, compute global center/scale ---
let cx=0, cy=0, cz=0, rad=1e-6, nv=0;
for (const m of MESHES) {{
  for (let i = 0; i < m.v.length; i += 3)
    {{ cx+=m.v[i]; cy+=m.v[i+1]; cz+=m.v[i+2]; }}
  nv += m.v.length/3;
}}
cx/=nv; cy/=nv; cz/=nv;
for (const m of MESHES)
  for (let i = 0; i < m.v.length; i += 3)
    rad = Math.max(rad, Math.hypot(m.v[i]-cx, m.v[i+1]-cy, m.v[i+2]-cz));
for (const m of MESHES) {{
  m.vb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, m.vb);
  gl.bufferData(gl.ARRAY_BUFFER, m.v, gl.STATIC_DRAW);
  m.nb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, m.nb);
  gl.bufferData(gl.ARRAY_BUFFER, normals(m.v, m.f), gl.STATIC_DRAW);
  m.ib = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, m.ib);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, m.f, gl.STATIC_DRAW);
  // wireframe edge index buffer (unique undirected edges)
  const es = new Set();
  for (let t = 0; t < m.f.length; t += 3)
    for (const [a,b] of [[m.f[t],m.f[t+1]],[m.f[t+1],m.f[t+2]],
                         [m.f[t+2],m.f[t]]])
      es.add(a < b ? a*4294967296+b : b*4294967296+a);
  const ed = new Uint32Array(es.size*2); let k = 0;
  for (const e of es) {{ ed[k++] = Math.floor(e/4294967296);
                         ed[k++] = e%4294967296; }}
  m.eb = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, m.eb);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, ed, gl.STATIC_DRAW);
  m.ne = ed.length;
}}

// --- state & interaction ---
let cur = 0, yaw = 0.6, pitch = 0.15, dist = 2.6*rad,
    panx = 0, pany = 0, wire = false, playing = false, spinning = false;
const el = s => document.getElementById(s);
function setMesh(i) {{
  cur = (i + MESHES.length) % MESHES.length;
  el('name').textContent = MESHES[cur].name;
  el('idx').textContent = (cur+1)+' / '+MESHES.length;
}}
let drag = null;
cv.addEventListener('mousedown', e => {{
  drag = {{x: e.clientX, y: e.clientY, pan: e.button === 2 || e.shiftKey}};
}});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {{
  if (!drag) return;
  const dx = e.clientX-drag.x, dy = e.clientY-drag.y;
  if (drag.pan) {{ panx += dx*0.0012*dist; pany -= dy*0.0012*dist; }}
  else {{ yaw += dx*0.008;
    pitch = Math.max(-1.5, Math.min(1.5, pitch+dy*0.008)); }}
  drag.x = e.clientX; drag.y = e.clientY;
}});
cv.addEventListener('wheel', e => {{
  e.preventDefault();
  dist *= Math.exp(e.deltaY*0.001);
  dist = Math.max(0.2*rad, Math.min(20*rad, dist));
}}, {{passive: false}});
cv.addEventListener('contextmenu', e => e.preventDefault());
el('prev').onclick = () => setMesh(cur-1);
el('next').onclick = () => setMesh(cur+1);
el('wire').onclick = () => wire = !wire;
el('spin').onclick = () => spinning = !spinning;
el('play').onclick = () => playing = !playing;
window.addEventListener('keydown', e => {{
  if (e.key === 'ArrowLeft') setMesh(cur-1);
  if (e.key === 'ArrowRight') setMesh(cur+1);
  if (e.key === ' ') {{ playing = !playing; e.preventDefault(); }}
  if (e.key === 'w') wire = !wire;
}});
setMesh(0);

let lastStep = 0;
function frame(t) {{
  if (playing && t-lastStep > 400) {{ setMesh(cur+1); lastStep = t; }}
  if (spinning) yaw += 0.006;
  const w = cv.clientWidth, h = cv.clientHeight;
  if (cv.width !== w || cv.height !== h) {{ cv.width = w; cv.height = h; }}
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.078, 0.09, 0.11, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const m = MESHES[cur];
  // model-view: center -> yaw/pitch orbit -> pull back, + pan
  const cyw = Math.cos(yaw), syw = Math.sin(yaw),
        cp = Math.cos(pitch), sp = Math.sin(pitch);
  const R = new Float32Array([
    cyw, sp*syw, -cp*syw, 0,
    0, cp, sp, 0,
    syw, -sp*cyw, cp*cyw, 0,
    0, 0, 0, 1]);
  const T1 = M.ident(); T1[12] = -cx; T1[13] = -cy; T1[14] = -cz;
  const T2 = M.ident(); T2[12] = panx; T2[13] = pany; T2[14] = -dist;
  const mv = M.mul(T2, M.mul(R, T1));
  const mvp = M.mul(M.persp(0.7, w/h, 0.01*rad, 100*rad), mv);
  gl.uniformMatrix4fv(loc.mvp, false, mvp);
  gl.uniformMatrix4fv(loc.mv, false, mv);
  gl.bindBuffer(gl.ARRAY_BUFFER, m.vb);
  gl.vertexAttribPointer(loc.p, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, m.nb);
  gl.vertexAttribPointer(loc.n, 3, gl.FLOAT, false, 0, 0);
  if (wire) {{
    gl.uniform3f(loc.col, 0.45, 0.75, 0.95);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, m.eb);
    gl.drawElements(gl.LINES, m.ne, gl.UNSIGNED_INT, 0);
  }} else {{
    gl.uniform3f(loc.col, 0.62, 0.65, 0.75);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, m.ib);
    gl.drawElements(gl.TRIANGLES, m.f.length, gl.UNSIGNED_INT, 0);
  }}
  requestAnimationFrame(frame);
}}
requestAnimationFrame(frame);
{live_js}
</script></body></html>
"""

# Injected into the page only by the --live server: persists the camera /
# display state across reloads, follows the newest mesh as stages stream
# in, and polls /version — any change to the results tree reloads the page
# with the state restored (the refresh loop of the reference's live
# MeshViewer, mesh_viewer.py:82-97, as a zero-dependency web page).
_LIVE_JS = """
const LIVE_VER = %(ver)r;
try {
  const s = JSON.parse(localStorage.getItem('sxtpu_view') || 'null');
  if (s) {
    yaw = s.yaw; pitch = s.pitch; dist = s.dist;
    panx = s.panx; pany = s.pany; wire = s.wire;
    // a grown mesh list means new stages landed: jump to the newest
    setMesh(MESHES.length > (s.count || 0) ? MESHES.length - 1 : s.cur);
  }
} catch (e) {}
setInterval(() => {
  localStorage.setItem('sxtpu_view', JSON.stringify(
    {yaw, pitch, dist, panx, pany, wire, cur, count: MESHES.length}));
}, 500);
setInterval(async () => {
  try {
    const r = await fetch('/version');
    const j = await r.json();
    if (j.ver !== LIVE_VER) location.reload();
  } catch (e) {}
}, %(poll_ms)d);
"""

_WAITING_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%(title)s</title></head>
<body style="background:#14171c;color:#cfd6e1;font:14px system-ui">
<p style="margin:40vh auto;text-align:center">waiting for the first
result pickle under the watched directory&hellip;</p>
<script>
setInterval(async () => {
  try {
    const r = await fetch('/version');
    const j = await r.json();
    if (j.ver !== %(ver)r) location.reload();
  } catch (e) {}
}, %(poll_ms)d);
</script></body></html>
"""


def _b64(arr: np.ndarray, dtype) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype).tobytes()
    ).decode("ascii")


def export_viewer_html(
    meshes,
    out_path: str,
    title: str = "smplifyx_torch results",
) -> str:
    """Write a standalone interactive viewer.

    meshes: iterable of dicts {"name": str, "vertices": [V,3] float,
    "faces": [F,3] int}.  Returns out_path.
    """
    payload = [
        {
            "name": str(m["name"]),
            "v": _b64(m["vertices"], np.float32),
            "f": _b64(m["faces"], np.uint32),
        }
        for m in meshes
    ]
    if not payload:
        raise ValueError("export_viewer_html: no meshes")
    html = _PAGE.format(title=title, meshes_json=json.dumps(payload),
                        live_js="")
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def _result_pickles(results_dir: str) -> list[str]:
    return sorted(glob.glob(osp.join(results_dir, "**/*.pkl"),
                            recursive=True))


def results_fingerprint(results_dir: str) -> str:
    """Change token of the results tree: path, mtime and size of every
    result pickle (what /version serves; any write changes it)."""
    parts = []
    for pkl in _result_pickles(results_dir):
        try:
            st = os.stat(pkl)
        except OSError:
            continue
        parts.append(f"{pkl}:{st.st_mtime_ns}:{st.st_size}")
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()[:16]


def collect_meshes(results_dir: str, model, include_stages: bool) -> list:
    """Every result pickle (and, with include_stages, each of its "stages"
    snapshots) as a viewer mesh dict; the forwards run on the model's
    device, at most FORWARD_CHUNK lanes at a time."""
    names, records = [], []
    for pkl in _result_pickles(results_dir):
        try:
            d = load_result_pickle(pkl)
        except (EOFError, pickle.UnpicklingError):
            continue  # a pickle being written: the next poll reads it
        name = osp.basename(osp.dirname(pkl))
        stages = d.get("stages") if include_stages else None
        for s, st in enumerate(stages or ()):
            names.append(f"{name}/stage{s:02d}")
            records.append(st)
        names.append(f"{name}/final" if stages else name)
        records.append(d)
    full_f32_matmuls()
    faces = model.faces.cpu().numpy()
    meshes = []
    for lo in range(0, len(records), FORWARD_CHUNK):
        params = params_of_records(records[lo:lo + FORWARD_CHUNK], model)
        with torch.no_grad():
            verts = smplx_forward(model, params).vertices.cpu().numpy()
        meshes += [{"name": n, "vertices": v, "faces": faces}
                   for n, v in zip(names[lo:lo + FORWARD_CHUNK], verts)]
    return meshes


def serve_live_viewer(results_dir: str, model, port: int = 0,
                      title: str = "smplifyx_torch live",
                      include_stages: bool = True, poll_ms: int = 750):
    """HTTP server showing the results tree as a live WebGL viewer.

    GET /         -> the viewer page built from the tree as of this
                     request, plus a script that reloads it (camera state
                     kept, newest mesh followed) when /version changes,
                     i.e. whenever a fit writes or updates a pickle (the
                     reference's MeshViewer thread, mesh_viewer.py:82-97).
    GET /version  -> {"ver": <fingerprint>} of the current tree.

    Returns the ThreadingHTTPServer, not started: call serve_forever()
    (the CLI does) or run it on a thread (tests do).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def render_page() -> str:
        ver = results_fingerprint(results_dir)
        meshes = collect_meshes(results_dir, model, include_stages)
        if not meshes:
            return _WAITING_PAGE % {
                "title": title, "ver": ver, "poll_ms": poll_ms}
        payload = [{"name": str(m["name"]),
                    "v": _b64(m["vertices"], np.float32),
                    "f": _b64(m["faces"], np.uint32)} for m in meshes]
        return _PAGE.format(
            title=title, meshes_json=json.dumps(payload),
            live_js=_LIVE_JS % {"ver": ver, "poll_ms": poll_ms})

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/version":
                body = json.dumps(
                    {"ver": results_fingerprint(results_dir)}).encode()
                ctype = "application/json"
            elif path in ("/", "/index.html"):
                body = render_page().encode()
                ctype = "text/html; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def load_viewer_model(args, device):
    """The body model a viewer CLI forwards with: synthetic, or
    {model_folder}/smplx/SMPLX_{GENDER}.npz."""
    from smplifyx_torch.models.bodymodel import load_body_model, synthetic_model

    if args.synthetic_model:
        return synthetic_model(num_verts=args.synthetic_num_verts,
                               device=device)
    return load_body_model(osp.join(
        args.model_folder, "smplx", f"SMPLX_{args.gender.upper()}.npz"),
        "smplx", device=device)


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_folder", default="models")
    p.add_argument("--gender", default="neutral")
    p.add_argument("--synthetic_model", action="store_true")
    p.add_argument("--synthetic_num_verts", type=int, default=10475)
    p.add_argument("--platform", default=None,
                   help="gpu (the default) or cpu")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results", required=True,
                   help="results tree containing <frame>/000.pkl")
    p.add_argument("--out", help="output .html path (static export mode)")
    add_model_args(p)
    p.add_argument("--stages", action="store_true",
                   help="add one mesh per optimisation stage from the "
                        "pickle's 'stages' snapshots (written when the fit "
                        "ran with visualize): scrub the fit like the "
                        "reference's live MeshViewer (mesh_viewer.py:82-97)")
    p.add_argument("--live", action="store_true",
                   help="serve the viewer over HTTP and refresh it whenever "
                        "the results tree changes: watch a running fit "
                        "stage by stage (viz/live.py::stream_fit); stage "
                        "snapshots always included, as with --stages")
    p.add_argument("--port", type=int, default=8008,
                   help="--live listen port (0 = ephemeral)")
    p.add_argument("--poll_ms", type=int, default=750,
                   help="--live change-poll interval")
    args = p.parse_args(argv)
    if not args.live and not args.out:
        p.error("--out is required unless --live")

    model = load_viewer_model(
        args, resolve_device(device_for_platform(args.platform)))
    if args.live:
        server = serve_live_viewer(args.results, model, port=args.port,
                                   poll_ms=args.poll_ms)
        host, port = server.server_address[:2]
        print(f"live viewer: http://{host}:{port}/  (watching "
              f"{args.results}; Ctrl-C to stop)", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return

    # The vertices as fitted: the reference viewer's 180-degree turn about
    # x to stand the body up happens in the orbit, not in the data.
    meshes = collect_meshes(args.results, model, include_stages=args.stages)
    if not meshes:
        raise FileNotFoundError(f"no result pickles under {args.results}")
    print(export_viewer_html(meshes, args.out))


if __name__ == "__main__":
    main()
