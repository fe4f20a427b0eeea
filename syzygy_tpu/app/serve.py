"""Interactive browser viewer: the live-editing editor loop over HTTP.

The reference is a windowed real-time editor — GLFW input drives a fly
camera (``editor/editor.cpp:441-779``) and every scene parameter is
live-editable with per-row reset through ImGui property tables
(``ui/propertytable.hpp:28-226``, ``ui/statelesswidgets.cpp:165-377``).
BASELINE scopes windowing/ImGui out, so this module provides the
headless-native equivalent: ``python -m syzygy_tpu.app --serve`` starts a
localhost HTTP server whose single page shows the rendered frame, takes
WASDQE + drag fly-camera input (``InputHandler``-exact: the same
``scene.handle_input`` path as ``--input-script``), and renders the full
reflection-discovered property table (``app/properties.py``) with live
edit + reset-to-default per row — the PropertyTable's 3 columns.

Every interaction re-renders through the same jitted frame stages as the
batch app; frame pacing is whatever the backend delivers (interpret-mode
CPU is seconds/frame — the point is interactive *editing* parity, not
interactive *rate*, which BENCHMARKS tracks separately).

No third-party dependencies: stdlib ``http.server`` + a self-contained
HTML page; PNG encoding via ``utils.write_png``'s encoder.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

log = logging.getLogger("syzygy")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>syzygy_tpu</title>
<style>
 body { background:#14161a; color:#cfd3da; font:13px monospace; margin:0;
        display:flex; height:100vh; }
 #view { flex:1; display:flex; flex-direction:column; align-items:center;
         justify-content:center; }
 #frame { image-rendering:pixelated; width:68vw; max-width:96%;
          border:1px solid #333; cursor:crosshair; }
 #hud { padding:6px; color:#8a8f98; }
 #panel { width:420px; overflow-y:auto; background:#1a1d22; padding:8px;
          border-left:1px solid #333; }
 table { border-collapse:collapse; width:100%; }
 td { padding:2px 4px; border-bottom:1px solid #24272c; }
 td.name { color:#7aa2f7; white-space:nowrap; max-width:200px;
           overflow:hidden; text-overflow:ellipsis; }
 input.val { width:140px; background:#0f1115; color:#cfd3da;
             border:1px solid #333; font:12px monospace; }
 button { background:#24272c; color:#cfd3da; border:1px solid #3a3f46;
          cursor:pointer; font:11px monospace; }
 #status { color:#9ece6a; }
</style></head><body>
<div id="view">
  <img id="frame" src="/frame.png?v=0" tabindex="0">
  <div id="hud">WASDQE move &middot; drag to look &middot;
    <span id="status">ready</span> &middot; <span id="perf"></span>
    <canvas id="spark" width="180" height="34"
      style="vertical-align:middle; border:1px solid #24272c;"
      title="FPS history (500-sample ring)"></canvas></div>
</div>
<div id="panel">
  <div id="loadbar" style="margin-bottom:6px;">
    <input id="loadpath" class="val" style="width:200px"
      placeholder="/path/to.glb, image, or default|chessboard|flagship">
    <select id="loadmode"><option value="merge">merge</option>
      <option value="replace">replace</option></select>
    <label><input id="loadsrgb" type="checkbox" checked>sRGB</label>
    <button id="loadbtn">load</button>
  </div>
  <div id="texbar">
    <select id="texsel"><option value="">(inspect texture...)</option>
    </select>
  </div>
  <img id="texview" style="display:none; max-width:100%;
       image-rendering:pixelated; border:1px solid #333; margin:4px 0;">
  <table id="props"></table>
</div>
<script>
let v = 0, busy = false, pending = false;
const frame = document.getElementById('frame');
const status = document.getElementById('status');
function refresh() {
  if (busy) { pending = true; return; }
  busy = true; status.textContent = 'rendering...';
  const img = new Image();
  img.onload = async () => { frame.src = img.src; busy = false;
    // #frame has a FIXED relative width (68vw) so preview frames and
    // config resolution changes all scale into the same display box
    // (the reference scales its viewport image to the window too)
    status.textContent = 'ready';
    try {  // performance window analog: frame ms + FPS ring report
      const s = await (await fetch('/api/stats')).json();
      document.getElementById('perf').textContent =
        s.last_ms.toFixed(0) + ' ms | fps ' + (s.fps || '-');
      drawSpark(s.fps_samples);
      // drain the 2-frames-in-flight pipeline when input stops
      if (s.pending) pending = true;
    } catch (e) {}
    if (pending) { pending = false; refresh(); } };
  img.onerror = () => { busy = false; status.textContent = 'error'; };
  img.src = '/frame.png?v=' + (++v);
}
async function post(url, body) {
  const r = await fetch(url, {method:'POST', body:JSON.stringify(body)});
  return r.json();
}
// FPS sparkline (the ImPlot performance graph, statelesswidgets.cpp:98-161)
function drawSpark(samples) {
  const c = document.getElementById('spark'), ctx = c.getContext('2d');
  ctx.clearRect(0, 0, c.width, c.height);
  if (!samples || samples.length < 2) return;
  const max = Math.max(...samples), min = Math.min(...samples);
  const span = Math.max(max - min, 1e-6);
  ctx.strokeStyle = '#9ece6a'; ctx.lineWidth = 1; ctx.beginPath();
  samples.forEach((v, i) => {
    const x = i / (samples.length - 1) * (c.width - 2) + 1;
    const y = c.height - 2 - (v - min) / span * (c.height - 4);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
}
// runtime asset loading (the reference's mid-session file dialogs)
document.getElementById('loadbtn').onclick = async () => {
  const path = document.getElementById('loadpath').value.trim();
  if (!path) return;
  status.textContent = 'loading...';
  const r = await post('/api/load', {
    path: path,
    merge: document.getElementById('loadmode').value === 'merge',
    srgb: document.getElementById('loadsrgb').checked,
  });
  if (r.error) { status.textContent = r.error; return; }
  status.textContent = 'loaded ' + JSON.stringify(r);
  loadProps(); loadTextures(); refresh();
};
// fly camera: keys + mouse drag through the InputHandler path
const keys = new Set();
addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT') return;
  const k = e.key.toLowerCase();
  if ('wasdqe'.includes(k)) { keys.add(k); e.preventDefault(); }
});
addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
setInterval(async () => {
  if (keys.size === 0) return;
  await post('/api/input', {keys: Array.from(keys).join(''), dt: 0.12});
  refresh();
}, 140);
let dragging = false, lx = 0, ly = 0;
frame.addEventListener('mousedown', e => {
  dragging = true; lx = e.clientX; ly = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', async e => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  if (Math.abs(dx) + Math.abs(dy) < 3) return;
  lx = e.clientX; ly = e.clientY;
  await post('/api/input', {cursor: [dx, dy], dt: 0.0});
  refresh();
});
// property table: name / value / reset (propertytable.hpp's 3 columns)
async function loadProps() {
  const props = await (await fetch('/api/properties')).json();
  const tbl = document.getElementById('props');
  tbl.innerHTML = '';
  for (const p of props) {
    const tr = document.createElement('tr');
    const name = document.createElement('td');
    name.className = 'name'; name.textContent = p.path; name.title = p.path;
    const val = document.createElement('td');
    const inp = document.createElement('input');
    inp.className = 'val'; inp.value = p.value;
    inp.addEventListener('keydown', async e => {
      if (e.key !== 'Enter') return;
      const r = await post('/api/set', {path: p.path, value: inp.value});
      if (r.error) { status.textContent = r.error; inp.value = p.value; }
      else { p.value = r.value; inp.value = r.value; refresh(); }
    });
    val.appendChild(inp);
    const rst = document.createElement('td');
    if (p.default !== null) {
      const b = document.createElement('button');
      b.textContent = '\\u21ba';
      b.title = 'reset to ' + p.default;
      b.onclick = async () => {
        const r = await post('/api/set', {path: p.path, value: 'default'});
        if (!r.error) { p.value = r.value; inp.value = r.value; refresh(); }
      };
      rst.appendChild(b);
    }
    tr.append(name, val, rst); tbl.appendChild(tr);
  }
}
loadProps();
// TextureDisplay analog (ui/texturedisplay.cpp:21-80): any registered
// asset, shown at native resolution in the side panel
async function loadTextures() {
  const texs = await (await fetch('/api/textures')).json();
  const sel = document.getElementById('texsel');
  sel.innerHTML = '<option value="">(inspect texture...)</option>';
  for (const t of texs) {
    const o = document.createElement('option');
    o.value = t.name; o.textContent = t.name + ' (' + t.w + 'x' + t.h + ')';
    sel.appendChild(o);
  }
  sel.onchange = () => {
    const img = document.getElementById('texview');
    if (!sel.value) { img.style.display = 'none'; return; }
    img.src = '/texture.png?name=' + encodeURIComponent(sel.value);
    img.style.display = 'block';
  };
}
loadTextures();
</script></body></html>
"""


def _png_bytes(image) -> bytes:
    """Encode an (H, W, 3) float [0,1] or uint8 image as PNG bytes."""
    from syzygy_tpu.utils.png import encode_png

    # fastest zlib level: the stream is viewed once, never stored, and
    # encode time is on the interactive critical path
    return encode_png(image, level=1)


class _State:
    """Render state shared across requests; one lock serializes renders
    and scene mutation (the editor loop is single-threaded too)."""

    def __init__(
        self,
        scene,
        library,
        config,
        mipmaps=False,
        dt=1.0 / 60.0,
        pipeline=False,
        preview_scale=1,
    ):
        from syzygy_tpu.runtime import place_on_accelerator
        from syzygy_tpu.scene import pack_geometry

        self.lock = threading.Lock()
        self.scene = scene
        self.library = library
        self.config = config
        self.mipmaps = mipmaps
        self.dt = dt
        self.aspect = config.width / config.height
        self._geometry_host = pack_geometry(scene, library, mipmaps=mipmaps)
        self.geometry = place_on_accelerator(self._geometry_host)
        self._frame_png = None
        self._dirty = True
        self._fps = None
        self._last_ms = 0.0
        # 2-frames-in-flight presentation (editor/framebuffer.cpp:134
        # semantics): when on, a dirty request DISPATCHES the new frame and
        # returns the previous one immediately; the next request fetches
        # the finished dispatch, so device compute overlaps host encode +
        # client RTT at the cost of one frame of latency. stats() reports
        # pipeline_pending so the page can drain when input stops.
        self.pipeline = pipeline
        self._pending = None
        # Progressive preview (resolution-scaling analog, presentation
        # only): while input keeps the scene dirty, frames render at
        # 1/preview_scale resolution (~1/s^2 of the per-pixel work and
        # fetch bytes); when input stops, one full-resolution frame
        # renders and replaces the preview — the resting image is the
        # EXACT full config's frame. 1 disables. Both programs compile
        # once (persistent cache).
        self.preview_scale = max(1, int(preview_scale))
        self._preview_config = None
        self._needs_full = False
        self._rebuild_preview()

    def _rebuild_preview(self):
        """(Re)derive the preview config from the current full config —
        must re-run whenever self.config changes (set_config). Dims divide
        by ONE scale (aspect preserved to integer rounding — independent
        floors distorted the preview); sky_row_chunks resets to auto (a
        manual override validated for the FULL height may not divide the
        preview's); a preview that would not shrink is disabled (no point
        rendering every input frame twice)."""
        import dataclasses

        self._preview_config = None
        if self.preview_scale > 1:
            pw = max(1, self.config.width // self.preview_scale)
            ph = max(1, self.config.height // self.preview_scale)
            if (pw, ph) != (self.config.width, self.config.height):
                self._preview_config = dataclasses.replace(
                    self.config, width=pw, height=ph, sky_row_chunks=0,
                )

    def _dispatch(self, cfg):
        """Async-dispatch one frame of the current scene at ``cfg``."""
        from syzygy_tpu.renderer import render_frame_packed
        from syzygy_tpu.scene import (
            flatten_frame_params,
            frame_param_spec,
            pack_frame_params,
        )

        params = pack_frame_params(self.scene, self.aspect)
        spec = frame_param_spec(params)
        flat = flatten_frame_params(
            params, spec, np.empty(spec.total, np.float32)
        )
        return render_frame_packed(self.geometry, flat, spec, cfg)

    def render_png(self) -> bytes:
        import time

        with self.lock:
            if (
                not self._dirty
                and not self._needs_full
                and self._frame_png is not None
                and self._pending is None
            ):
                return self._frame_png
            from syzygy_tpu.runtime import fetch_frame_u8

            t0 = time.perf_counter()
            fut = None
            if self._dirty or (
                self._frame_png is None and self._pending is None
            ):
                # interactive update: render at preview resolution while
                # input is live (never for the very first frame, so the
                # page sizes itself from a full-res frame)
                preview = (
                    self._preview_config is not None
                    and self._dirty
                    and self._frame_png is not None
                )
                # async dispatch: returns before the device finishes
                fut = self._dispatch(
                    self._preview_config if preview else self.config
                )
                self._dirty = False
                self._needs_full = preview
            elif self._needs_full and self._pending is None:
                # input stopped: refine — one exact full-resolution frame
                fut = self._dispatch(self.config)
                self._needs_full = False
            if self._pending is not None:
                # fetch the frame dispatched on the PREVIOUS request (it
                # computed while the host encoded/served that response)
                pend, self._pending = self._pending, None
                try:
                    image = fetch_frame_u8(pend)
                except Exception:
                    # a faulted program surfaces here; drop both frames
                    # and mark dirty so
                    # the next request re-dispatches instead of
                    # refetching the crashed value forever
                    self._dirty = True
                    raise
                self._pending = fut
            elif fut is not None and self.pipeline and self._frame_png:
                # start the pipeline: leave the dispatch in flight and
                # answer with the previous frame (one frame of latency).
                # NOT a frame time — recording the dispatch-only ms here
                # wrote one inflated FPS sample per pipeline resume.
                self._pending = fut
                return self._frame_png
            else:
                # cold first frame (or pipelining off): synchronous;
                # u8 quantization happens on device (a quarter of the f32
                # fetch's bytes).
                image = fetch_frame_u8(fut)
            self._note_frame_time(t0)
            self._frame_png = _png_bytes(image)
            return self._frame_png

    def _note_frame_time(self, t0) -> None:
        import time

        self._last_ms = (time.perf_counter() - t0) * 1e3
        if self._fps is not None:  # first render includes the compile
            self._fps.write(1e3 / max(self._last_ms, 1e-6))
        else:
            from syzygy_tpu.utils import RingBuffer

            self._fps = RingBuffer()

    def stats(self):
        """Performance-window analog (ui/statelesswidgets.cpp:98-161): the
        FPS ring report + per-pipeline Draw Results counters."""
        from syzygy_tpu.renderer.stats import frame_draw_stats
        from syzygy_tpu.scene import pack_frame_params

        with self.lock:
            params = pack_frame_params(self.scene, self.aspect)
            draw = {
                name: str(stat)
                for name, stat in frame_draw_stats(
                    params, self._geometry_host, self.config
                ).items()
            }
            return {
                "last_ms": self._last_ms,
                "fps": None if self._fps is None else self._fps.report(),
                # the 500-sample ring, oldest-to-newest, for the HUD
                # sparkline (ImPlot performance graph analog)
                "fps_samples": (
                    [] if self._fps is None else self._fps.history()
                ),
                "draw_results": draw,
                # a dispatched frame is still in flight (or a full-res
                # refinement is owed after preview frames); one more
                # /frame.png request drains it (page auto-refreshes)
                "pending": self._pending is not None or self._needs_full,
            }

    def handle_input(self, keys: str, cursor, dt: float):
        with self.lock:
            self.scene.handle_input(
                dt if dt > 0.0 else self.dt,
                cursor_delta=tuple(cursor),
                keys=frozenset(keys),
            )
            if dt > 0.0:
                self.scene.tick(dt)
            self._dirty = True

    def set_config(self, name: str, value):
        """Live RenderConfig editing — the reflection-driven pipeline
        push-constant editor (``ui/pipelineui.cpp:43-424``: the reference
        edits shader push constants through reflected member types; our
        pipeline parameters are the RenderConfig dataclass fields).
        Changing one swaps in a new static config: the next frame
        recompiles (amortized across sessions by the persistent
        compilation cache) with identical semantics otherwise."""
        from syzygy_tpu.app.properties import apply_config_field

        with self.lock:
            # apply_config_field validates FULLY before anything installs:
            # a bad value must leave the running config untouched
            # (previously height=0 was assigned before the aspect division
            # raised, bricking every later frame until a manual reset)
            new = apply_config_field(self.config, name, value)
            aspect = new.width / new.height
            self.config = new
            self.aspect = aspect
            self._rebuild_preview()
            self._pending = None
            self._dirty = True
            return getattr(self.config, name)

    def set_property(self, path: str, value):
        from syzygy_tpu.app.properties import (
            canonical_path,
            get_path,
            parse_value,
            reset_path,
            set_path,
        )
        from syzygy_tpu.runtime import place_on_accelerator
        from syzygy_tpu.scene import pack_geometry

        if path.startswith("config."):
            return self.set_config(path[len("config."):], value)
        with self.lock:
            path = canonical_path(self.scene, path)
            if isinstance(value, str) and value.strip() == "default":
                reset_path(self.scene, path)
            else:
                if isinstance(value, str):
                    value = parse_value(value)
                set_path(self.scene, path, value)
            # transforms/visibility feed pack_geometry's instance tables;
            # repacking on every edit keeps the table uniformly live (the
            # default scene repacks in well under a frame's render time)
            self._geometry_host = pack_geometry(
                self.scene, self.library, mipmaps=self.mipmaps
            )
            self.geometry = place_on_accelerator(self._geometry_host)
            self._dirty = True
            return get_path(self.scene, path)

    def textures(self):
        """TextureDisplay's source list (ui/texturedisplay.cpp:21-80): every
        registered asset at its native resolution."""
        with self.lock:
            return [
                {
                    "name": name,
                    "index": self.library.lookup(name),
                    "w": int(self.library.get(self.library.lookup(name)).shape[1]),
                    "h": int(self.library.get(self.library.lookup(name)).shape[0]),
                }
                for name in self.library.names()
            ]

    def texture_png(self, name: str) -> bytes:
        with self.lock:
            idx = self.library.lookup(name)
            if idx is None:
                raise KeyError(f"no texture named {name!r}")
            img = self.library.get(idx)[..., :3]
            if self.library.is_srgb(idx):
                # color maps were sRGB-decoded at register time; re-encode
                # for display so they round-trip to source brightness (the
                # frame path applies the OETF pre-output the same way)
                from syzygy_tpu.assets.types import linear_to_srgb

                img = linear_to_srgb(img)
            return _png_bytes(img)

    def load_asset(self, path: str, srgb: bool = True, merge: bool = True):
        """Runtime asset loading (the reference's mid-session file dialogs,
        ``assets/assets.cpp:1615-1667`` + ``ui/uiwidgets.hpp:74-99``):

        * ``.glb``/``.gltf`` — load meshes + textures. ``merge=True`` adds
          the file's meshes as new instances in the CURRENT scene (the
          reference's loadMeshDialog semantics); ``merge=False`` replaces
          the whole scene (camera pose carried over).
        * image files — register as a texture with the per-file
          sRGB/linear choice (the loadImageDialog's checkbox).
        * a builtin scene name — ``default`` / ``sphere`` / ``chessboard``
          / ``flagship`` — replaces the scene like the app's ``--scene``.

        Geometry/atlas repack + device upload happen before returning; the
        next frame renders the new content.
        """
        import os

        ext = os.path.splitext(path)[1].lower()
        from syzygy_tpu.runtime import place_on_accelerator
        from syzygy_tpu.scene import pack_geometry

        from syzygy_tpu.app.scenes import BUILTIN_SCENES, builtin_scene

        with self.lock:
            if path in BUILTIN_SCENES:
                old_cam = self.scene.camera
                scene, library = builtin_scene(path)
                scene.tick(0.0)
                scene.camera.position = old_cam.position
                scene.camera.euler_angles = old_cam.euler_angles
                self.scene, self.library = scene, library
                loaded = {"scene": path}
            elif ext in (".glb", ".gltf"):
                from syzygy_tpu.assets.gltf import (
                    load_gltf_meshes,
                    load_gltf_scene,
                )

                if merge:
                    from syzygy_tpu.scene.scene import TransformHost

                    meshes, _ = load_gltf_meshes(path, self.library)
                    base = os.path.splitext(os.path.basename(path))[0]
                    for i, mesh in enumerate(meshes):
                        self.scene.add_mesh_instance(
                            mesh,
                            f"{base}_{i}",
                            [TransformHost.make((0.0, 0.0, 0.0))],
                        )
                    loaded = {"meshes": len(meshes)}
                else:
                    old_cam = self.scene.camera
                    scene, library = load_gltf_scene(path)
                    scene.camera.position = old_cam.position
                    scene.camera.euler_angles = old_cam.euler_angles
                    self.scene, self.library = scene, library
                    loaded = {"scene": os.path.basename(path)}
            else:
                from syzygy_tpu.utils.png import decode_image

                with open(path, "rb") as f:
                    img = decode_image(f.read())
                name = os.path.basename(path)
                # replace=True: reloading the same name re-reads the file
                # (texels + sRGB flag), like the reference's dialog
                self.library.register(name, img, srgb=srgb, replace=True)
                loaded = {"texture": name, "srgb": srgb}
            # metallic_reflection is a static scene property (bitwise skip
            # when provably unused) — recompute for the new content
            import dataclasses

            from syzygy_tpu.scene import scene_uses_metallic

            self.config = dataclasses.replace(
                self.config,
                metallic_reflection=scene_uses_metallic(
                    self.scene, self.library
                ),
            )
            self._rebuild_preview()
            self._geometry_host = pack_geometry(
                self.scene, self.library, mipmaps=self.mipmaps
            )
            self.geometry = place_on_accelerator(self._geometry_host)
            self._pending = None  # in-flight frames show the old content
            self._dirty = True
            return loaded

    def properties(self):
        import dataclasses

        from syzygy_tpu.app.properties import _fmt, discover

        with self.lock:
            rows = [
                {
                    "path": p.path,
                    "value": _fmt(p.value),
                    "default": None if p.default is None else _fmt(p.default),
                }
                for p in discover(self.scene)
            ]
            # pipeline parameters (pipelineui.cpp analog): every
            # RenderConfig field, reflected from the dataclass
            rows += [
                {
                    "path": f"config.{f.name}",
                    "value": _fmt(getattr(self.config, f.name)),
                    "default": _fmt(f.default),
                }
                for f in dataclasses.fields(type(self.config))
            ]
            return rows


def serve(
    scene, library, config, port=8731, mipmaps=False, frames=0,
    preview_scale=2,
):
    """Run the interactive viewer until interrupted (or after ``frames``
    rendered frames when > 0 — used by the smoke test).

    ``preview_scale``: while input is live, frames render at
    1/preview_scale resolution and refine to the exact full-resolution
    frame when input stops (1 disables)."""
    state = _State(
        scene, library, config, mipmaps=mipmaps, pipeline=True,
        preview_scale=preview_scale,
    )
    rendered = [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through syzygy logging
            log.debug("serve: " + fmt, *args)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] == "/":
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif self.path.startswith("/frame.png"):
                try:
                    png = state.render_png()
                except Exception as e:  # surface render errors, keep serving
                    log.error("render failed: %s", e)
                    self._send(500, str(e).encode(), "text/plain")
                    return
                rendered[0] += 1
                self._send(200, png, "image/png")
            elif self.path == "/api/properties":
                self._send(200, json.dumps(state.properties()).encode())
            elif self.path == "/api/stats":
                self._send(200, json.dumps(state.stats()).encode())
            elif self.path == "/api/textures":
                self._send(200, json.dumps(state.textures()).encode())
            elif self.path.startswith("/texture.png"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    png = state.texture_png(q.get("name", [""])[0])
                except KeyError as e:
                    self._send(404, str(e).encode(), "text/plain")
                    return
                self._send(200, png, "image/png")
            else:
                self._send(404, b"not found", "text/plain")

        def _origin_ok(self):
            """Reject cross-site POSTs: /api/load reaches the local
            filesystem and /api/set mutates the session, and a browser
            sends same-looking 'simple' fetch() POSTs cross-origin without
            preflight — so require a localhost Host (DNS-rebinding guard)
            and, when the browser attaches an Origin, a localhost one."""
            from urllib.parse import urlparse

            host = (self.headers.get("Host") or "").rsplit(":", 1)[0]
            if host not in ("127.0.0.1", "localhost", "[::1]"):
                return False
            origin = self.headers.get("Origin")
            if origin:
                oh = urlparse(origin).hostname
                if oh not in ("127.0.0.1", "localhost", "::1"):
                    return False
            return True

        def do_POST(self):
            if not self._origin_ok():
                self._send(403, b'{"error": "cross-origin request"}')
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send(400, b'{"error": "bad json"}')
                return
            if self.path == "/api/input":
                state.handle_input(
                    body.get("keys", ""),
                    body.get("cursor", (0.0, 0.0)),
                    float(body.get("dt", 0.0)),
                )
                self._send(200, b'{"ok": true}')
            elif self.path == "/api/set":
                try:
                    value = state.set_property(
                        body.get("path", ""), body.get("value")
                    )
                except Exception as e:
                    self._send(200, json.dumps({"error": str(e)}).encode())
                    return
                from syzygy_tpu.app.properties import _fmt

                self._send(200, json.dumps({"value": _fmt(value)}).encode())
            elif self.path == "/api/load":
                try:
                    loaded = state.load_asset(
                        body.get("path", ""),
                        srgb=bool(body.get("srgb", True)),
                        merge=bool(body.get("merge", True)),
                    )
                except Exception as e:
                    self._send(200, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps(loaded).encode())
            else:
                self._send(404, b'{"error": "not found"}')

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    log.info(
        "interactive viewer on http://127.0.0.1:%d (%dx%d, %s)",
        port, config.width, config.height, "ctrl-c to stop",
    )
    if frames > 0:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        import time

        while rendered[0] < frames:
            time.sleep(0.1)
        httpd.shutdown()
        return state
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        log.info("viewer stopped")
    return state
