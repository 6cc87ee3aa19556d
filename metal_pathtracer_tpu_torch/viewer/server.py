"""Live progressive viewer (``viewer/server.py`` twin): the analogue of
the reference's interactive window + UI overlay (reference: src/main.mm
event loop, src/renderer/UIOverlay.mm perf panel / live settings editor).

The "window" is a browser page served by a stdlib HTTP server, so the
renderer can run on a headless machine with a card:

- a background thread runs the progressive accumulation loop through the
  same ``Renderer`` facade the headless path uses;
- ``/frame.png`` streams the current tonemapped accumulation (in-memory
  PNG, ~30ms encode at 720p);
- ``/set?...`` edits any RenderSettings field live; radiometric changes
  reset accumulation through ``detect_radiometric_change`` exactly like
  the reference's UI edits (MetalRenderer.mm applySettings);
- ``/stats`` exposes the PerformanceStats counters the reference draws in
  its overlay (spp, samples/s, Mrays/s, reset reason log).

Orbit camera controls (drag = yaw/pitch, wheel = dolly) mirror the
reference's mouse bindings (main.mm:163-258).

Interactive camera policy (reference: MetalRenderer.mm:906-956 motion
hold + spp drop, :1646-1776 12 Hz exponential orbit smoothing):

- orbit/dolly verbs only move a *target* camera and stamp the
  interaction time; the render loop advances a smoothed camera toward
  it with ``alpha = 1 - exp(-dt * 12 Hz)`` (shortest-angle yaw wrap,
  the reference's updateCameraSmoothing);
- while motion is active (< 0.25 s since the last interaction,
  kMotionHoldSeconds) or the smoothed camera has not converged, each
  pass renders ONE spp at ``preview_scale`` x the user's renderScale —
  the reference drops samplesPerFrame to 1; the frame cost is
  resolution-bound, so the preview also drops resolution;
- when the hold expires and smoothing has converged, the final camera
  is applied at full resolution and progressive accumulation resumes
  (reset reason CAMERA).

The render loop keeps going across exceptions, so that a user's edit
cannot kill it, but it keeps the last traceback in ``last_error`` (also
under ``/stats``): a frame never comes silently from a failed pass. On the
card, ``main`` builds the kernel library before the server starts, so no
HTTP thread waits on the build.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from metal_pathtracer_tpu_torch.renderer.display import display_to_u8
from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
from metal_pathtracer_tpu_torch.utils.image_io import encode_png_u8


def _coerce(settings, key: str, raw: str):
    cur = getattr(settings, key)
    if isinstance(cur, bool):
        return raw.lower() in ("1", "true", "on", "yes")
    if isinstance(cur, int):
        return int(float(raw))
    if isinstance(cur, float):
        return float(raw)
    if isinstance(cur, tuple):
        vals = [float(v) for v in raw.split(",")]
        return tuple(vals)
    return raw


_PAGE = """<!doctype html>
<html><head><title>metal-pathtracer-tpu</title>
<style>
 body { background:#111; color:#ddd; font:13px monospace; margin:0; }
 #wrap { display:flex; }
 #img { image-rendering:auto; cursor:grab; }
 #panel { padding:10px 14px; min-width:260px; }
 body.presentation #panel { display:none; }
 #mini { display:none; position:fixed; right:8px; bottom:6px;
         color:#9c9; opacity:0.7; font:12px monospace; }
 body.presentation #mini { display:block; }
 .stat { color:#9c9; } input { width:70px; }
 h3 { margin:8px 0 4px; color:#fff; }
</style></head><body>
<div id="wrap">
 <img id="img" draggable="false">
 <div id="mini"><span id="mini_spp"></span> spp</div>
 <div id="panel">
  <h3>metal-pathtracer-tpu</h3>
  <div>scene: <span class="stat" id="scene"></span></div>
  <div>spp: <span class="stat" id="spp"></span></div>
  <div>samples/s: <span class="stat" id="sps"></span></div>
  <div>Mrays/s: <span class="stat" id="mrays"></span></div>
  <div>last reset: <span class="stat" id="reset"></span></div>
  <h3>camera</h3>
  <div>drag to orbit &middot; wheel to dolly</div>
  <h3>settings</h3>
  <div>exposure <input id="exposure" type="number" step="0.25" value="0"></div>
  <div>maxDepth <input id="maxDepth" type="number" step="1"></div>
  <div>denoise <input id="denoiseEnabled" type="checkbox"></div>
  <div>tonemap <select id="tonemapMode"><option value="1">Linear</option>
   <option value="2">ACES</option><option value="3">Reinhard</option>
   <option value="4">Hable</option></select></div>
  <div><button onclick="send('paused=toggle')">pause/resume</button>
       <button onclick="send('reset=1')">reset</button>
       <button onclick="send('presentation=toggle')">present (P)</button></div>
  <h3>material</h3>
  <div><select id="matsel"></select></div>
  <div>base <input id="m_base" style="width:110px" placeholder="r,g,b"></div>
  <div>rough <input id="m_rough" type="number" step="0.05" min="0" max="1"></div>
  <div><button onclick="applyMat()">apply</button></div>
 </div>
</div>
<script>
const img = document.getElementById('img');
let inflight = false;
async function refresh() {
  if (!inflight) {
    inflight = true;
    img.src = '/frame.png?' + Date.now();
    img.onload = img.onerror = () => { inflight = false; };
  }
  const s = await (await fetch('/stats')).json();
  for (const k of ['scene','spp','sps','mrays','reset'])
    document.getElementById(k).textContent = s[k];
  document.body.classList.toggle('presentation', !!s.presentation);
  document.getElementById('mini_spp').textContent = s.spp;
}
setInterval(refresh, 500);
function send(q) { fetch('/set?' + q, {method: 'POST'}); }
async function loadMats() {
  const ms = await (await fetch('/materials')).json();
  const sel = document.getElementById('matsel');
  sel.innerHTML = ms.map(m => `<option value="${m.index}">${m.name}</option>`).join('');
}
loadMats();
function applyMat() {
  const i = document.getElementById('matsel').value;
  const b = document.getElementById('m_base').value;
  const r = document.getElementById('m_rough').value;
  let q = `index=${i}`;
  if (b) q += `&base_color=${b}`;
  if (r) q += `&roughness=${r}`;
  fetch('/material?' + q, {method: 'POST'});
}
for (const id of ['exposure','maxDepth','tonemapMode'])
  document.getElementById(id).addEventListener('change',
    e => send(id + '=' + e.target.value));
document.getElementById('denoiseEnabled').addEventListener('change',
  e => send('denoiseEnabled=' + (e.target.checked ? 1 : 0)));
let drag = null;
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  send(`orbit=${dx * 0.01},${dy * 0.01}`);
});
window.addEventListener('keydown', e => {
  if (e.key === 'p' || e.key === 'P') send('presentation=toggle');
});
img.addEventListener('wheel', e => {
  e.preventDefault();
  send('dolly=' + (e.deltaY > 0 ? 1.1 : 0.9));
});
</script></body></html>"""


class ViewerServer:
    """Progressive render loop + HTTP endpoints over a Renderer facade."""

    def __init__(self, renderer: Renderer, host: str = "127.0.0.1",
                 port: int = 8650, spp_per_pass: int = 1,
                 preview_scale: float = 0.5, motion_hold: float = 0.25,
                 smoothing_hz: float = 12.0, presentation: bool = False,
                 presentation_lock: int = 2):
        self.renderer = renderer
        self.spp_per_pass = spp_per_pass
        # Presentation mode (reference: UIOverlay.h PresentationSettings
        # :45-77 + main.mm --presentation= :58-72): hide the UI panels,
        # keep a minimal spp overlay, optionally lock the render
        # resolution (0 off / 1 = 1280x720 / 2 = 1920x1080), and reset
        # accumulation on toggle (resetAccumulationOnToggle default true).
        self.presentation = presentation
        self.presentation_lock = presentation_lock
        self._pre_presentation_size = None
        # interactive camera policy (reference constants:
        # kMotionHoldSeconds=0.25, kCameraSmoothingCutoffHz=12)
        self.preview_scale = preview_scale
        self.motion_hold = motion_hold
        self.smoothing_hz = smoothing_hz
        self._cam_target = None      # (yaw, pitch, distance)
        self._smooth = None          # (yaw, pitch) being eased
        self._last_interaction = 0.0
        self._last_smooth_t = None
        self._preview_active = False
        self._base_scale = None      # user renderScale while previewing
        self.paused = False
        self.last_reset = ""
        self.last_error = ""         # traceback of the last failed pass
        self._lock = threading.Lock()
        self._frame_png = b""
        self._stats = {"spp": 0, "sps": 0.0, "mrays": 0.0}
        if presentation:
            self._apply_presentation(True, initial=True)
        self._stop = threading.Event()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _same_origin(self):
                # CSRF guard for state-mutating endpoints: any web page can
                # fire requests at localhost, so require the browser-set
                # Origin (sent on all cross-origin POSTs) to match the page
                # we served, or be absent (curl and same-origin fetches).
                origin = self.headers.get("Origin")
                if origin is None:
                    return True
                host = self.headers.get("Host", "")
                return origin in (f"http://{host}", f"https://{host}")

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    if url.path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif url.path == "/frame.png":
                        png = viewer.frame_png()
                        self._send(200, png, "image/png")
                    elif url.path == "/stats":
                        self._send(200, json.dumps(viewer.stats()).encode())
                    elif url.path == "/materials":
                        self._send(200,
                                   json.dumps(viewer.materials()).encode())
                    elif url.path == "/objects":
                        self._send(200,
                                   json.dumps(viewer.objects()).encode())
                    else:
                        self._send(404, b"{}")
                except BrokenPipeError:
                    pass

            def do_POST(self):
                try:
                    url = urlparse(self.path)
                    if not self._same_origin():
                        self._send(403, b"{}")
                    elif url.path == "/set":
                        out = viewer.apply_query(parse_qs(url.query))
                        self._send(200, json.dumps(out).encode())
                    elif url.path == "/material":
                        out = viewer.edit_material(parse_qs(url.query))
                        self._send(200, json.dumps(out).encode())
                    elif url.path == "/object":
                        out = viewer.edit_object(parse_qs(url.query))
                        self._send(200, json.dumps(out).encode())
                    else:
                        self._send(404, b"{}")
                except BrokenPipeError:
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True)

    # -- lifecycle -------------------------------------------------------

    def start(self):
        self._http_thread.start()
        self._render_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._render_thread.join(timeout=30)

    # -- render loop (reference: main.mm drawInMTKView loop) -------------

    def _render_loop(self):
        while not self._stop.is_set():
            try:
                self._render_pass()
            except Exception:  # keep the loop alive across scene edits
                import traceback
                self.last_error = traceback.format_exc()
                print(self.last_error, end="")
                time.sleep(0.5)
            # the lock is not fair: without a pause between passes this
            # thread takes it again before a waiting request can
            time.sleep(0.002)

    def _render_pass(self):
            with self._lock:
                # checked under the lock: once /set?paused=1 returns, no
                # further pass can slip in (the test relies on this)
                if self.paused:
                    time.sleep(0.05)
                    return
                if self._cam_target is not None and (
                        self._motion_active() or self._preview_active):
                    self._camera_pass()
                    return
                t0 = time.time()
                state = self.renderer.draw_frame(self.spp_per_pass)
                rays = float(state.ray_count + state.shadow_ray_count)
                dt = max(time.time() - t0, 1e-6)
                u8 = display_to_u8(state, self.renderer.settings)
                self._frame_png = encode_png_u8(u8)
                prev_rays = getattr(self, "_prev_rays", 0.0)
                self._prev_rays = rays
                self._stats = {
                    "spp": self.renderer.sample_count(),
                    "sps": round(self.spp_per_pass / dt, 2),
                    "mrays": round((rays - prev_rays) / dt / 1e6, 2),
                }

    # -- interactive camera (reference: MetalRenderer.mm:906-956 motion
    # hold/spp drop, :1646-1776 updateCameraSmoothing) -------------------

    def _motion_active(self) -> bool:
        return (time.time() - self._last_interaction) < self.motion_hold

    def _target_camera(self, s):
        if self._cam_target is not None:
            return self._cam_target
        return (s.cameraYaw, s.cameraPitch, s.cameraDistance)

    def _camera_pass(self):
        """One preview pass while the camera is in motion (lock held):
        ease the smoothed camera toward the target, render 1 spp at
        preview scale; restore full resolution once motion stops and
        smoothing has converged."""
        now = time.time()
        s = self.renderer.settings
        if self._smooth is None:
            self._smooth = (s.cameraYaw, s.cameraPitch)
        if self._base_scale is None:
            self._base_scale = s.renderScale
        dt = 1.0 / 60.0 if self._last_smooth_t is None else \
            min(max(now - self._last_smooth_t, 1.0 / 240.0), 0.25)
        self._last_smooth_t = now
        alpha = 1.0 - math.exp(-dt * self.smoothing_hz)
        tyaw, tpitch, tdist = self._cam_target
        syaw, spitch = self._smooth
        # shortest-angle wrap for yaw (ShortestAngleDelta)
        dyaw = (tyaw - syaw + math.pi) % (2.0 * math.pi) - math.pi
        dpitch = tpitch - spitch
        syaw += dyaw * alpha
        spitch += dpitch * alpha
        self._smooth = (syaw, spitch)
        converged = abs(dyaw) < 1e-3 and abs(dpitch) < 1e-3
        ns = s.copy()
        if self._motion_active() or not converged:
            ns.cameraYaw, ns.cameraPitch = syaw, spitch
            ns.cameraDistance = tdist
            ns.renderScale = self._base_scale * self.preview_scale
            t0 = time.time()
            self.renderer.apply_settings(ns)
            state = self.renderer.draw_frame(1)
            u8 = display_to_u8(state, self.renderer.settings)
            self._frame_png = encode_png_u8(u8)
            dtp = max(time.time() - t0, 1e-6)
            self._preview_active = True
            self._stats = dict(self._stats, spp=1,
                               sps=round(1.0 / dtp, 2), preview=True)
        else:
            # motion over: land exactly on the target at full resolution
            # and let progressive accumulation resume
            ns.cameraYaw, ns.cameraPitch = tyaw, tpitch
            ns.cameraDistance = tdist
            ns.renderScale = self._base_scale
            self.renderer.apply_settings(ns)
            self.last_reset = "CAMERA"
            self._preview_active = False
            self._smooth = None
            self._base_scale = None
            self._last_smooth_t = None
            self._stats = dict(self._stats, spp=0, preview=False)

    # -- endpoints -------------------------------------------------------

    def frame_png(self) -> bytes:
        if not self._frame_png:
            # before the first pass finishes: a 1x1 placeholder
            return encode_png_u8(np.zeros((1, 1, 3), np.uint8))
        return self._frame_png

    def stats(self) -> dict:
        s = dict(self._stats)
        s.setdefault("preview", False)
        s["scene"] = self.renderer.active_scene
        s["reset"] = self.last_reset
        s["paused"] = self.paused
        s["width"], s["height"] = self.renderer.render_size
        s["presentation"] = self.presentation
        s["error"] = self.last_error
        return s

    # -- live material editor (reference: UIOverlay.mm Scene panel) ------

    def materials(self) -> list:
        res = self.renderer.resources
        names = {v: k for k, v in res.material_names.items()}
        return [dict(index=i, name=names.get(i, f"material_{i}"),
                     **_mat_fields(m))
                for i, m in enumerate(res.materials)]

    def edit_material(self, q: dict) -> dict:
        """Edit one material in place and restart accumulation — the
        reference's live material editor semantics (every material field
        is radiometric; UIOverlay.mm Scene panel + MATERIAL_EDIT reset)."""
        import dataclasses

        with self._lock:
            res = self.renderer.resources
            try:
                idx = int(q.pop("index")[-1])
                m = res.materials[idx]
            except (KeyError, ValueError, IndexError):
                return {"error": "bad or missing material index"}
            valid = {f.name for f in dataclasses.fields(m)}
            for key, vals in q.items():
                if key not in valid:
                    return {"error": f"unknown material field {key!r}"}
                cur = getattr(m, key)
                raw = vals[-1]
                if isinstance(cur, tuple):
                    setattr(m, key, tuple(float(x) for x in raw.split(",")))
                elif isinstance(cur, bool):
                    setattr(m, key, raw.lower() in ("1", "true", "on"))
                elif isinstance(cur, int):
                    setattr(m, key, int(float(raw)))
                else:
                    setattr(m, key, float(raw))
            self.renderer._scene_dirty = True
            self.renderer.reset_accumulation()
            self.last_reset = "MATERIAL_EDIT"
            self._stats = dict(self._stats, spp=0)
            return {"ok": True, "reset": "MATERIAL_EDIT", "index": idx}

    def objects(self) -> list:
        """Transformable scene objects (the reference's Object panel /
        ImGuizmo target list, UIOverlay.h:207-213)."""
        res = self.renderer.resources
        out = []
        for i, s in enumerate(res.spheres):
            out.append(dict(kind="sphere", index=i,
                            center=list(s.center), radius=s.radius,
                            material=s.material))
        for i, mesh in enumerate(res.meshes):
            c = mesh.vertices.mean(0)
            out.append(dict(kind="mesh", index=i, name=mesh.name,
                            centroid=[float(x) for x in c],
                            material=mesh.material))
        for i, inst in enumerate(getattr(res, "mesh_instances", [])):
            out.append(dict(
                kind="instance", index=i, name=inst.source.name,
                translation=[float(x) for x in inst.transform[:3, 3]],
                material=inst.material))
        return out

    def edit_object(self, q: dict) -> dict:
        """Translate/rotate/scale one object with optional snapping —
        the reference's ImGuizmo gizmo semantics (UIOverlay.h:207-213:
        translate/rotate/scale + snap), console-first. Rebuilds the scene
        and restarts accumulation with OBJECT_TRANSFORM."""
        import math

        with self._lock:
            res = self.renderer.resources
            try:
                kind = q.pop("kind")[-1]
                idx = int(q.pop("index")[-1])
            except (KeyError, ValueError):
                return {"error": "object edits need kind= and index="}
            snap = float(q.pop("snap", ["0"])[-1])

            def snapv(vals):
                if snap <= 0:
                    return vals
                return tuple(round(v / snap) * snap for v in vals)

            translate = snapv(tuple(
                float(x) for x in q.pop("translate", ["0,0,0"])[-1].split(",")))
            scale = float(q.pop("scale", ["1"])[-1])
            rotate_y = math.radians(float(q.pop("rotateY", ["0"])[-1]))
            if q:
                return {"error": f"unknown object tokens {sorted(q)}"}

            try:
                if kind == "sphere":
                    s = res.spheres[idx]
                    s.center = tuple(c + d for c, d in zip(s.center, translate))
                    s.radius = max(s.radius * scale, 1e-4)
                elif kind == "mesh":
                    mesh = res.meshes[idx]
                    c = mesh.vertices.mean(0)
                    v = (mesh.vertices - c) * scale
                    if rotate_y:
                        cy, sy = math.cos(rotate_y), math.sin(rotate_y)
                        rot = np.array([[cy, 0, sy], [0, 1, 0],
                                        [-sy, 0, cy]], np.float32)
                        v = v @ rot.T
                        mesh.normals = (mesh.normals @ rot.T).astype(
                            np.float32)
                    mesh.vertices = (v + c + np.asarray(
                        translate, np.float32)).astype(np.float32)
                elif kind == "instance":
                    inst = res.mesh_instances[idx]
                    delta = np.eye(4)
                    cy, sy = math.cos(rotate_y), math.sin(rotate_y)
                    delta[:3, :3] = np.array(
                        [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]) * scale
                    delta[:3, 3] = translate
                    inst.transform = delta @ inst.transform
                else:
                    return {"error": f"unknown object kind {kind!r}"}
            except IndexError:
                return {"error": "object index out of range"}

            self.renderer._scene_dirty = True
            self.renderer.reset_accumulation()
            self.last_reset = "OBJECT_TRANSFORM"
            self._stats = dict(self._stats, spp=0)
            return {"ok": True, "reset": "OBJECT_TRANSFORM",
                    "kind": kind, "index": idx}

    def _apply_presentation(self, enabled: bool, s=None,
                            initial: bool = False):
        """Toggle presentation mode (reference PresentationSettings):
        resolution lock via explicit renderWidth/Height (UIOverlay.h
        RenderResolutionLock) and an accumulation reset on toggle.
        When `s` is given (the apply_query path) the caller's settings
        copy is mutated and applied by the caller; standalone calls
        apply themselves."""
        self.presentation = enabled
        standalone = s is None
        if standalone:
            s = self.renderer.settings.copy()
        lock = {1: (1280, 720), 2: (1920, 1080)}.get(
            self.presentation_lock)
        if enabled and lock:
            self._pre_presentation_size = (s.renderWidth, s.renderHeight)
            s.renderWidth, s.renderHeight = lock
        elif not enabled and self._pre_presentation_size is not None:
            s.renderWidth, s.renderHeight = self._pre_presentation_size
            self._pre_presentation_size = None
        if standalone:
            self.renderer.apply_settings(s)
        if not initial:
            # resetAccumulationOnToggle (reference default true)
            self.renderer.reset_accumulation()
            self.last_reset = "PRESENTATION_TOGGLE"
            self._stats = dict(self._stats, spp=0)

    def apply_query(self, q: dict) -> dict:
        """Apply /set parameters. Camera verbs (orbit/dolly) mirror the
        reference's mouse bindings; everything else is a RenderSettings
        field edit routed through apply_settings (radiometric-change
        detection decides whether accumulation resets)."""
        with self._lock:
            s = self.renderer.settings.copy()
            reset_reason = None
            motion = False
            for key, vals in q.items():
                raw = vals[-1]
                if key == "orbit":
                    # moves the TARGET camera only; the render loop eases
                    # the smoothed camera toward it at preview resolution
                    tyaw, tpitch, tdist = self._target_camera(s)
                    dyaw, dpitch = (float(x) for x in raw.split(","))
                    self._cam_target = (
                        tyaw + dyaw,
                        float(np.clip(tpitch + dpitch, -1.55, 1.55)),
                        tdist)
                    motion = True
                elif key == "dolly":
                    tyaw, tpitch, tdist = self._target_camera(s)
                    self._cam_target = (
                        tyaw, tpitch, max(tdist * float(raw), 1e-3))
                    motion = True
                elif key == "paused":
                    self.paused = (not self.paused if raw == "toggle"
                                   else raw == "1")
                elif key == "reset":
                    self.renderer.reset_accumulation()
                    reset_reason = "MANUAL"
                elif key == "presentation":
                    want = (not self.presentation if raw == "toggle"
                            else raw == "1")
                    if want != self.presentation:
                        self._apply_presentation(want, s=s)
                        reset_reason = "PRESENTATION_TOGGLE"
                elif hasattr(s, key):
                    setattr(s, key, _coerce(s, key, raw))
                    if key == "renderScale" and self._base_scale is not None:
                        # user scale edits mid-preview update the scale the
                        # post-motion restore will return to
                        self._base_scale = s.renderScale
                        s.renderScale *= self.preview_scale
                else:
                    return {"error": f"unknown setting {key!r}"}
            if motion:
                self._last_interaction = time.time()
            reason = self.renderer.apply_settings(s)
            if reason or reset_reason:
                self.last_reset = reason or reset_reason
                # reflect the restart immediately — _stats otherwise holds
                # the pre-reset sample count until the next pass completes
                self._stats = dict(self._stats,
                                   spp=self.renderer.sample_count())
            return {"ok": True, "reset": reason or reset_reason,
                    "motion": motion, "paused": self.paused}


def _mat_fields(m):
    import dataclasses
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if isinstance(v, (int, float, bool)):
            out[f.name] = v
        elif isinstance(v, tuple) and v and isinstance(v[0], (int, float)):
            out[f.name] = list(v)
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="live progressive viewer")
    ap.add_argument("--scene", default="")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--port", type=int, default=8650)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--sppPerPass", type=int, default=1)
    # the reference GUI's only CLI flag (main.mm:58-72)
    ap.add_argument("--presentation", type=int, default=0)
    ap.add_argument("--presentationLock", type=int, default=2,
                    help="render resolution lock: 0 off, 1 720p, 2 1080p")
    args = ap.parse_args(argv)

    from metal_pathtracer_tpu_torch.ops.kernels import build

    r = Renderer(args.width, args.height)
    build.load()
    if args.scene:
        r.load_scene_from_path(args.scene)
    else:
        r.init()
    server = ViewerServer(r, args.host, args.port,
                          spp_per_pass=args.sppPerPass,
                          presentation=bool(args.presentation),
                          presentation_lock=args.presentationLock).start()
    print(f"[Viewer] http://{args.host}:{server.port}/  "
          f"scene={r.active_scene}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
