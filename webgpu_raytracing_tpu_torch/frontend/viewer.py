"""Live progressive viewer — the interactive frontend (counterpart of
``webgpu_raytracing_tpu/frontend/viewer.py``).

The reference is a *live* renderer: a rAF loop re-renders progressively
(index.tsx:19-28), pointer-lock FPS controls fly the camera
(controls.ts:30-58), any motion resets accumulation (store.ts:192-344),
and a SolidJS panel shows smoothed timings (UI.tsx:25-202). This module is
the headless equivalent: a local HTTP server streams the blit buffer as
PNG to a minimal browser page, input events post back to the render loop,
and the page overlays live stats. The renderer steps in :func:`serve`'s
own thread, on whatever device it was built on; the HTTP threads only
hand out the last encoded frame and queue input events.

Mapping:

* rAF loop (index.tsx:19-28)    → :func:`serve`'s render loop (drain
  inputs → ``Controls.update`` → ``Renderer.step`` → publish frame)
* pointer look (controls.ts:51) → mouse drag on the canvas → POST /input
* WASD/Shift (controls.ts:76)   → key events → POST /input
* reset-on-move (store setters) → ``Renderer.move/rotate_camera``
* UI panel (UI.tsx:25-202)      → stats overlay (/stats.json) + hotkeys:
  B = BVH wireframe, V = blit view cycle, P = projection cycle,
  T = tonemap cycle, R = reset accumulation (each setting change resets
  accumulation, the analog of the reference's reactive pipeline
  recompile)
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..camera import Controls
from ..config import BlitView, ProjectionType, Tonemapping

_PAGE = """<!doctype html>
<html><head><title>webgpu-raytracing-tpu (PyTorch)</title><style>
 body{margin:0;background:#111;color:#ddd;font:12px monospace;
      display:flex;flex-direction:column;align-items:center}
 #hud{padding:6px;white-space:pre}
 img{image-rendering:pixelated;outline:1px solid #333;cursor:crosshair}
 #help{color:#777;padding:4px}
 #panel{display:flex;flex-wrap:wrap;gap:4px;max-width:680px;padding:6px}
 #panel label{display:flex;gap:3px;align-items:center;color:#999}
 #panel input,#panel select{width:70px;background:#222;color:#ddd;
      border:1px solid #444;font:11px monospace}
</style></head><body>
<div id="hud">connecting…</div>
<img id="view" width=WIDTH height=HEIGHT draggable=false>
<div id="panel"></div>
<div id="help">left click = lock mouse, right click = unlock (or drag) ·
WASD/arrows = move · Space/C = up/down · Shift = run ·
B wireframe · V view · P projection · T tonemap · R reset</div>
<script>
const img = document.getElementById('view');
let n = 0;
function refresh(){ img.src = '/frame.png?c=' + (n++); }
img.onload = () => setTimeout(refresh, 30);
img.onerror = () => setTimeout(refresh, 250);
refresh();
setInterval(async () => {
  const s = await (await fetch('/stats.json')).json();
  document.getElementById('hud').textContent =
    `frame ${s.counter}  spp ${s.spp.toFixed(0)}  ` +
    `${s.smoothed_ms.toFixed(0)} ms/frame (raw ${s.frame_ms.toFixed(0)})  ` +
    `${s.smoothed_mrays.toFixed(2)} Mrays/s  ` +
    `${s.width}x${s.height}`;
}, 500);
function post(o){ fetch('/input', {method:'POST', body: JSON.stringify(o)}); }
// pointer-lock capture (controls.ts:30-49): left click locks the
// pointer, right click (or blur) releases; drag-look stays as the
// fallback when pointer lock is unavailable (e.g. insecure contexts)
let drag = null;
img.onmousedown = e => {
  if (e.button === 0 && img.requestPointerLock) img.requestPointerLock();
  drag = [e.clientX, e.clientY];
};
window.oncontextmenu = e => {
  if (document.pointerLockElement) { document.exitPointerLock(); e.preventDefault(); }
};
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (document.pointerLockElement === img) {
    post({type:'look', dx: e.movementX, dy: e.movementY});
    return;
  }
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  post({type:'look', dx, dy});
};
window.onkeydown = e => {
  if (e.repeat) return;
  post({type:'key', key: e.key, down: true});
};
window.onkeyup = e => post({type:'key', key: e.key, down: false});
window.onblur = () => {
  if (document.pointerLockElement) document.exitPointerLock();
  post({type:'blur'});
};
// settings panel (the reference's UI controls, UI.tsx:44-187)
(async () => {
  const s = await (await fetch('/settings.json')).json();
  const panel = document.getElementById('panel');
  for (const [name, spec] of Object.entries(s)) {
    const label = document.createElement('label');
    label.textContent = name.replaceAll('_', ' ');
    let inp;
    if (spec.options) {
      inp = document.createElement('select');
      for (const o of spec.options) {
        const opt = document.createElement('option');
        opt.value = o; opt.textContent = o.toLowerCase();
        opt.selected = o === spec.value;
        inp.appendChild(opt);
      }
      inp.onchange = () => post({type:'set', name, value: inp.value});
    } else if (typeof spec.value === 'boolean') {
      inp = document.createElement('input');
      inp.type = 'checkbox'; inp.checked = spec.value;
      inp.onchange = () => post({type:'set', name, value: inp.checked});
    } else {
      inp = document.createElement('input');
      inp.type = 'number'; inp.value = spec.value;
      inp.step = Number.isInteger(spec.value) ? 1 : 0.1;
      inp.onchange = () => post({type:'set', name, value: +inp.value});
    }
    label.appendChild(inp);
    panel.appendChild(label);
  }
})();
</script></body></html>
"""


class _Shared:
    def __init__(self):
        self.lock = threading.Lock()
        self.png = b""
        self.stats = {}
        self.settings_spec = {}
        self.inputs: queue.Queue = queue.Queue()


def _encode_png(img01: np.ndarray) -> bytes:
    from PIL import Image

    arr = (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def _make_handler(shared: _Shared, width: int, height: int, scale: int):
    page = (
        _PAGE.replace("WIDTH", str(width * scale))
        .replace("HEIGHT", str(height * scale))
        .encode()
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                with shared.lock:
                    png = shared.png
                self._send(200, "image/png", png or b"")
            elif self.path.startswith("/stats.json"):
                with shared.lock:
                    body = json.dumps(shared.stats).encode()
                self._send(200, "application/json", body)
            elif self.path.startswith("/settings.json"):
                with shared.lock:
                    body = json.dumps(shared.settings_spec).encode()
                self._send(200, "application/json", body)
            else:
                self._send(200, "text/html", page)

        def do_POST(self):
            if self.path.startswith("/input"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    shared.inputs.put(json.loads(self.rfile.read(n)))
                except Exception:
                    pass
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"")

    return Handler


_BLIT_CYCLE = list(BlitView)
_PROJ_CYCLE = list(ProjectionType)
_TONE_CYCLE = list(Tonemapping)

# The settings the reference UI panel exposes (UI.tsx:44-187), by
# RenderSettings field name, and this package's own ``kernel_near`` (where
# the trace kernels' tile order is made) — the viewer's numeric/select
# "panel" is a generic POST /input {"type":"set","name":…,"value":…}.
# Enum fields accept the enum's value name (case-insensitive); everything
# else is coerced by the dataclass field's current type.
_PANEL_FIELDS = (
    "resolution_scale",
    "geometry_buffer_scale",
    "fov",
    "fov_orientation",
    "focus_distance",
    "circle_of_confusion",
    "panini_distance",
    "vertical_compression",
    "projection_type",
    "lens_shape",
    "shading_type",
    "tonemapping",
    "exposure",
    "gamma",
    "blit_view",
    "reprojection_rate",
    "jitter_strength",
    "bilateral_filter",
    "sample_count",
    "bounces_depth",
    "debug_bvh",
    "debug_reprojection",
    "kernel_near",
)


def _coerce_setting(current, value):
    """Coerce a JSON value onto the type of the current field value.
    Raises on anything that doesn't cleanly coerce (the caller ignores
    the event): booleans accept only JSON true/false — bool("false")
    would silently enable a setting the page asked to disable."""
    if isinstance(current, bool):
        if not isinstance(value, bool):
            raise ValueError(f"expected bool, got {value!r}")
        return value
    if hasattr(type(current), "__members__"):  # Enum
        if isinstance(value, str):
            return type(current)[value.upper()]
        return type(current)(value)
    return type(current)(value)


def _apply_inputs(renderer, controls: Controls, shared: _Shared) -> None:
    """Drain queued browser events into camera/settings mutations — each
    image-relevant change resets accumulation via the Renderer, exactly
    like the reference's store setters (store.ts:192-344)."""
    while True:
        try:
            ev = shared.inputs.get_nowait()
        except queue.Empty:
            return
        t = ev.get("type")
        if t == "look":
            if controls.pointer(
                float(ev.get("dx", 0.0)), float(ev.get("dy", 0.0)), 1.0
            ):
                renderer.reset()
        elif t == "key":
            key = str(ev.get("key", ""))
            if ev.get("down"):
                if key in ("b", "B"):
                    renderer.update_settings(
                        debug_bvh=not renderer.settings.debug_bvh
                    )
                elif key in ("v", "V"):
                    cur = _BLIT_CYCLE.index(renderer.settings.blit_view)
                    renderer.update_settings(
                        blit_view=_BLIT_CYCLE[(cur + 1) % len(_BLIT_CYCLE)]
                    )
                elif key in ("p", "P"):
                    cur = _PROJ_CYCLE.index(renderer.settings.projection_type)
                    renderer.update_settings(
                        projection_type=_PROJ_CYCLE[
                            (cur + 1) % len(_PROJ_CYCLE)
                        ]
                    )
                elif key in ("t", "T"):
                    cur = _TONE_CYCLE.index(renderer.settings.tonemapping)
                    renderer.update_settings(
                        tonemapping=_TONE_CYCLE[(cur + 1) % len(_TONE_CYCLE)]
                    )
                elif key in ("r", "R"):
                    renderer.reset()
                else:
                    controls.press(key)
            else:
                controls.release(key)
        elif t == "set":
            # UI-panel analog (UI.tsx numeric/select controls): any
            # whitelisted RenderSettings field; the Renderer resets
            # accumulation, the reference's reactive pipeline-recompile
            # path (gpu.ts:512-525)
            name = str(ev.get("name", ""))
            if name == "scale":
                # store.scale look divisor (controls.ts:56, UI.tsx:170-176):
                # a Controls knob, not a RenderSettings field; the
                # reference resets accumulation on change (store.ts:192-195)
                try:
                    controls.scale = float(ev.get("value"))
                    renderer.reset()
                except (TypeError, ValueError):
                    pass
            elif name in _PANEL_FIELDS:
                try:
                    cur = getattr(renderer.settings, name)
                    renderer.update_settings(
                        **{name: _coerce_setting(cur, ev.get("value"))}
                    )
                except (KeyError, TypeError, ValueError, OverflowError):
                    pass  # bad value from the page: ignore, keep rendering
        elif t == "blur":
            controls.release_all()


def _settings_spec(settings, controls=None) -> dict:
    """Current panel-field values (+ enum options) for /settings.json."""
    spec = {}
    for name in _PANEL_FIELDS:
        v = getattr(settings, name)
        if hasattr(type(v), "__members__"):
            spec[name] = {
                "value": v.name,
                "options": [m for m in type(v).__members__],
            }
        else:
            spec[name] = {"value": v}
    if controls is not None:
        spec["scale"] = {"value": controls.scale}
    return spec


def serve(
    renderer,
    host: str = "127.0.0.1",
    port: int = 8787,
    scale: int = 1,
    max_frames: int | None = None,
) -> None:
    """Run the progressive render loop and serve it at http://host:port.

    ``max_frames`` bounds the loop (tests/headless benches); None = until
    interrupted."""
    shared = _Shared()
    s = renderer.settings
    handler = _make_handler(shared, s.width, s.height, scale)
    httpd = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    controls = Controls(renderer.camera)
    shared.settings_spec = _settings_spec(renderer.settings, controls)
    print(f"live viewer: http://{host}:{httpd.server_address[1]}/")

    frames = 0
    prev = time.perf_counter()
    # HUD timings are smoothed exactly like the reference's
    # useSmoothedValue hook (utils.ts:37-48, displayed UI.tsx:26-42);
    # FrameMetrics carries the same 0.9-weight exponential average
    from ..utils.timing import FrameMetrics

    metrics = FrameMetrics()
    try:
        while max_frames is None or frames < max_frames:
            now = time.perf_counter()
            dt = now - prev
            prev = now
            _apply_inputs(renderer, controls, shared)
            if controls.update(dt):
                renderer.reset()
            t0 = time.perf_counter()
            renderer.step()
            img = renderer.image()
            frame_s = time.perf_counter() - t0
            png = _encode_png(img)
            # derived, not read back: each frame adds (1 + sample_count)
            # samples per pixel
            spp = float(
                renderer.counter * (1 + renderer.settings.sample_count)
            )
            with shared.lock:
                shared.png = png
                shared.settings_spec = _settings_spec(
                    renderer.settings, controls
                )
                row = metrics.record(frame_s, renderer.last_rays, spp)
                shared.stats = {
                    "counter": renderer.counter,
                    "spp": spp,
                    "frame_ms": frame_s * 1e3,
                    "smoothed_ms": row["smoothed_ms"],
                    "mrays": renderer.last_rays / max(frame_s, 1e-9) / 1e6,
                    "smoothed_mrays": renderer.last_rays
                    / max(row["smoothed_ms"] / 1e3, 1e-9)
                    / 1e6,
                    "width": s.width,
                    "height": s.height,
                }
            frames += 1
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
