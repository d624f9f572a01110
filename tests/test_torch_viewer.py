"""PyTorch port: the live viewer (counterpart of tests/test_viewer.py) on a
CPU Renderer. Its server binds a port the system reports free at the
time, not a fixed one: test files may run in parallel worker processes
(pytest-xdist) and several checkouts may run their suites on one machine,
and two servers on one port would collide."""

import io
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import torch
from PIL import Image

from webgpu_raytracing_tpu_torch.config import RenderSettings
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.models.test_models import (
    ground_plane,
    uv_sphere,
)
from webgpu_raytracing_tpu_torch.renderer import Renderer

torch.set_num_threads(1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_renderer():
    scene = scene_from_facesets(
        [
            ("light", uv_sphere((0, 4, -4), 0.8, material_idx=0, lat=6,
                                lon=8)),
            ("plane", ground_plane(0.0, 10.0, material_idx=1)),
        ],
        np.array([[0, 0, 0], [0.7, 0.7, 0.7]], np.float32),
        np.array([[8, 8, 8], [0, 0, 0]], np.float32),
    )
    settings = RenderSettings(width=32, height=24, bounces_depth=2)
    return Renderer(scene, settings, base_seed=3, device="cpu")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode())
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def _wait(cond, seconds=30):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


def test_viewer_serves_and_applies_input():
    from webgpu_raytracing_tpu_torch.frontend.viewer import serve

    renderer = _tiny_renderer()
    port = _free_port()
    t = threading.Thread(
        target=serve,
        kwargs=dict(renderer=renderer, port=port, max_frames=400),
        daemon=True,
    )
    t.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60
    png = b""
    while time.time() < deadline:
        try:
            png = _get(base + "/frame.png")
            if png:
                break
        except OSError:
            time.sleep(0.3)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"

    page = _get(base + "/")
    assert b"webgpu-raytracing-tpu" in page

    stats = json.loads(_get(base + "/stats.json"))
    assert stats["width"] == 32 and stats["height"] == 24
    assert stats["counter"] >= 1 and stats["smoothed_ms"] > 0

    # camera look → rotation applied, and the accumulation restarts
    q0 = np.array(renderer.camera.orientation, copy=True)
    _post(base + "/input", {"type": "look", "dx": 40.0, "dy": 0.0})
    assert _wait(lambda: not np.array_equal(
        np.array(renderer.camera.orientation), q0))

    _post(base + "/input", {"type": "key", "key": "w", "down": True})
    _post(base + "/input", {"type": "key", "key": "w", "down": False})
    _post(base + "/input", {"type": "blur"})
    # B toggles the BVH wireframe
    _post(base + "/input", {"type": "key", "key": "b", "down": True})
    assert _wait(lambda: renderer.settings.debug_bvh)

    spec = json.loads(_get(base + "/settings.json"))
    assert "fov" in spec and isinstance(spec["fov"]["value"], float)
    assert "options" in spec["tonemapping"]
    assert spec["kernel_near"]["value"] is True
    assert spec["scale"]["value"] == 1.0
    _post(base + "/input", {"type": "set", "name": "fov", "value": 1.25})
    _post(base + "/input",
          {"type": "set", "name": "tonemapping", "value": "aces"})
    _post(base + "/input", {"type": "set", "name": "fov", "value": "junk"})
    _post(base + "/input", {"type": "set", "name": "width", "value": 1})
    _post(base + "/input",
          {"type": "set", "name": "bilateral_filter", "value": "false"})
    _post(base + "/input",
          {"type": "set", "name": "sample_count", "value": 1e999})
    _post(base + "/input", {"type": "set", "name": "scale", "value": 4.0})
    # both scales render now: a half-size render blitted to the canvas,
    # and a G-buffer of half the rows
    _post(base + "/input",
          {"type": "set", "name": "resolution_scale", "value": 0.5})
    _post(base + "/input",
          {"type": "set", "name": "geometry_buffer_scale", "value": 0.5})
    assert _wait(lambda: renderer.settings.geometry_buffer_scale == 0.5)
    c0 = renderer.counter
    assert _wait(lambda: renderer.counter > c0 + 1)
    assert abs(renderer.settings.fov - 1.25) < 1e-6
    assert renderer.settings.tonemapping.name == "ACES"
    assert renderer.settings.resolution_scale == 0.5
    assert renderer.buffers.image.shape == (12, 16, 4)
    assert renderer.buffers.geo_face.shape == (6, 16)
    assert _wait(lambda: json.loads(
        _get(base + "/settings.json"))["scale"]["value"] == 4.0)
    assert renderer.settings.width == 32  # non-panel field untouched
    assert renderer.settings.bilateral_filter is False  # junk rejected
    assert renderer.settings.sample_count == 1  # overflow ignored
    png = _get(base + "/frame.png")
    with Image.open(io.BytesIO(png)) as im:
        assert im.size == (32, 24)  # the canvas, whatever the render size

    t.join(timeout=120)
    assert not t.is_alive()
