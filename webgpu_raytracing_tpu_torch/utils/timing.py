"""Metrics / tracing / observability (counterpart of
``webgpu_raytracing_tpu/utils/timing.py``).

The reference surfaces three live timers — GPU-time from timestamp queries
(gpu.ts:58-108), JS-time per renderFrame (render.ts:1706) and frame dt
(store.ts:282-285) — on its UI overlay. Headless equivalents:

* :class:`FrameMetrics` — per-frame wall clock, rays/s, spp, written as
  JSONL for machine consumption (the caller ends each timed frame where
  the device has finished: ``Renderer.step`` reads the frame's ray count
  back, which waits for the card);
* :func:`profile_trace` — wraps a block in ``torch.profiler`` with the CPU
  and CUDA activities and writes a Chrome trace (the timestamp-query
  analog);
* :func:`timed` — ad-hoc wall-clock context manager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional


@dataclasses.dataclass
class FrameMetrics:
    """Rolling per-frame metrics sink (optionally JSONL-backed)."""

    path: Optional[str] = None
    smoothing: float = 0.9  # like useSmoothedValue (utils.ts:37-48)
    _fh: object = None
    frame: int = 0
    smoothed_ms: float = 0.0

    def __post_init__(self):
        if self.path:
            self._fh = open(self.path, "a")

    def record(self, wall_s: float, rays: float, spp: float) -> dict:
        self.frame += 1
        ms = wall_s * 1e3
        self.smoothed_ms = (
            ms
            if self.frame == 1
            else self.smoothing * self.smoothed_ms + (1 - self.smoothing) * ms
        )
        row = {
            "frame": self.frame,
            "frame_ms": round(ms, 3),
            "smoothed_ms": round(self.smoothed_ms, 3),
            "mrays_per_s": round(rays / max(wall_s, 1e-9) / 1e6, 4),
            "rays": rays,
            "spp": spp,
        }
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def timed(label: str = "", sink=None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = {"label": label, "wall_s": round(dt, 4)}
    (sink or print)(json.dumps(msg) if sink is None else msg)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace of a block (CPU activity, and CUDA where a
    card is visible) → ``<log_dir>/trace.json``, a Chrome trace (open it
    in chrome://tracing or Perfetto)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(json.dumps({"profile": path}))
