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
  and CUDA activities, with the spans below on, and writes a Chrome trace
  (the timestamp-query analog);
* the port's own spans and counters, off unless :func:`tracing` turns
  them on. :func:`span` (and :func:`traced`, its decorator form) marks
  a layer of the frame as a ``torch.profiler.record_function`` range
  named ``wrt.*``: it lies on the profiler's timeline, the clock of the
  device operations, and every kernel launched inside it is tied to it
  by correlation id. Spans nest as the calls nest; a device operation
  belongs, as self, to the innermost span open at its launch. While
  tracing is on each garbage collection is a ``wrt.gc`` span.
  :func:`count` keeps a counter of the current frame, a host number or a
  device scalar the frame has already computed; ``Renderer.step``
  resolves the frame's device scalars with its one read-back
  (:func:`read_counts`) into ``Renderer.last_counts``.

Off, :func:`span` is one flag check that returns a shared object, and
:func:`count` a flag check: no device operation, no read-back, no
allocation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
from typing import Optional

import torch
from torch.autograd.profiler import record_function


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

    def record(self, wall_s: float, rays: float, spp: float,
               last_counts: Optional[dict] = None) -> dict:
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
        if last_counts:  # the frame's counters, with tracing on
            row["last_counts"] = last_counts
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace of a block (CPU activity, and CUDA where a
    card is visible) → ``<log_dir>/trace.json``, a Chrome trace (open it
    in chrome://tracing or Perfetto), with the port's spans on so that
    the frame's layers lie over its kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, tracing():
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(json.dumps({"profile": path}))


class _NoSpan:
    """What :func:`span` returns with tracing off: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_on = False
# the current frame's counters: name -> values (host numbers or device
# scalars), in the order they came
_counts: dict = {}
# the open wrt.gc spans (a collection cannot start inside another)
_gc_open: list = []


def span(name: str, args=None):
    """A ``wrt.*`` range over a block: ``record_function(name)`` with
    tracing on (``args``, if given, as its string), the shared no-op
    otherwise."""
    if not _on:
        return _NO_SPAN
    return record_function(name, None if args is None else str(args))


def traced(name: str):
    """Decorator: the whole call under :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a host number, or a device scalar already computed)
    to the current frame's counter ``name``; nothing with tracing off."""
    if _on:
        _counts.setdefault(name, []).append(value)


def reset_counts() -> None:
    """Drop the counters kept so far (a frame starts)."""
    _counts.clear()


def read_counts(total: torch.Tensor):
    """The frame's one read-back → (``total`` as a float, the frame's
    counters summed by name). With tracing on, ``total`` (a device
    scalar) and every device counter go to the host in one
    ``torch.stack`` and one ``.tolist()``; off, ``float(total)`` and an
    empty dict."""
    if not _on:
        return float(total), {}
    pending = [(k, v) for k, vals in _counts.items() for v in vals]
    _counts.clear()
    dev = [(k, v) for k, v in pending if torch.is_tensor(v)]
    vals = torch.stack([total] + [v for _, v in dev]).tolist()
    out = {}
    for k, v in pending:
        if not torch.is_tensor(v):
            out[k] = out.get(k, 0) + v
    for (k, _), v in zip(dev, vals[1:]):
        out[k] = out.get(k, 0) + v
    return vals[0], out


def _gc_span(phase, info) -> None:
    if phase == "start":
        _gc_open.append(record_function("wrt.gc").__enter__())
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def _switch(on: bool) -> None:
    global _on
    if on and not _on:
        gc.callbacks.append(_gc_span)
    elif _on and not on:
        gc.callbacks.remove(_gc_span)
    _on = on
    _counts.clear()


@contextlib.contextmanager
def tracing(on: bool = True):
    """The port's spans, counters and ``wrt.gc`` hook on (or off) for a
    block; the state before it comes back after."""
    was = _on
    _switch(on)
    try:
        yield
    finally:
        _switch(was)
