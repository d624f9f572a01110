"""Multi-device rendering: the image rows are split over devices
(counterpart of ``webgpu_raytracing_tpu/parallel/shard.py``).

Path tracing is parallel over pixels: each device owns a horizontal slab
of the image and holds its own copy of the scene tables, and renders its
slab through :func:`..renderer.render_tile` with the slab's global first
row, so every pixel's RNG stream is the one it has in a single-device
frame and the result is that frame bit for bit. The ``prev_*`` snapshots
(reprojection, the hit predictor) are whole on every device.

One process drives a "mesh", a list of ``torch.device``: no
``torch.distributed``. The JAX module is one controller over a device
mesh too, and its two collectives become a sum of the per-device ray
counts and, at the updatePrev rotation, a copy of every slab of the
current buffers to every device. The same device may appear more than
once (several slabs on one card). Each slab's work runs under
``torch.cuda.device`` of its device: the kernels run on the current
device's stream and refuse rays that lie elsewhere
(ops/_build.py ``check_current_device``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RenderSettings
from ..models.scene import SceneTables
from ..ops.env_sample import EnvDistribution
from ..renderer import FrameBuffers, FrameInputs, render_tile

_CURRENT = ("image", "geo_position", "geo_face", "geo_object")
_PREV = {"prev_image": "image", "prev_geo_position": "geo_position",
         "prev_geo_face": "geo_face"}


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The visible CUDA devices, or the first ``n_devices`` of them; raises
    when there are fewer (pass a list of devices to ``render_sharded`` for
    another layout, such as several slabs on one card or the CPU)."""
    n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_vis if n_devices is None else n_devices
    if n < 1 or n > n_vis:
        raise ValueError(
            f"make_mesh: {n} CUDA devices asked for, {n_vis} visible")
    return [torch.device("cuda", i) for i in range(n)]


def _devices(mesh: Sequence) -> List[torch.device]:
    return [torch.device(dev) for dev in mesh]


def _on(dev: torch.device):
    """The context in which ``dev``'s slab runs."""
    return torch.cuda.device(dev) if dev.type == "cuda" else (
        contextlib.nullcontext())


def _rows(settings: RenderSettings, n: int) -> int:
    """Rows per device; the JAX module's two refusals."""
    if settings.geo_height != settings.render_height:
        raise ValueError(
            "geometry_buffer_scale != 1 is single-device only (the G-buffer "
            "slab partition would be uneven across devices)"
        )
    if settings.render_height % n != 0:
        raise ValueError(
            f"render height {settings.render_height} must divide evenly "
            f"over {n} devices"
        )
    return settings.render_height // n


def shard_buffers(buffers: FrameBuffers, mesh) -> List[FrameBuffers]:
    """Whole frame buffers → one per device: its rows of the current
    buffers, the ``prev_*`` snapshots whole."""
    mesh = _devices(mesh)
    h = buffers.image.shape[0] // len(mesh)
    return [
        FrameBuffers(
            **{k: getattr(buffers, k)[i * h:(i + 1) * h].to(dev)
               for k in _CURRENT},
            **{k: getattr(buffers, k).to(dev) for k in _PREV},
        )
        for i, dev in enumerate(mesh)
    ]


def gather_buffers(shards: Sequence[FrameBuffers], device) -> FrameBuffers:
    """Per-device buffers → whole frame buffers on ``device`` (the
    ``prev_*`` snapshots of the first device)."""
    first = shards[0]
    return FrameBuffers(
        **{k: torch.cat([getattr(s, k).to(device) for s in shards])
           for k in _CURRENT},
        **{k: getattr(first, k).to(device) for k in _PREV},
    )


def rotate_prev_sharded(shards: Sequence[FrameBuffers],
                        mesh) -> List[FrameBuffers]:
    """The updatePrev rotation (render.ts:1694-1699) across devices: every
    device's ``prev_*`` becomes the whole current frame, gathered from all
    slabs (the JAX module's all-gather)."""
    return [
        dataclasses.replace(s, **{
            prev: torch.cat([getattr(t, cur).to(dev) for t in shards])
            for prev, cur in _PREV.items()
        })
        for s, dev in zip(shards, _devices(mesh))
    ]


def _to(x, dev: torch.device):
    if x is None or isinstance(x, (int, float)):
        return x
    if isinstance(x, (SceneTables, EnvDistribution)):
        return x.to(dev)
    if isinstance(x, FrameInputs):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(FrameInputs)
        })
    if isinstance(x, np.ndarray):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, device=dev)


def replicate(tree, mesh) -> list:
    """One copy of ``tree`` (tensors, an array, SceneTables,
    EnvDistribution or FrameInputs) on each device of the mesh."""
    return [_to(tree, dev) for dev in _devices(mesh)]


def sharded_render_frame(mesh, settings: RenderSettings):
    """The frame function for ``settings`` over ``mesh``:
    ``fn(shards, tables, env, inputs) -> (shards, rays)``, every argument
    a list with one entry per device (:func:`shard_buffers`,
    :func:`replicate`); ``rays`` is the sum over devices. Raises
    ``ValueError`` when the rows cannot be split evenly, or the G-buffer
    has fewer rows than the image."""
    mesh = _devices(mesh)
    rows = _rows(settings, len(mesh))

    @torch.no_grad()
    def fn(shards, tables, env, inputs):
        outs, rays = [], []
        for i, dev in enumerate(mesh):
            with _on(dev):
                out, r = render_tile(shards[i], tables[i], env[i], inputs[i],
                                     i * rows, settings, rows)
            outs.append(out)
            rays.append(r)
        return outs, sum(float(r) for r in rays)

    return fn


def render_sharded(
    scene_tables: SceneTables,
    env_data,
    settings: RenderSettings,
    n_frames: int,
    mesh: Optional[Sequence] = None,
    seed0: int = 1,
    inputs_fn=None,
) -> Tuple[FrameBuffers, float]:
    """Run ``n_frames`` progressive frames with the rows split over the
    mesh (default: every visible card) → (whole buffers on the first
    device, total rays traced).

    ``inputs_fn(k) -> FrameInputs`` overrides the default static-camera
    inputs (``FrameInputs.simple`` of the identity view and seed ``(seed0
    + k * 2654435761) % 2**32``). The updatePrev rotation follows the JAX
    module's schedule (render.ts:1652-1657): every frame at
    ``reprojection_rate`` 0, else every rate-th frame, and only where
    reprojection or the hit predictor reads the snapshots."""
    mesh = _devices(make_mesh() if mesh is None else mesh)
    fn = sharded_render_frame(mesh, settings)
    shards = shard_buffers(
        FrameBuffers.create(settings.render_width, settings.render_height,
                            mesh[0]),
        mesh,
    )
    tables = replicate(scene_tables, mesh)
    env = replicate(env_data, mesh)
    total_rays = 0.0
    frame_counter = 0
    for k in range(n_frames):
        if inputs_fn is not None:
            inputs = inputs_fn(k)
        else:
            inputs = FrameInputs.simple(
                np.eye(4, dtype=np.float32),
                (seed0 + k * 2654435761) % (2**32), k, mesh[0])
        rate = settings.reprojection_rate
        update_prev = rate == 0 or frame_counter % rate == 0
        if rate:
            frame_counter = (frame_counter + 1) % rate
        shards, rays = fn(shards, tables, env, replicate(inputs, mesh))
        total_rays += rays
        if update_prev and (settings.reproject or settings.use_hit_predictor):
            shards = rotate_prev_sharded(shards, mesh)
    return gather_buffers(shards, mesh[0]), total_rays
