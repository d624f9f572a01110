"""Camera ray generation — the four reference projections + thin lens
(counterpart of ``webgpu_raytracing_tpu/ops/raygen.py``,
render.ts:642-766). The operation order is the JAX package's, so the
rays agree bit for bit; quirks of the reference (the doubled Panini
half-FoV factor, the +z fisheye) are kept.

:func:`camera_rays` on CUDA tensors is one launch of the hand-written
kernel ``wrt_camera_rays`` (``csrc/raygen.cu``), held bit for bit to the
plain twin (``camera_rays.twin``) run on the CPU; CPU tensors run the
twin. Scalars that depend only on the settings (tan/sin/cos of the FoV)
are computed once in f32 on the CPU (:func:`camera_scalars`), for the
twin and the kernel alike, so the CPU and the GPU use the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from ..config import FovOrientation, LensShape, ProjectionType, RenderSettings
from . import rng
from ._build import Kernel, check_args, launch
from .detmath import det_div, det_sincos, det_sqrt, det_tan, normalize


class CameraScalars(NamedTuple):
    """The f32 scalars of a camera ray (each a Python float that is an f32
    value), in the order of ``CameraArgs`` in ``csrc/raygen.cuh``."""

    width: float
    height: float
    uv_div: float  # the FoV orientation's divisor of 2 pos - (w, h)
    pinhole_z: float  # -1 / tan(fov / 2)
    half_fov: float
    half_panini_fov: float
    panini_distance: float
    pd_vc: float  # panini_distance * (1 - vertical_compression)
    coc: float  # circle_of_confusion
    focus: float  # focus_distance
    fov_distance: float  # the orthographic fov / pi * 4


def _f32_scalar(fn, *args) -> float:
    """Evaluate ``fn`` on f32 CPU scalars and return the f32 result."""
    vals = [torch.tensor(a, dtype=torch.float32) for a in args]
    return float(fn(*vals))


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


@functools.lru_cache(maxsize=64)
def _camera_scalars(width, height, orientation, fov, panini_distance,
                    vertical_compression, coc, focus) -> CameraScalars:
    w_f, h_f = float(width), float(height)
    if orientation == FovOrientation.VERTICAL:
        uv_div = h_f
    elif orientation == FovOrientation.HORIZONTAL:
        uv_div = w_f
    else:
        uv_div = _f32_scalar(torch.sqrt, w_f * w_f + h_f * h_f)
    half_fov = fov / 2.0
    return CameraScalars(*map(_f32, (
        w_f, h_f, uv_div,
        _f32_scalar(lambda f: -1.0 / torch.tan(f), half_fov),
        half_fov,
        _f32_scalar(
            lambda h, p: torch.atan2(torch.sin(h), torch.cos(h) + p),
            half_fov, panini_distance,
        ),
        panini_distance,
        # a product of two Python floats in the JAX package: double, then f32
        panini_distance * (1.0 - vertical_compression),
        coc, focus,
        fov / math.pi * 4.0,
    )))


def camera_scalars(settings: RenderSettings) -> CameraScalars:
    """The settings' camera scalars, rounded to f32 as the JAX package
    rounds them (weak-typed Python floats; the FoV's trigonometry in f32
    on the CPU)."""
    return _camera_scalars(
        settings.render_width, settings.render_height,
        int(settings.fov_orientation), settings.fov,
        settings.panini_distance, settings.vertical_compression,
        settings.circle_of_confusion, settings.focus_distance,
    )


def scalar_block(settings: RenderSettings) -> ctypes.Array:
    """:func:`camera_scalars` as the f32 block ``wrt_camera_rays`` reads."""
    return (ctypes.c_float * len(CameraScalars._fields))(
        *camera_scalars(settings))


def pinhole_dir(uv: torch.Tensor, sc: CameraScalars) -> torch.Tensor:
    z = torch.full_like(uv[..., 0], sc.pinhole_z)
    return normalize(torch.stack([uv[..., 0], uv[..., 1], z], dim=-1))


def panini_dir(uv: torch.Tensor, sc: CameraScalars) -> torch.Tensor:
    hv = uv * sc.half_fov
    hv_pan = hv * sc.half_panini_fov
    sx, cx = det_sincos(hv_pan[..., 0])
    w = sx * sc.panini_distance
    m = det_sqrt(torch.clamp(1.0 - w * w, min=0.0)) + sc.panini_distance * cx
    x = sx * m
    z = cx * m - sc.panini_distance
    y = det_tan(hv_pan[..., 1]) * (z + sc.pd_vc)
    return normalize(torch.stack([x, y, -z], dim=-1))


def fisheye_dir(uv: torch.Tensor, sc: CameraScalars) -> torch.Tensor:
    angle = uv * sc.half_fov
    sax, cax = det_sincos(angle[..., 0])
    say, cay = det_sincos(angle[..., 1])
    return normalize(torch.stack([-sax, -say * cax, cay * cax], dim=-1))


def _camera_rays_torch(
    pos: torch.Tensor,  # (..., 2) pixel coordinates (jittered)
    view: torch.Tensor,  # (4, 4) view matrix (camera → world)
    state: torch.Tensor,  # (...) RNG state words
    settings: RenderSettings,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain twin of the kernel: eager ops, one rounding each."""
    dev = pos.device
    sc = camera_scalars(settings)
    uv = 2.0 * pos - torch.tensor(
        [sc.width, sc.height], dtype=torch.float32, device=dev
    )
    uv = uv / sc.uv_div

    proj = settings.projection_type
    if proj == ProjectionType.PANINI:
        d = panini_dir(uv, sc)
    elif proj == ProjectionType.PERSPECTIVE:
        d = pinhole_dir(uv, sc)
    elif proj == ProjectionType.FISHEYE:
        d = fisheye_dir(uv, sc)
    else:  # orthographic
        d = torch.tensor(
            [0.0, 0.0, -1.0], dtype=torch.float32, device=dev
        ).expand(uv.shape[:-1] + (3,))

    # sampleLens (render.ts:740-747): always draws random_2
    t2, state = rng.random_2(state)
    if settings.lens_shape == LensShape.CIRCLE:
        lens = rng.sample_incircle(t2)
    else:
        lens = rng.sample_insquare(t2)

    # thinLensRay (render.ts:695-702)
    o = torch.cat(
        [lens * sc.coc, torch.zeros_like(lens[..., :1])],
        dim=-1,
    )
    focus = -d * det_div(sc.focus, d[..., 2:3])
    d = normalize(focus - o)

    if proj == ProjectionType.ORTHOGRAPHIC:
        # cameraRayPosition (render.ts:724-729)
        o = o + torch.cat([uv, torch.zeros_like(uv[..., :1])], dim=-1) * (
            sc.fov_distance
        )

    # ray_transform (render.ts:731-738) as strict elementwise mul/adds
    def _mat_vec(mat, v3, w):
        cols = []
        for j in range(mat.shape[0]):
            acc = v3[..., 0] * mat[j, 0]
            acc = acc + v3[..., 1] * mat[j, 1]
            acc = acc + v3[..., 2] * mat[j, 2]
            if w is not None:
                acc = acc + w * mat[j, 3]
            cols.append(acc)
        return torch.stack(cols, dim=-1)

    oh = _mat_vec(view, o, torch.ones_like(o[..., 0]))
    o_w = oh[..., :3]
    d = normalize(torch.cat([d[..., :2], d[..., 2:3] * oh[..., 3:4]], dim=-1))
    d_w = _mat_vec(view[:3, :3], d, None)
    return o_w, d_w, state


def _launch_camera_rays(pos, view, state, settings):
    """Check the arguments and launch ``wrt_camera_rays`` → (o, d, state)."""
    dev, r = pos.device, pos.shape[0]
    check_args("camera rays", dev, [
        ("pos", pos, torch.float32, (r, 2)),
        ("view", view, torch.float32, (4, 4)),
        ("state", state, torch.int64, (r,))])
    o = torch.empty((r, 3), dtype=torch.float32, device=dev)
    d = torch.empty((r, 3), dtype=torch.float32, device=dev)
    state_out = torch.empty((r,), dtype=torch.int64, device=dev)
    launch("camera rays", "wrt_camera_rays", dev, pos.data_ptr(),
           view.data_ptr(), state.data_ptr(), int(settings.projection_type),
           int(settings.lens_shape), scalar_block(settings), o.data_ptr(),
           d.data_ptr(), state_out.data_ptr(), r)
    return o, d, state_out


camera_rays = Kernel(
    "camera_rays", _camera_rays_torch, _launch_camera_rays, "camera rays",
    "cameraRay (render.ts:749-765) (pos (R, 2) jittered pixel coordinates, "
    "view (4, 4) camera → world, state (R,) RNG words, settings) → "
    "(origin, direction, state).", span_name="wrt.raygen")
