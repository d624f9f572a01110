"""Camera ray generation — the four reference projections + thin lens
(counterpart of ``webgpu_raytracing_tpu/ops/raygen.py``,
render.ts:642-766). The operation order is the JAX package's, so the
rays agree bit for bit; quirks of the reference (the doubled Panini
half-FoV factor, the +z fisheye) are kept.

Scalars that depend only on the settings (tan/sin/cos of the FoV) are
computed once in f32 on the CPU and moved to the rays' device, so the
CPU and the GPU use the same bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import FovOrientation, LensShape, ProjectionType, RenderSettings
from ..utils.timing import traced
from . import rng
from .detmath import det_div, det_sincos, det_sqrt, det_tan, normalize


def _f32_scalar(fn, *args) -> float:
    """Evaluate ``fn`` on f32 CPU scalars and return the f32 result."""
    vals = [torch.tensor(a, dtype=torch.float32) for a in args]
    return float(fn(*vals))


def pinhole_dir(uv: torch.Tensor, fov: float) -> torch.Tensor:
    z = _f32_scalar(lambda f: -1.0 / torch.tan(f), fov / 2.0)
    return normalize(
        torch.stack(
            [uv[..., 0], uv[..., 1], torch.full_like(uv[..., 0], z)], dim=-1
        )
    )


def panini_dir(
    uv: torch.Tensor, fov: float, panini_distance: float,
    vertical_compression: float,
) -> torch.Tensor:
    half_fov = fov / 2.0
    hv = uv * half_fov
    half_panini_fov = _f32_scalar(
        lambda h, p: torch.atan2(torch.sin(h), torch.cos(h) + p),
        half_fov, panini_distance,
    )
    hv_pan = hv * half_panini_fov
    sx, cx = det_sincos(hv_pan[..., 0])
    w = sx * panini_distance
    m = det_sqrt(torch.clamp(1.0 - w * w, min=0.0)) + panini_distance * cx
    x = sx * m
    z = cx * m - panini_distance
    # a product of two Python floats in the JAX package: double, then f32
    pd_vc = float(
        torch.tensor(
            panini_distance * (1.0 - vertical_compression),
            dtype=torch.float32,
        )
    )
    y = det_tan(hv_pan[..., 1]) * (z + pd_vc)
    return normalize(torch.stack([x, y, -z], dim=-1))


def fisheye_dir(uv: torch.Tensor, fov: float) -> torch.Tensor:
    angle = uv * (fov / 2.0)
    sax, cax = det_sincos(angle[..., 0])
    say, cay = det_sincos(angle[..., 1])
    return normalize(torch.stack([-sax, -say * cax, cay * cax], dim=-1))


@traced("wrt.raygen")
def camera_rays(
    pos: torch.Tensor,  # (R, 2) pixel coordinates (jittered)
    view: torch.Tensor,  # (4, 4) view matrix (camera → world)
    state: torch.Tensor,  # (R,) RNG state words
    settings: RenderSettings,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cameraRay (render.ts:749-765). Returns (origin, direction, state)."""
    dev = pos.device
    w_f, h_f = float(settings.render_width), float(settings.render_height)
    uv = 2.0 * pos - torch.tensor([w_f, h_f], dtype=torch.float32, device=dev)
    if settings.fov_orientation == FovOrientation.VERTICAL:
        uv = uv / h_f
    elif settings.fov_orientation == FovOrientation.HORIZONTAL:
        uv = uv / w_f
    else:
        uv = uv / _f32_scalar(torch.sqrt, w_f * w_f + h_f * h_f)

    proj = settings.projection_type
    if proj == ProjectionType.PANINI:
        d = panini_dir(
            uv, settings.fov, settings.panini_distance,
            settings.vertical_compression,
        )
    elif proj == ProjectionType.PERSPECTIVE:
        d = pinhole_dir(uv, settings.fov)
    elif proj == ProjectionType.FISHEYE:
        d = fisheye_dir(uv, settings.fov)
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
        [lens * settings.circle_of_confusion, torch.zeros_like(lens[..., :1])],
        dim=-1,
    )
    focus = -d * det_div(settings.focus_distance, d[..., 2:3])
    d = normalize(focus - o)

    if proj == ProjectionType.ORTHOGRAPHIC:
        # cameraRayPosition (render.ts:724-729)
        fov_distance = settings.fov / math.pi * 4.0
        o = o + torch.cat([uv, torch.zeros_like(uv[..., :1])], dim=-1) * (
            fov_distance
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
