"""Temporal reprojection (counterpart of
``webgpu_raytracing_tpu/ops/reproject.py``; reference K10:
render.ts:1009-1118 + the frustum-plane matrix store.ts:129-179, after
Jacco Bikker's method).

``reprojection_frustum`` builds a 4×3 matrix of scaled frustum-plane
normals from the previous frame's view matrix (host numpy, the same bits
as the JAX package's); ``reproject_point`` projects a world-space hit point
into previous-frame pixel coordinates as two plane-distance ratios.
Validation compares the candidate's previous-frame G-buffer position to the
point; on mismatch a *stochastic local search* (128 probes with a
shrinking step) hunts for the true source pixel, masked per lane so that
each lane draws from its RNG stream only while it searches, as the
reference's data-dependent loop does (render.ts:1079-1094). An optional
5×5 bilateral filter blends neighbors by position+color distance
(render.ts:1027-1059).

Every product and sum is a separate f32 operation in the JAX package's
order (its eager evaluation), so the results are the JAX package's bit for
bit, but for the bilateral weights' ``exp``, which rounds differently
across libraries (at most one ulp apart; results below the least normal
f32 are flushed to 0 here as XLA's ``exp`` flushes them).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import F32_MIN, RenderSettings
from . import rng
from .sampling import sample_bilinear
from .strictf import sdot3

REPROJECT_THRESHOLD = 1e-8  # render.ts:1062
_BILATERAL_RADIUS = 2
_BILATERAL_SIGMA_POS = 0.01
_BILATERAL_SIGMA_COLOR = 0.01
_BILATERAL_STEP = 0.1
_SEARCH_PROBES = 128
_SEARCH_BLOCK = 16  # probes per step size


def reprojection_frustum(
    prev_view: np.ndarray, width: int, height: int, fov: float
) -> np.ndarray:
    """store.ts:129-179 → (4, 3) matrix of scaled frustum-plane normals
    for the previous view (host math, float32). Rows: [n_left·W,
    n_bottom·H, n_left+n_right, n_bottom+n_top]; row k dotted with
    (p - prev_view_translation) gives plane distances whose ratios
    d1/(d1+d2) are the previous-frame pixel coordinates.

    As in the JAX package, the plane sums are computed exactly from the
    corner rays (the reference's ``forward·(-2·cos(fov))`` scaling,
    store.ts:167-168, is off by tan(60°) at the default FoV)."""
    view = np.asarray(prev_view, dtype=np.float64)
    aspect = height / width
    hfov = fov / 2.0
    tan_hfov = np.tan(hfov)
    w = view[3, 3]
    ray_z = -w / tan_hfov

    def corner_ray(x: float, y: float) -> np.ndarray:
        d = np.array([x, y * aspect, ray_z])
        d = d / np.linalg.norm(d)
        return view[:3, :3] @ d

    # the four frustum side planes through the camera origin; normals
    # point into the frustum
    c_mm, c_pm = corner_ray(-1, -1), corner_ray(1, -1)
    c_mp, c_pp = corner_ray(-1, 1), corner_ray(1, 1)

    def plane(a, b):
        n = np.cross(a, b)
        return n / np.linalg.norm(n)

    n_left = plane(c_mm, c_mp)  # x = -1 edge (pixel x = 0)
    n_right = plane(c_pp, c_pm)  # x = +1 edge
    n_bottom = plane(c_pm, c_mm)  # y = -1 edge (pixel y = 0)
    n_top = plane(c_mp, c_pp)  # y = +1 edge

    return np.stack(
        [
            n_left * width,
            n_bottom * height,
            n_left + n_right,
            n_bottom + n_top,
        ]
    ).astype(np.float32)


def reproject_point(
    p: torch.Tensor,  # (R, 3) world point
    frustum: torch.Tensor,  # (4, 3)
    prev_origin: torch.Tensor,  # (3,) prev view matrix translation column
) -> torch.Tensor:
    """reprojectPoint (render.ts:1022-1025): duv = M (p - o);
    uv = duv.xy / duv.zw. The product is summed left to right, each term
    rounded, as the JAX package's ``rel @ frustum.T`` evaluates eagerly."""
    rel = p - prev_origin[None, :]
    m = frustum.T  # (3, 4)
    duv = (rel[:, 0:1] * m[0] + rel[:, 1:2] * m[1]) + rel[:, 2:3] * m[2]
    return duv[..., 0:2] / duv[..., 2:4]


class ReprojectionResult(NamedTuple):
    color: torch.Tensor  # (R, 4): color sum + sample count (0 = rejected)


def bilateral_filter(
    uv: torch.Tensor,  # (R, 2)
    p: torch.Tensor,  # (R, 3)
    c: torch.Tensor,  # (R, 3)
    prev_image: torch.Tensor,  # (H, W, 4)
    prev_geo_position: torch.Tensor,  # (H, W, 3)
) -> torch.Tensor:
    """render.ts:1031-1059 — 5×5 taps at 0.1-pixel pitch, weights from
    squared position and color distance."""
    dev = uv.device
    color = torch.zeros(uv.shape[:-1] + (4,), dtype=torch.float32,
                        device=dev)
    weight = torch.zeros(uv.shape[:-1] + (1,), dtype=torch.float32,
                         device=dev)
    step = torch.tensor(_BILATERAL_STEP, dtype=torch.float32)
    for i in range(-_BILATERAL_RADIUS, _BILATERAL_RADIUS + 1):
        for j in range(-_BILATERAL_RADIUS, _BILATERAL_RADIUS + 1):
            off = (torch.tensor([i, j], dtype=torch.float32) * step).to(dev)
            tap = uv + off
            tap_color = sample_bilinear(prev_image, tap)
            valid = tap_color[..., 3:4] > 0.0
            tap_pos = sample_bilinear(prev_geo_position, tap)
            dp = p - tap_pos
            dc = c - tap_color[..., :3] / torch.clamp(
                tap_color[..., 3:4], min=1e-20
            )
            w = torch.exp(
                -sdot3(dp, dp).unsqueeze(-1) / _BILATERAL_SIGMA_POS
                - sdot3(dc, dc).unsqueeze(-1) / _BILATERAL_SIGMA_COLOR
            )
            w = torch.where(valid & (w >= F32_MIN), w, torch.zeros_like(w))
            color = color + tap_color * w
            weight = weight + w
    return torch.where(
        weight > 0.0, color / torch.clamp(weight, min=1e-20),
        torch.zeros_like(color),
    )


def _search_steps(dev) -> torch.Tensor:
    """The probe step of each block of 16 (render.ts:1085-1087 shrinks it
    ON i % 16 == 0, i = 0 included, so probes 0-15 already use 0.095), in
    f32 as the JAX package computes ``0.1 - 0.005 * (i // 16 + 1)``."""
    k = np.arange(1, _SEARCH_PROBES // _SEARCH_BLOCK + 1, dtype=np.float32)
    steps = np.float32(0.1) - np.float32(0.005) * k
    return torch.from_numpy(steps).to(dev)


def reproject(
    p: torch.Tensor,  # (R, 3) current hit points
    c: torch.Tensor,  # (R, 3) current color (bilateral reference)
    state: torch.Tensor,  # (R,) RNG state words
    frustum: torch.Tensor,  # (4, 3)
    prev_origin: torch.Tensor,  # (3,)
    prev_image: torch.Tensor,  # (H, W, 4)
    prev_geo_position: torch.Tensor,  # (H, W, 3)
    settings: RenderSettings,
):
    """reproject (render.ts:1064-1117). Returns ((R, 4) color+count with
    0-count meaning rejected, new rng state). Debug tints
    (debug_reprojection) follow the reference's false-coloring."""
    width = float(settings.render_width)
    height = float(settings.render_height)
    uv = reproject_point(p, frustum, prev_origin)
    inside = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 0] <= width)
        & (uv[..., 1] <= height)
    )

    def dist2(cand_uv):
        dp = sample_bilinear(prev_geo_position, cand_uv) - p
        return sdot3(dp, dp)

    min_uv, d = uv, dist2(uv)
    # stochastic local search (render.ts:1079-1094): 128 probes, the step
    # shrinking every 16; the reference returns before the search for
    # out-of-viewport pixels (render.ts:1067-1073), so no draws there
    steps = _search_steps(p.device)
    for i in range(_SEARCH_PROBES):
        t2, st2 = rng.random_2(state)
        active = inside & (d >= REPROJECT_THRESHOLD)
        state = rng.masked_advance(state, st2, active)
        cand = min_uv - rng.sample_insquare(t2) * steps[i // _SEARCH_BLOCK]
        cd = dist2(cand)
        better = active & (cd < d)
        min_uv = torch.where(better[..., None], cand, min_uv)
        d = torch.where(better, cd, d)

    converged = d < REPROJECT_THRESHOLD

    if settings.debug_reprojection:
        # outside → green; unconverged → red(d); converged → uv tint
        ones = torch.ones_like(min_uv[..., :1])
        tint = torch.cat(
            [min_uv / 4.0 - torch.trunc(min_uv / 4.0), ones, ones], dim=-1
        )
        zeros = torch.zeros_like(d)
        red = torch.stack([d, zeros, zeros, torch.ones_like(d)], dim=-1)
        green = torch.tensor([0.0, 1.0, 0.0, 1.0], device=p.device).expand(
            p.shape[:-1] + (4,)
        )
        out_col = torch.where(
            inside[..., None],
            torch.where(converged[..., None], tint, red),
            green,
        )
        return ReprojectionResult(out_col), state

    if settings.bilateral_filter:
        filtered = bilateral_filter(
            min_uv, p, c, prev_image, prev_geo_position
        )
        fallback = sample_bilinear(prev_image, min_uv)
        color = torch.where(filtered[..., 3:4] > 0.0, filtered, fallback)
    else:
        color = sample_bilinear(prev_image, min_uv)

    ok = (inside & converged)[..., None]
    return ReprojectionResult(
        torch.where(ok, color, torch.zeros_like(color))
    ), state
