"""Environment (skybox) sampling (counterpart of
``webgpu_raytracing_tpu/ops/envmap.py``): the nearest-texel equirect
fetch of the reference (render.ts:932-940), the cubemap fetch, and the
analytic procedural sky used when no environment asset is present.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INV_PI
from .strictf import fma


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def equirect_uv(d: torch.Tensor) -> torch.Tensor:
    """sampleSkybox uv mapping (render.ts:933-936)."""
    u = (torch.atan2(d[..., 2], d[..., 0]) * INV_PI + 1.0) * 0.5
    v = 1.0 - torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * INV_PI
    return torch.stack([u, v], dim=-1)


def sample_equirect(img: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Nearest-texel equirect fetch; img is (H, W, 3), v = 0 at row 0."""
    h, w = img.shape[0], img.shape[1]
    uv = equirect_uv(d)
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return img.reshape(-1, 3)[(y * w + x).long()]


def sample_cubemap(faces: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Cubemap fetch; faces is (6, S, S, 3) ordered +x,-x,+y,-y,+z,-z.
    Nearest texel."""
    s = faces.shape[1]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def sel(c, a, b):
        return torch.where(c, a, b)

    face = sel(
        is_x,
        sel(x > 0, torch.zeros_like(x), torch.ones_like(x)),
        sel(
            is_y,
            sel(y > 0, torch.full_like(y, 2), torch.full_like(y, 3)),
            sel(z > 0, torch.full_like(z, 4), torch.full_like(z, 5)),
        ),
    ).to(torch.int32)
    ma = torch.clamp(sel(is_x, ax, sel(is_y, ay, az)), min=1e-20)
    sc = sel(is_x, sel(x > 0, -z, z), sel(is_y, x, sel(z > 0, x, -x)))
    tc = sel(is_x, -y, sel(is_y, sel(y > 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    xi = torch.clamp((u * s).to(torch.int32), 0, s - 1)
    yi = torch.clamp((v * s).to(torch.int32), 0, s - 1)
    return faces.reshape(-1, 3)[((face * s + yi) * s + xi).long()]


# f32(1 / 0.0005): XLA's reciprocal form of the ramp's division
_INV_RAMP = float(np.float32(1.0) / np.float32(0.0005))


def procedural_sky(d: torch.Tensor) -> torch.Tensor:
    """Analytic clear-sky gradient + sun disc.

    The sun ramp ``(cos - 0.9995) / 0.0005 * 50`` turns one ulp of the
    dot product into about 6e-3 of radiance, so this follows the JAX
    function as XLA evaluates it under jit (its frames and goldens are
    jitted): the lerp and the dot product contracted to FMAs, the
    division by the constant as a product with its f32 reciprocal, and
    the final add contracted. Bit-identical to the jitted JAX function.
    """
    y = d[..., 1]
    horizon = _vec([0.85, 0.80, 0.75], d)
    zenith = _vec([0.25, 0.45, 0.85], d)
    tt = torch.clamp(y, 0.0, 1.0).unsqueeze(-1)
    sky = fma(horizon, 1.0 - tt, zenith * tt)
    ground = _vec([0.22, 0.2, 0.18], d)
    base = torch.where(y.unsqueeze(-1) < 0.0, ground, sky)
    s = 0.5773503
    cosang = fma(d[..., 2], s, fma(d[..., 1], s, d[..., 0] * s))
    sun = torch.clamp((cosang.unsqueeze(-1) - 0.9995) * _INV_RAMP, 0.0, 1.0)
    return fma(sun * 50.0, _vec([1.0, 0.95, 0.9], d), base)


def sample_environment(env_data, d: torch.Tensor, kind: str) -> torch.Tensor:
    """Dispatch on the environment kind."""
    if kind == "equirect":
        return sample_equirect(env_data, d)
    if kind == "cubemap":
        return sample_cubemap(env_data, d)
    if kind == "black":
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    if kind == "white":
        return torch.ones(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    return procedural_sky(d)
