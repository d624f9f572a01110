"""Screen-space bilinear samplers (counterpart of
``webgpu_raytracing_tpu/ops/sampling.py``; reference K11,
render.ts:1227-1334).

The reference fetches 4 texels at ``floor(uv)``, ``+1`` in x/y, and blends
with ``fract(uv)`` (bilinearInterpolation*, render.ts:1228-1254); its image
buffer carries a width+1 guard column so the +1 fetch never leaves the row
(render.ts:124-127). Here indices are clamped to the image bounds instead —
same values everywhere the reference is in-bounds."""

from __future__ import annotations

import torch

_I32_MAX = 2**31 - 1


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 → i32 as XLA converts (and the card's ``cvt.rzi``): toward zero,
    saturating at the int32 range, NaN → 0. PyTorch's own conversion on
    the CPU leaves out-of-range values undefined."""
    big = x >= 2.0**31
    safe = torch.where(big | torch.isnan(x), torch.zeros_like(x), x)
    xi = safe.clamp(min=-(2.0**31)).to(torch.int32)
    return torch.where(big, torch.full_like(xi, _I32_MAX), xi)


def _gather2d(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor):
    """img: (H, W, C); xi, yi: (...,) int32 clamped fetch."""
    h, w = img.shape[0], img.shape[1]
    xi = xi.clamp(0, w - 1)
    yi = yi.clamp(0, h - 1)
    flat = img.reshape(h * w, -1)
    return flat[(yi * w + xi).long()]


def sample_bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """img: (H, W, C), uv: (..., 2) in pixel units. Returns (..., C).

    Matches sampleImage4/sampleGeometryAll (render.ts:1301-1334): texels at
    floor(uv) + {0,1}², mixed by fract(uv)."""
    uv_f = torch.floor(uv)
    frac = uv - uv_f
    x0 = to_int32(uv_f[..., 0])
    y0 = to_int32(uv_f[..., 1])
    p00 = _gather2d(img, x0, y0)
    p10 = _gather2d(img, x0 + 1, y0)
    p01 = _gather2d(img, x0, y0 + 1)
    p11 = _gather2d(img, x0 + 1, y0 + 1)
    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    # bilinearInterpolation (render.ts:1228-1233), with the reference's
    # column order quirk, as the JAX package writes it
    col_x = p00 * (1 - fx) + p01 * fx
    col_y = p10 * (1 - fx) + p11 * fx
    return col_x * (1 - fy) + col_y * fy
