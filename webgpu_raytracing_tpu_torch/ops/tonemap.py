"""Tonemapping library (shaders/tonemapping.ts:1-68), vectorized
(counterpart of ``webgpu_raytracing_tpu/ops/tonemap.py``)."""

from __future__ import annotations

import torch

from ..config import Tonemapping


def linear_to_srgb(x):
    rgb = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        rgb < 0.0031308, rgb * 12.92, torch.pow(rgb, 1.0 / 2.4) * 1.055 - 0.055
    )


def srgb_to_linear(x):
    rgb = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        rgb < 0.04045, rgb / 12.92, torch.pow((rgb + 0.055) / 1.055, 2.4)
    )


def aces(x):
    """Narkowicz 2015 ACES approximation (the published curve, ratio
    saturated — see the JAX package's note on the reference's variant)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def filmic(x):
    xx = torch.clamp(x - 0.004, min=0.0)
    r = (xx * (6.2 * xx + 0.5)) / (xx * (6.2 * xx + 1.7) + 0.06)
    return torch.pow(r, 2.2)


def lottes(x):
    a = 1.6
    d = 0.977
    hdr_max = 8.0
    mid_in = 0.18
    mid_out = 0.267
    b = (-(mid_in**a) + hdr_max**a * mid_out) / (
        (hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out
    )
    c = (
        hdr_max ** (a * d) * mid_in**a
        - hdr_max**a * mid_in ** (a * d) * mid_out
    ) / ((hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out)
    xs = torch.clamp(x, min=0.0)
    return torch.pow(xs, a) / (torch.pow(xs, a * d) * b + c)


def reinhard(x):
    return x / (1.0 + x)


def gamma(c, g):
    return torch.pow(torch.clamp(c, min=0.0), g)


def apply(x, mode: Tonemapping):
    """Tonemap dispatch (render.ts:220-232)."""
    if mode == Tonemapping.REINHARD:
        return reinhard(x)
    if mode == Tonemapping.FILMIC:
        return filmic(x)
    if mode == Tonemapping.ACES:
        return aces(x)
    if mode == Tonemapping.LOTTES:
        return lottes(x)
    return x
