"""Screen-space quad derivatives (counterpart of
``webgpu_raytracing_tpu/ops/derivatives.py``; reference K12,
render.ts:943-1007).

The WGSL differences values across 2×2 quads with subgroup
``quadSwapX`` / ``quadSwapY``; here a quad swap is a flip within the even
/ odd pixel pairs of an (H, W, ...) tensor. Both lanes of a pair carry the
same forward difference, as in the reference."""

from __future__ import annotations

import torch


def quad_swap_x(v: torch.Tensor) -> torch.Tensor:
    """Swap each pixel with its horizontal quad partner; v is (H, W, ...)."""
    h, w = v.shape[0], v.shape[1]
    return v.reshape(h, w // 2, 2, *v.shape[2:]).flip(2).reshape(v.shape)


def quad_swap_y(v: torch.Tensor) -> torch.Tensor:
    """Swap each pixel with its vertical quad partner."""
    h, w = v.shape[0], v.shape[1]
    return v.reshape(h // 2, 2, w, *v.shape[2:]).flip(1).reshape(v.shape)


def _lane_sign(n: int, axis: int, ndim: int, like: torch.Tensor):
    """-1 on the even lanes of ``axis``, +1 on the odd ones, shaped to
    broadcast over an ``ndim``-d tensor."""
    sign = torch.where(torch.arange(n, device=like.device) % 2 == 0, -1.0, 1.0)
    shape = [1] * ndim
    shape[axis] = n
    return sign.to(like.dtype).reshape(shape)


def dfdx(v: torch.Tensor) -> torch.Tensor:
    """dFdx1..4 (render.ts:944-998): p - quadSwapX(p), negated on the even
    lane so both lanes carry right minus left."""
    return (v - quad_swap_x(v)) * _lane_sign(v.shape[1], 1, v.ndim, v)


def dfdy(v: torch.Tensor) -> torch.Tensor:
    """dFdy1..4: p - quadSwapY(p), negated on the top lane."""
    return (v - quad_swap_y(v)) * _lane_sign(v.shape[0], 0, v.ndim, v)
