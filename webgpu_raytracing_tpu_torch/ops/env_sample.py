"""Environment importance sampling with multiple importance sampling
(counterpart of ``webgpu_raytracing_tpu/ops/env_sample.py``).

An equirect radiance map is sampled in proportion to luminance × sinθ: a
marginal CDF over rows, a conditional CDF per row, inverted per lane. The
environment strategy is combined with the cosine-sampled BSDF by the
balance heuristic (BASELINE config #3; the reference only evaluates its
skybox on BSDF-sampled misses, render.ts:1183-1186).

pdf bookkeeping (solid-angle measure): texel selection probability is
L·sinθ/Σ(L·sinθ) and a texel spans sinθ·2π²/(H·W), so sinθ cancels:
  p_env(texel y,x) = L(y,x) · (H·W) / (Σ(L·sinθ) · 2π²)
  p_bsdf(ω)        = max(cosθ_n, 0) / π

The tables are built on the host in numpy, as in the JAX package, without
its opt-in two-level column CDF (``EVSAMPLE_TWOLEVEL``), which that
package measured slower and which gives the same indices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import INV_PI, PI
from . import detmath, rng
from .envmap import equirect_uv
from .strictf import sdot3

# fields of EnvDistribution, in the JAX dataclass's order
ENV_FIELDS = ("img", "row_cdf", "cond_cdf", "lum", "total")


@dataclasses.dataclass(frozen=True)
class EnvDistribution:
    """Sampling tables for an equirect environment, on one device."""

    img: torch.Tensor  # (H, W, 3) radiance
    row_cdf: torch.Tensor  # (H,) inclusive marginal CDF over rows
    cond_cdf: torch.Tensor  # (H, W) inclusive conditional CDF per row
    lum: torch.Tensor  # (H, W) luminance (pdf numerator)
    total: torch.Tensor  # () Σ lum·sinθ (pdf normalizer)

    def to(self, device) -> "EnvDistribution":
        return EnvDistribution(
            **{k: getattr(self, k).to(device) for k in ENV_FIELDS}
        )


def build_env_distribution(img: np.ndarray, device="cpu") -> EnvDistribution:
    """Host-side table build from an (H, W, 3) equirect radiance map (the
    JAX package's arithmetic: f64 sums, f32 tables)."""
    img = np.asarray(img, np.float32)
    h = img.shape[0]
    lum = (
        0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    ).astype(np.float64)
    lum = np.maximum(lum, 1e-12)
    # v = 1 - acos(y)/π (envmap.py): row index v·H ⇒ θ = π(1 - (y+.5)/H)
    theta = np.pi * (1.0 - (np.arange(h) + 0.5) / h)
    sin_t = np.maximum(np.sin(theta), 1e-6)
    weighted = lum * sin_t[:, None]
    row_sum = weighted.sum(axis=1)
    total = row_sum.sum()
    row_cdf = np.cumsum(row_sum) / total
    cond_cdf = np.cumsum(weighted, axis=1) / row_sum[:, None]

    def t(a):
        # np.array, not np.ascontiguousarray: the latter makes 0-d 1-d
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return EnvDistribution(
        img=t(img),
        row_cdf=t(row_cdf.astype(np.float32)),
        cond_cdf=t(cond_cdf.astype(np.float32)),
        lum=t(lum.astype(np.float32)),
        total=t(np.asarray(total, np.float32)),
    )


def _invert_rows(cond_cdf: torch.Tensor, row: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Per lane, the count of entries < u in row ``row`` of the (H, W)
    conditional CDF, clipped to W-1: the JAX package's compare-count. The
    rows are monotone, so a bisection over gathered entries gives the same
    count without materializing an (R, W) gather (2.07M lanes × W=2048 is
    the allocation the JAX package records as out of memory)."""
    w = cond_cdf.shape[1]
    flat = cond_cdf.reshape(-1)
    base = row.long() * w
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, w)
    for _ in range(max(1, w).bit_length()):
        mid = (lo + hi) // 2
        less = flat[base + mid.clamp(max=w - 1)] < u
        go = (lo < hi) & less
        stay = (lo < hi) & ~less
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(stay, mid, hi)
    return lo.clamp(max=w - 1)


def sample_texel(
    dist: EnvDistribution, state: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw a texel per lane → (row, col, state)."""
    h = dist.img.shape[0]
    t2, state = rng.random_2(state)
    u1, u2 = t2[..., 0].contiguous(), t2[..., 1]
    # count of row-CDF entries < u1, clipped (searchsorted "left")
    row = torch.searchsorted(dist.row_cdf, u1, side="left").clamp(max=h - 1)
    return row, _invert_rows(dist.cond_cdf, row, u2), state


def sample_env(
    dist: EnvDistribution, state: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw (direction, radiance, pdf, state) per lane."""
    h, w = dist.img.shape[0], dist.img.shape[1]
    row, col, state = sample_texel(dist, state)

    vq = (row.to(torch.float32) + 0.5) / h
    uq = (col.to(torch.float32) + 0.5) / w
    theta = PI * (1.0 - vq)  # inverse of v = 1 - θ/π
    phi = uq * 2.0 * PI - PI  # inverse of u = (atan2(z,x)/π + 1)/2
    sin_t = torch.sin(theta)
    d = torch.stack(
        [sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)],
        dim=-1,
    )
    lum = dist.lum[row, col]
    pdf = lum / dist.total * (h * w) / (2.0 * PI * PI)
    radiance = dist.img[row, col]
    return d, radiance, pdf, state


def env_pdf(dist: EnvDistribution, d: torch.Tensor) -> torch.Tensor:
    """pdf of drawing direction d from the env distribution."""
    h, w = dist.img.shape[0], dist.img.shape[1]
    uv = equirect_uv(d)
    col = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
    return dist.lum[row, col] / dist.total * (h * w) / (2.0 * PI * PI)


def bsdf_pdf(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Cosine-hemisphere pdf around the (unnormalized-tolerant) normal n."""
    cos_t = sdot3(d, detmath.normalize(n))
    return torch.clamp(cos_t, min=0.0) * INV_PI


def balance_weight(p_self: torch.Tensor, p_other: torch.Tensor):
    return p_self / torch.clamp(p_self + p_other, min=1e-20)
