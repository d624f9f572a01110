"""Ray–primitive intersection, vectorized over ray batches (counterpart of
``webgpu_raytracing_tpu/ops/intersect.py``, render.ts:346-431).

Möller–Trumbore with backface culling (``det < EPSILON²`` rejects), the
barycentric gates tested against ``det`` before the division, a true f32
division and a strict ``t`` interval; and the AABB slab test of the
threaded walk (ops/traverse.py), with the JAX package's fix of the
reference's ``intervalOverlap`` OR-quirk (``far > MIN_DIST`` is required
too; ops/interval.py keeps the quirk).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EPSILON, F32_MAX, MIN_DIST
from .strictf import scross, sdot3


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) f32; best hit distance (incoming t_max on a miss)
    u: torch.Tensor  # (R,) f32 barycentric
    v: torch.Tensor  # (R,) f32 barycentric
    face: torch.Tensor  # (R,) i32 global face index, -1 on miss

    @property
    def hit(self):
        return self.face >= 0


class TriangleHit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def ray_triangle(o, d, p0, e1, e2, t_min, t_max) -> TriangleHit:
    """Möller–Trumbore with backface culling (render.ts:359-409)."""
    h = scross(d, e2)
    det = sdot3(e1, h)
    s = o - p0
    u = sdot3(s, h)
    q = scross(s, e1)
    v = sdot3(d, q)
    t = sdot3(e2, q)

    culled = det < EPSILON * EPSILON
    bary_ok = (u >= 0.0) & (u <= det) & (v >= 0.0) & (u + v <= det)
    det_safe = torch.where(culled, torch.ones_like(det), det)
    tt = t / det_safe
    uu = u / det_safe
    vv = v / det_safe
    inside = (tt > t_min) & (tt < t_max)
    hit = (~culled) & bary_ok & inside
    return TriangleHit(
        hit=hit,
        t=torch.where(hit, tt, torch.full_like(tt, F32_MAX)),
        u=torch.where(hit, uu, torch.zeros_like(uu)),
        v=torch.where(hit, vv, torch.zeros_like(vv)),
    )


def ray_aabb(o, inv_d, bmin, bmax, t_max):
    """Branchless slab test (render.ts:419-430) of (R, 3) rays against
    (R, 3) boxes → (hit, near): the box is entered before ``t_max`` and
    left after ``MIN_DIST``. ``inv_d`` is :func:`safe_inv_dir` of the
    directions."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (near < far) & (near < t_max) & (far > MIN_DIST)
    return hit, near


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """NaN-safe direction reciprocal for slab tests: components with
    ``|d| < 1e-12`` become ±1e30 instead of ±inf."""
    small = torch.abs(d) < 1e-12
    big = torch.where(
        d >= 0, torch.full_like(d, 1e30), torch.full_like(d, -1e30)
    )
    return torch.where(small, big, 1.0 / torch.where(small, torch.ones_like(d), d))
