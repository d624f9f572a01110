"""The path integrator, wavefront form (counterpart of
``webgpu_raytracing_tpu/ops/integrator.py``; semantics of the reference's
``pixelColor``, render.ts:1167-1212).

The whole ray batch advances one path segment at a time with dead lanes
masked; RNG advances are masked per lane to replicate the SIMT draw order.
This slice covers the main path: closest-hit traces through the cluster
kernel, emission/albedo accumulation, cosine-weighted bounces, Russian
roulette and the deferred environment fetch. Next-event estimation and
environment importance sampling are later slices
(``config.check_supported`` refuses them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import F32_MAX, RenderSettings, ShadingType
from . import rng
from .cluster_cuda import trace_closest_clustered_cuda
from .envmap import sample_environment
from .intersect import Hit

_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def trace_closest(o, d, t_max, tables, settings, active=None, excl=None):
    """Closest-hit trace of one path segment: the cluster kernel for CUDA
    tensors, its plain twin for CPU tensors (ops/cluster_cuda.py). Bounce
    legs are traced unsorted: the JAX package's ray sort is a pure
    reordering with identical results."""
    return trace_closest_clustered_cuda(
        o, d, t_max, tables, active, excl_code=excl, tile=settings.trace_tile
    )


def offset_ray(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Self-intersection-safe point offset — the reference's WGSL verbatim
    (render.ts:905-917), with both of its inverted ``select`` conditions:
    a component that is exactly ±0 with an offset of the opposite sign
    becomes a NaN origin, which then misses everything (see the JAX
    package's docstring for why this is kept)."""
    of_i = (_INT_SCALE * n).to(torch.int32)  # truncates toward 0
    p_i = p.contiguous().view(torch.int32)
    p_int = (p_i + torch.where(p < 0.0, of_i, -of_i)).view(torch.float32)
    p_float = p + _FLOAT_SCALE * n
    return torch.where(torch.abs(p) < _ORIGIN, p_int, p_float)


def face_point(tri_row, u, v):
    """facePoint (render.ts:876-882): p0 + e1*u + e2*v, strict products."""
    p0 = tri_row[..., 0:3]
    e1 = tri_row[..., 3:6]
    e2 = tri_row[..., 6:9]
    return (p0 + e1 * u.unsqueeze(-1)) + e2 * v.unsqueeze(-1)


def face_point_offset(tri_row, shade_row, u, v):
    """facePointOffset (render.ts:883-889)."""
    return offset_ray(face_point(tri_row, u, v), shade_row[..., 0:3])


def face_normal(shade_row, u, v, shading: ShadingType):
    """faceNormal (render.ts:891-900); Phong interpolation is NOT
    normalized (parity with the WGSL)."""
    if shading == ShadingType.PHONG:
        n0 = shade_row[..., 3:6]
        n1 = shade_row[..., 6:9]
        n2 = shade_row[..., 9:12]
        w = (1.0 - u - v).unsqueeze(-1)
        return (n0 * w + n1 * u.unsqueeze(-1)) + n2 * v.unsqueeze(-1)
    return shade_row[..., 0:3]


class PathResult(NamedTuple):
    color: torch.Tensor  # (R, 3)
    state: torch.Tensor  # (R,) RNG state words
    first_hit: Hit  # primary-segment hit (G-buffer source)
    rays: torch.Tensor  # () f32: rays traced (bench accounting)


def path_trace(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max0: torch.Tensor,  # (R,) primary-segment bound
    state: torch.Tensor,  # (R,) RNG state words
    tables,
    env_data,
    settings: RenderSettings,
) -> PathResult:
    """pixelColor (render.ts:1167-1212), wavefront-unrolled."""
    r = o.shape[0]
    dev = o.device
    color = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((r, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    first_hit = None
    rays = torch.zeros((), dtype=torch.float32, device=dev)

    # deferred environment lookup: each lane misses at most once
    env_dir = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    env_w = torch.zeros((r, 3), dtype=torch.float32, device=dev)

    pc = tables.clusters.partner_code
    excl = None

    for seg in range(max(settings.bounces_depth - 1, 0)):
        rays = rays + alive.to(torch.float32).sum()
        t_max = (
            t_max0
            if seg == 0
            else torch.full((r,), F32_MAX, dtype=torch.float32, device=dev)
        )
        hit = trace_closest(o, d, t_max, tables, settings, alive, excl)
        if seg == 0:
            first_hit = hit

        found = hit.face >= 0
        miss = (alive & ~found).unsqueeze(-1)
        env_dir = torch.where(miss, d, env_dir)
        env_w = torch.where(miss, throughput, env_w)

        h = alive & found
        h3 = h.unsqueeze(-1)
        face = hit.face.clamp(min=0).long()
        mat = tables.face_material[face].long()
        emission = tables.mat_emission[mat]
        albedo = tables.mat_color[mat]
        color = torch.where(h3, color + emission * throughput, color)
        throughput = torch.where(h3, throughput * albedo, throughput)

        tri = tables.tri[face]
        shade = tables.shade_normal[face]
        n = face_normal(shade, hit.u, hit.v, settings.shading_type)
        new_o = face_point_offset(tri, shade, hit.u, hit.v)

        # rays leaving this vertex exclude the hit face's two-sided twin
        if pc is not None:
            excl = torch.where(h, pc[face], torch.full_like(hit.face, -1))

        t2, s2 = rng.random_2(state)
        state = rng.masked_advance(state, s2, h)
        new_d = rng.sample_cosine_weighted_hemisphere(t2, n)

        # russian roulette (render.ts:1201-1208)
        p = torch.amax(throughput, dim=-1)
        r1, s3 = rng.random_1(state)
        state = rng.masked_advance(state, s3, h)
        survive = r1 <= p
        throughput = torch.where(
            (h & survive).unsqueeze(-1),
            throughput / torch.clamp(p, min=1e-20).unsqueeze(-1),
            throughput,
        )

        alive = h & survive
        a3 = alive.unsqueeze(-1)
        o = torch.where(a3, new_o, o)
        d = torch.where(a3, new_d, d)

    env = sample_environment(env_data, env_dir, settings.environment)
    color = color + env * env_w

    if first_hit is None:
        first_hit = Hit(
            t=torch.full((r,), F32_MAX, dtype=torch.float32, device=dev),
            u=torch.zeros((r,), dtype=torch.float32, device=dev),
            v=torch.zeros((r,), dtype=torch.float32, device=dev),
            face=torch.full((r,), -1, dtype=torch.int32, device=dev),
        )
    return PathResult(color=color, state=state, first_hit=first_hit, rays=rays)
