"""The path integrator, wavefront form (counterpart of
``webgpu_raytracing_tpu/ops/integrator.py``; semantics of the reference's
``pixelColor``, render.ts:1167-1212).

The whole ray batch advances one path segment at a time with dead lanes
masked; RNG advances are masked per lane to replicate the SIMT draw order.
Closest-hit legs go through the cluster kernel's closest-hit entry, or
its exact-pairs entry and the exact adjudication with ``exact_pairs``,
and shadow legs through its any-hit entry (ops/cluster_cuda.py); by
default (``kernel_near``) every tile orders its boxes inside the kernel,
K2n on single-level tables and K3 on two-level ones. Here:
emission/albedo accumulation, cosine-weighted bounces, Russian roulette,
the deferred environment fetch, next-event estimation of the lights
(``sampleLights`` → ``pointColor``, render.ts:849-869 and 1143-1157, dead
code in the reference and live here as in the JAX package), environment
importance sampling with MIS (ops/env_sample.py), and the direct-lighting
integrator :func:`trace_direct` (BASELINE config #1).

With ``sort_bounce_rays`` the bounce and shadow legs of every segment
past the first go through the ray sort (ops/ray_sort.py), a pure
reordering with identical results; on single-level tables ``binned_sort``,
``binned_any_sort`` and ``multipass_cap`` route those legs through the
per-ray-scheduled traces of that module instead, again with identical
results. With ``chained_sort`` as well, the whole path state is permuted
once per segment instead and one scatter restores pixel order at the end
(:func:`path_trace`).

``traversal`` picks the backend of every leg, as the JAX dispatch does
(``_resolve_backend``, ``_trace_closest``, ``_trace_any``): the kernels or
their twins (``"auto"``, ``"pallas"``, ``"pallas_interpret"``: ROUTES of
ops/cluster_cuda.py), the clustered oracle (ops/cluster_trace.py) or the
threaded one (ops/traverse.py), which returns before any sort or
exact-pairs step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..config import F32_MAX, INV_PI, RenderSettings, ShadingType
from ..utils.timing import count, span, traced
from . import detmath, ray_sort, rng, traverse
from ._build import Kernel, check_args, launch, pointer_block
from .adjudicate import adjudicate_compact
from .cluster_cuda import (
    trace_any_clustered_cuda,
    trace_closest_clustered_cuda,
)
from .cluster_trace import (
    rederive_uv,
    trace_any_clustered,
    trace_closest_clustered,
)
from .env_sample import (
    EnvDistribution,
    balance_weight,
    bsdf_pdf,
    env_pdf,
    sample_env,
)
from .envmap import sample_environment
from .intersect import Hit
from .ray_sort import (
    binned_trace,
    binned_trace_any,
    sorted_trace,
    sorted_trace_multipass,
)
from .strictf import scross, sdot3

_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


# traversal → the kernel wrappers' route (ops/cluster_cuda.py ROUTES)
_ROUTES = {"auto": "auto", "pallas": "kernel", "pallas_interpret": "twin"}


def _kernel_settings(settings) -> dict:
    """The tile-scheduling settings and the route as the dispatchers take
    them."""
    return dict(tile=settings.trace_tile, kernel_near=settings.kernel_near,
                pipelined=settings.pipeline_rounds,
                route=_ROUTES[settings.traversal])


def _per_ray_schedulable(tables) -> bool:
    """Whether the binned and multipass traces apply: their keys, skip
    masks and schedules are over the cluster boxes, so the tables must
    have no supercluster level (the JAX package's rule; stricter here in
    that tables whose supers are too large for the two-level kernel also
    keep the plain sorted trace, whose key is over those supers)."""
    return tables.clusters.super_box is None


@traced("wrt.trace")
def trace_closest(o, d, t_max, tables, settings, active=None, excl=None,
                  primary=False, sort=False, seg=0):
    """Closest-hit trace of one path segment: the cluster kernels for CUDA
    tensors, their plain twins for CPU tensors (ops/cluster_cuda.py;
    ``trace_sched``, ``kernel_near`` and ``pipeline_rounds`` pick the
    kernel). ``primary`` marks camera-ray segments: the exact-pairs route
    (``exact_pairs``) always applies there, and on bounce segments only
    with ``exact_pairs_bounce``.

    ``sort`` (bounce segments) routes the leg through the ray sort
    (ops/ray_sort.py) when ``sort_bounce_rays`` is set, as the JAX
    ``_trace_closest`` does: only (t, face) are unsorted and t, u, v are
    re-derived in the original order; with ``live_slice`` segment 1
    traces the leading 0.75 of the sorted rays and later segments 0.5,
    the rest being known misses; an exact leg unsorts its three candidate
    faces and the flag and adjudicates in the original order.

    A sorted leg that is not exact, on single-level tables, takes
    :func:`.ray_sort.binned_trace` with ``binned_sort`` (K4, then the
    drain kernel that ``kernel_near`` and ``pipeline_rounds`` pick; never
    K5), else :func:`.ray_sort.sorted_trace_multipass` with
    ``multipass_cap`` > 0 when the kernel can cap (K1: ``kernel_near``
    False, and no ``trace_sched`` or ``pipeline_rounds``). Otherwise, and
    always on two-level tables, the plain sorted trace runs.

    ``traversal="threaded"`` walks the BVH (ops/traverse.py) with no sort,
    exclusion or exact-pairs step; ``"clustered"`` runs the clustered
    oracle, sorted on bounce legs with ``sort_bounce_rays`` (every output
    unsorted, no live slice) and never exact, as in the JAX package."""
    if settings.traversal == "threaded":
        return traverse.trace_closest(o, d, t_max, tables, active)
    if settings.traversal == "clustered":
        fn = functools.partial(trace_closest_clustered,
                               tile=settings.trace_tile)
        if sort and settings.sort_bounce_rays:  # the oracle: no kernel
            return Hit(*sorted_trace(fn, o, d, t_max, tables, active,
                                     route="twin"))
        return fn(o, d, t_max, tables, active)
    exact = settings.exact_pairs and (primary or settings.exact_pairs_bounce)
    kw = dict(sched_rounds=settings.trace_sched, **_kernel_settings(settings))
    if not (sort and settings.sort_bounce_rays):
        return trace_closest_clustered_cuda(
            o, d, t_max, tables, active, excl_code=excl, exact_pairs=exact,
            **kw,
        )

    def tf(o_, d_, tm_, tb_, act_, ex_=None):
        out = trace_closest_clustered_cuda(
            o_, d_, tm_, tb_, act_, excl_code=ex_, exact_pairs=exact,
            raw=True, **kw,
        )
        return out[1:] if exact else out

    if exact:
        f1, f2, f3, amb = sorted_trace(tf, o, d, t_max, tables, active,
                                       extra=excl, route=kw["route"])
        tm_eff = t_max if active is None else torch.where(
            active, t_max, torch.zeros_like(t_max)
        )
        return adjudicate_compact(o, d, tm_eff, tm_eff, (f1, f2, f3), amb,
                                  tables)
    if _per_ray_schedulable(tables):
        # the drain of both traces: the dispatcher itself, which takes
        # their hooks by keyword and returns codes for the next pass
        drain = functools.partial(trace_closest_clustered_cuda, raw="code",
                                  **_kernel_settings(settings))
        if settings.binned_sort:
            t, face = binned_trace(drain, o, d, t_max, tables, active,
                                   extra=excl, route=kw["route"])
            return rederive_uv(o, d, t, face, tables)
        if settings.multipass_cap > 0 and not (
            settings.trace_sched or settings.kernel_near
            or settings.pipeline_rounds
        ):
            t, face = sorted_trace_multipass(
                drain, o, d, t_max, tables, active, extra=excl,
                cap=settings.multipass_cap, passes=settings.multipass_passes,
                route=kw["route"])
            return rederive_uv(o, d, t, face, tables)
    ls = None
    if settings.live_slice and seg > 0:
        ls = 0.75 if seg == 1 else 0.5

    def miss_tail(tm_tail):
        return tm_tail, torch.full_like(tm_tail, -1, dtype=torch.int32)

    t, face = sorted_trace(tf, o, d, t_max, tables, active, extra=excl,
                           live_slice=ls, tail=miss_tail, route=kw["route"])
    return rederive_uv(o, d, t, face, tables)


@traced("wrt.trace")
def trace_any(o, d, t_max, tables, settings, active=None, excl=None,
              sort=False, seg=0):
    """Shadow-ray trace → (R,) bool blocked: the kernels' any-hit entries
    for CUDA tensors, their plain twins for CPU tensors. Rays leaving a
    two-sided face exclude its duplicate by code, as the Pallas path
    does. ``sort`` as in :func:`trace_closest` (JAX ``_trace_any``): with
    ``live_slice`` segment 1 traces the leading 0.375 of the sorted rays
    and later segments 0.25; the rest is unblocked. With ``binned_sort``
    or ``binned_any_sort``, on single-level tables, a sorted leg takes
    :func:`.ray_sort.binned_trace_any` instead. ``traversal`` as in
    :func:`trace_closest`; the clustered oracle takes no exclusion codes
    (exact arithmetic rejects the duplicate by t > 0)."""
    if settings.traversal == "threaded":
        return traverse.trace_any(o, d, t_max, tables, active)
    key_route = _ROUTES.get(settings.traversal, "twin")  # the oracle: twin
    if settings.traversal == "clustered":
        excl = None

        def fn(o_, d_, tm_, tb_, act_, ex_=None):
            return trace_any_clustered(o_, d_, tm_, tb_, act_,
                                       tile=settings.trace_tile)
    else:
        kw = _kernel_settings(settings)

        def fn(o_, d_, tm_, tb_, act_, ex_=None):
            return trace_any_clustered_cuda(o_, d_, tm_, tb_, act_,
                                            excl_code=ex_, **kw)

        if (sort and settings.sort_bounce_rays
                and (settings.binned_sort or settings.binned_any_sort)
                and _per_ray_schedulable(tables)):
            return binned_trace_any(
                functools.partial(trace_any_clustered_cuda, **kw), o, d,
                t_max, tables, active, extra=excl, route=kw["route"])
    if not (sort and settings.sort_bounce_rays):
        return fn(o, d, t_max, tables, active, excl)
    ls = None
    if settings.live_slice and seg > 0:
        ls = 0.375 if seg == 1 else 0.25

    def clear_tail(tm_tail):
        return torch.zeros_like(tm_tail, dtype=torch.bool)

    return sorted_trace(fn, o, d, t_max, tables, active, extra=excl,
                        live_slice=ls, tail=clear_tail, route=key_route)


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


def offset_ray_paper(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The Ray Tracing Gems ch. 6 offset as published, both selects the
    paper's way round: not the reference's behaviour; kept for tests and
    as the record of the reference's bug."""
    of_i = (_INT_SCALE * n).to(torch.int32)
    p_i = p.contiguous().view(torch.int32)
    p_int = (p_i + torch.where(p < 0.0, -of_i, of_i)).view(torch.float32)
    p_float = p + _FLOAT_SCALE * n
    return torch.where(torch.abs(p) < _ORIGIN, p_float, p_int)


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


class HitShading(NamedTuple):
    """:func:`shade_hit`'s outputs, in the order of ``ShadeHitArgs``'s
    outputs (``csrc/shade.cuh``)."""

    color: torch.Tensor  # (R, 3)
    throughput: torch.Tensor  # (R, 3)
    env_dir: torch.Tensor  # (R, 3) the deferred environment's direction
    env_w: torch.Tensor  # (R, 3) and weight
    env_mis_pdf: torch.Tensor  # (R,)
    n: torch.Tensor  # (R, 3) the shading normal
    new_o: torch.Tensor  # (R, 3) the offset hit point
    excl: Optional[torch.Tensor]  # (R,) i32 the twin face's code, or None
    h: torch.Tensor  # (R,) bool: alive and hit


class Bounce(NamedTuple):
    """:func:`shade_bounce`'s outputs, in the order of
    ``ShadeBounceArgs``'s outputs."""

    state: torch.Tensor  # (R,) i64
    throughput: torch.Tensor  # (R, 3)
    alive: torch.Tensor  # (R,) bool
    o: torch.Tensor  # (R, 3)
    d: torch.Tensor  # (R, 3)
    prev_bsdf_pdf: torch.Tensor  # (R,)


def _shade_hit_torch(hit, alive, d, color, throughput, env_dir, env_w,
                     env_mis_pdf, prev_bsdf_pdf, tables, shading,
                     env_mis) -> HitShading:
    """The plain twin of ``wrt_shade_hit``: eager ops, one rounding each."""
    found = hit.face >= 0
    miss = alive & ~found
    with span("wrt.env"):
        env_dir = torch.where(miss.unsqueeze(-1), d, env_dir)
        env_w = torch.where(miss.unsqueeze(-1), throughput, env_w)
        if env_mis:
            # the previous vertex also env-NEE'd: weigh the BSDF strategy
            env_mis_pdf = torch.where(miss, prev_bsdf_pdf, env_mis_pdf)

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
    n = face_normal(shade, hit.u, hit.v, shading)
    new_o = face_point_offset(tri, shade, hit.u, hit.v)

    # rays leaving this vertex (shadow and bounce) exclude the hit face's
    # two-sided twin
    pc = tables.clusters.partner_code
    excl = None
    if pc is not None:
        excl = torch.where(h, pc[face], torch.full_like(hit.face, -1))
    return HitShading(color, throughput, env_dir, env_w, env_mis_pdf, n,
                      new_o, excl, h)


def _shade_bounce_torch(state, h, n, new_o, throughput, o, d, prev_bsdf_pdf,
                        env_is, run_env) -> Bounce:
    """The plain twin of ``wrt_shade_bounce``: eager ops, one rounding
    each."""
    t2, s2 = rng.random_2(state)
    state = rng.masked_advance(state, s2, h)
    new_d = rng.sample_cosine_weighted_hemisphere(t2, n)
    if env_is:
        # -1: the deferred env fetch applies weight 1 (no env-NEE
        # competed at this vertex)
        with span("wrt.env"):
            pv = (
                bsdf_pdf(new_d, n)
                if run_env
                else torch.full((n.shape[0],), -1.0, dtype=torch.float32,
                                device=n.device)
            )
            prev_bsdf_pdf = torch.where(h, pv, prev_bsdf_pdf)

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
    return Bounce(state, throughput, alive, o, d, prev_bsdf_pdf)


def _shade_hit_buffers(hit, alive, d, color, throughput, env_dir, env_w,
                       env_mis_pdf, prev_bsdf_pdf, tables, env_mis):
    """``wrt_shade_hit``'s arguments checked, its outputs allocated →
    (the outputs, the pointer block in ``ShadeHitArgs``'s order, the
    tensors it points to)."""
    dev = d.device
    r, n_f, k = d.shape[0], tables.tri.shape[0], tables.mat_color.shape[0]
    f32, i32 = torch.float32, torch.int32
    pc = tables.clusters.partner_code
    ins = check_args("shading", dev, [
        ("face", hit.face, i32, (r,)), ("u", hit.u, f32, (r,)),
        ("v", hit.v, f32, (r,)), ("alive", alive, torch.bool, (r,)),
        ("d", d, f32, (r, 3)), ("color", color, f32, (r, 3)),
        ("throughput", throughput, f32, (r, 3)),
        ("env_dir", env_dir, f32, (r, 3)), ("env_w", env_w, f32, (r, 3)),
        ("env_mis_pdf", env_mis_pdf, f32, (r,)),
        ("prev_bsdf_pdf", prev_bsdf_pdf if env_mis else None, f32, (r,)),
        ("face_material", tables.face_material, i32, (n_f,)),
        ("mat_emission", tables.mat_emission, f32, (k, 3)),
        ("mat_color", tables.mat_color, f32, (k, 3)),
        ("tri", tables.tri, f32, (n_f, 9)),
        ("shade_normal", tables.shade_normal, f32, (n_f, 12)),
        ("partner_code", pc, i32, (n_f,)),
    ], copy=True)

    def new(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = HitShading(
        color=new(r, 3), throughput=new(r, 3), env_dir=new(r, 3),
        env_w=new(r, 3), env_mis_pdf=new(r) if env_mis else env_mis_pdf,
        n=new(r, 3), new_o=new(r, 3),
        excl=None if pc is None else new(r, dtype=i32),
        h=new(r, dtype=torch.bool))
    outs = list(out)
    if not env_mis:
        outs[4] = None  # not written: the input passes through
    return out, pointer_block(ins + outs), ins + outs


def _shade_bounce_buffers(state, h, n, new_o, throughput, o, d,
                          prev_bsdf_pdf, env_is):
    """``wrt_shade_bounce``'s arguments checked, its outputs allocated, as
    :func:`_shade_hit_buffers`."""
    dev = d.device
    r = d.shape[0]
    f32 = torch.float32
    ins = check_args("shading", dev, [
        ("state", state, torch.int64, (r,)), ("h", h, torch.bool, (r,)),
        ("n", n, f32, (r, 3)), ("new_o", new_o, f32, (r, 3)),
        ("throughput", throughput, f32, (r, 3)), ("o", o, f32, (r, 3)),
        ("d", d, f32, (r, 3)),
        ("prev_bsdf_pdf", prev_bsdf_pdf if env_is else None, f32, (r,)),
    ], copy=True)

    def new(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Bounce(
        state=new(r, dtype=torch.int64), throughput=new(r, 3),
        alive=new(r, dtype=torch.bool), o=new(r, 3), d=new(r, 3),
        prev_bsdf_pdf=new(r) if env_is else prev_bsdf_pdf)
    outs = list(out)
    if not env_is:
        outs[5] = None
    return out, pointer_block(ins + outs), ins + outs


def _launch_shade_hit(hit, alive, d, color, throughput, env_dir, env_w,
                      env_mis_pdf, prev_bsdf_pdf, tables, shading, env_mis):
    out, block, keep = _shade_hit_buffers(
        hit, alive, d, color, throughput, env_dir, env_w, env_mis_pdf,
        prev_bsdf_pdf, tables, env_mis)
    launch("shading", "wrt_shade_hit", d.device, block,
           int(shading == ShadingType.PHONG), int(env_mis), d.shape[0])
    count("shade.kernel_launches", 1)
    return out


def _launch_shade_bounce(state, h, n, new_o, throughput, o, d,
                         prev_bsdf_pdf, env_is, run_env):
    out, block, keep = _shade_bounce_buffers(
        state, h, n, new_o, throughput, o, d, prev_bsdf_pdf, env_is)
    launch("shading", "wrt_shade_bounce", d.device, block, int(env_is),
           int(run_env), d.shape[0])
    count("shade.kernel_launches", 1)
    return out


shade_hit = Kernel(
    "shade_hit", _shade_hit_torch, _launch_shade_hit, "shading",
    "A segment's hit, after its closest-hit trace (hit, alive, d, color, "
    "throughput, env_dir, env_w, env_mis_pdf, prev_bsdf_pdf, tables, "
    "shading, env_mis) → HitShading: the deferred environment's direction "
    "and weight on lanes that miss now (and, with ``env_mis``, env-IS past "
    "the first segment, the BSDF pdf its fetch weighs by), emission and "
    "albedo on lanes that hit, the shading normal, the offset origin of "
    "the rays that leave, and their exclusion code; outputs are new "
    "tensors. The kernel is ``wrt_shade_hit`` (``csrc/shade.cu``), its "
    "launches also counted in the frame's ``shade.kernel_launches``.")
shade_bounce = Kernel(
    "shade_bounce", _shade_bounce_torch, _launch_shade_bounce, "shading",
    "A segment's bounce, after its light and env-NEE samples (state, h, n, "
    "new_o, throughput, o, d, prev_bsdf_pdf, env_is, run_env) → Bounce: "
    "the cosine-weighted direction from ``n``, with ``env_is`` the BSDF "
    "pdf of that direction that the deferred fetch weighs by (-1 unless "
    "``run_env``), Russian roulette, and the lanes that go on from "
    "``new_o``. The RNG advances on ``h`` lanes alone; outputs are new "
    "tensors. The kernel is ``wrt_shade_bounce``, its launches also "
    "counted in ``shade.kernel_launches``.")


class LightSample(NamedTuple):
    p: torch.Tensor  # (R,) 1/pdf
    point: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3)
    material_idx: torch.Tensor  # (R,) i32


def sample_lights(state, tables, settings: RenderSettings):
    """sampleLights → sampleModel(models[0]) → sampleFace
    (render.ts:849-869). Model 0 is the light by scene contract. Draws
    ``random_1u`` then ``random_2`` on every lane (unmasked, as in JAX)."""
    offset = tables.model_face_offset[0].long()
    count = tables.model_face_count[0].long()
    u1, state = rng.random_1u(state)
    face_idx = offset + u1 % count
    t2, state = rng.random_2(state)
    uv = rng.sample_intriangle(t2)
    u, v = uv[..., 0], uv[..., 1]
    tri = tables.tri[face_idx]
    shade = tables.shade_normal[face_idx]
    point = face_point_offset(tri, shade, u, v)
    normal = face_normal(shade, u, v, settings.shading_type)
    # 1/pdf = |cross(e1, e2)|/2 × face count (render.ts:862-869); the
    # square root correctly rounded, as JAX's and the card's are (torch's
    # on the CPU may be an ulp off)
    cr = scross(tri[..., 3:6], tri[..., 6:9])
    area = detmath.det_sqrt(sdot3(cr, cr)) / 2.0
    p = area * count.to(torch.float32)
    mat = tables.face_material[face_idx]
    return LightSample(p=p, point=point, normal=normal, material_idx=mat), state


def light_ray(point, ls: LightSample):
    """Shadow ray from a shading point to a light sample → (direction,
    t_max = distance to the light point, squared distance)."""
    ds = ls.point - point
    d_sq = sdot3(ds, ds)
    inv_d = detmath.det_div(1.0, detmath.det_sqrt(torch.clamp(d_sq, min=1e-20)))
    t_max = detmath.det_sqrt(torch.clamp(d_sq, min=0.0))
    return ds * inv_d.unsqueeze(-1), t_max, d_sq


class LightRay(NamedTuple):
    """:func:`light_sample`'s outputs, in the order of
    ``LightSampleArgs``'s outputs (``csrc/light.cuh``)."""

    d: torch.Tensor  # (R, 3) the shadow ray's direction
    t_max: torch.Tensor  # (R,) the distance to the light point
    carry: torch.Tensor  # (3, R) for light_add: 1/pdf, d_sq, the material
    state: torch.Tensor  # (R,) i64


# the light's normal, which pointColor never reads, is drawn flat: no ops
_FLAT = RenderSettings(shading_type=ShadingType.FLAT)


def _light_sample_torch(point, state, tables) -> LightRay:
    """The plain twin of ``wrt_light_sample``: :func:`sample_lights` and
    :func:`light_ray`, eager ops, one rounding each. The carry's last row
    is the light face's material index as the bits of an f32."""
    ls, state = sample_lights(state, tables, _FLAT)
    d, t_max, d_sq = light_ray(point, ls)
    carry = torch.stack([ls.p, d_sq, ls.material_idx.view(torch.float32)])
    return LightRay(d, t_max, carry, state)


def _light_add_torch(shadowed, d, normal, carry, color, tables, spp,
                     last) -> torch.Tensor:
    """The plain twin of ``wrt_light_add``: one sample's emission ×
    cosine / r² × (1/pdf), unless ``shadowed``, added to ``color`` (None
    on the first sample: zeros); ``last`` divides by ``spp``."""
    if color is None:
        color = torch.zeros_like(d)
    vis = torch.where(shadowed, 0.0, 1.0)
    cosine = torch.clamp(sdot3(d, normal), min=0.0)
    emission = tables.mat_emission[carry[2].view(torch.int32).long()]
    contrib = vis * cosine * carry[0] / torch.clamp(carry[1], min=1e-20)
    color = color + emission * contrib.unsqueeze(-1)
    return color / float(spp) if last else color


def _light_sample_buffers(point, state, tables):
    """``wrt_light_sample``'s arguments checked, its outputs allocated →
    (the outputs, the pointer block in ``LightSampleArgs``'s order, the
    tensors it points to)."""
    dev = point.device
    r, n_f = point.shape[0], tables.tri.shape[0]
    m = tables.model_face_offset.shape[0]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    ins = check_args("lights", dev, [
        ("point", point, f32, (r, 3)), ("state", state, i64, (r,)),
        ("model_face_offset", tables.model_face_offset, i32, (m,)),
        ("model_face_count", tables.model_face_count, i32, (m,)),
        ("tri", tables.tri, f32, (n_f, 9)),
        ("shade_normal", tables.shade_normal, f32, (n_f, 12)),
        ("face_material", tables.face_material, i32, (n_f,)),
    ], copy=True)
    out = LightRay(
        d=torch.empty((r, 3), dtype=f32, device=dev),
        t_max=torch.empty((r,), dtype=f32, device=dev),
        carry=torch.empty((3, r), dtype=f32, device=dev),
        state=torch.empty((r,), dtype=i64, device=dev))
    return out, pointer_block(ins + list(out)), ins + list(out)


def _light_add_buffers(shadowed, d, normal, carry, color, tables):
    """``wrt_light_add``'s arguments checked, its output allocated, as
    :func:`_light_sample_buffers`."""
    dev = d.device
    r, k = d.shape[0], tables.mat_emission.shape[0]
    f32 = torch.float32
    ins = check_args("lights", dev, [
        ("shadowed", shadowed, torch.bool, (r,)), ("d", d, f32, (r, 3)),
        ("normal", normal, f32, (r, 3)), ("carry", carry, f32, (3, r)),
        ("color", color, f32, (r, 3)),
        ("mat_emission", tables.mat_emission, f32, (k, 3)),
    ], copy=True)
    out = torch.empty((r, 3), dtype=f32, device=dev)
    return out, pointer_block(ins + [out]), ins + [out]


def _launch_light_sample(point, state, tables) -> LightRay:
    out, block, keep = _light_sample_buffers(point, state, tables)
    launch("lights", "wrt_light_sample", point.device, block, point.shape[0])
    count("light.kernel_launches", 1)
    return out


def _launch_light_add(shadowed, d, normal, carry, color, tables, spp,
                      last) -> torch.Tensor:
    out, block, keep = _light_add_buffers(shadowed, d, normal, carry, color,
                                          tables)
    launch("lights", "wrt_light_add", d.device, block, int(spp), int(last),
           d.shape[0])
    count("light.kernel_launches", 1)
    return out


light_sample = Kernel(
    "light_sample", _light_sample_torch, _launch_light_sample, "lights",
    "A light sample before its shadow leg (point, state, tables) → "
    "LightRay: ``random_1u`` then ``random_2`` on every lane, unmasked, "
    "a point on one of the light model's faces (model 0), the shadow ray "
    "from ``point`` to it (direction, t_max) and what :data:`light_add` "
    "needs (1/pdf, the squared distance, the light's material); outputs "
    "are new tensors. The kernel is ``wrt_light_sample`` "
    "(``csrc/light.cu``), its launches also counted in the frame's "
    "``light.kernel_launches``.")
light_add = Kernel(
    "light_add", _light_add_torch, _launch_light_add, "lights",
    "A light sample after its shadow leg (shadowed, d, normal, carry, "
    "color, tables, spp, last) → the colour: emission × cosine / r² × "
    "(1/pdf) on unshadowed lanes, added to ``color`` (None on the first "
    "sample, which starts from +0), divided by ``spp`` when ``last``; a "
    "new tensor. The kernel is ``wrt_light_add``, its launches also "
    "counted in ``light.kernel_launches``.")


@traced("wrt.light")
def direct_light(point, normal, state, tables, settings: RenderSettings,
                 active=None, excl=None, sort=False, seg=0):
    """pointColor (render.ts:1143-1157): ``samples_per_point`` light
    samples, each with a shadow ray; emission × cosine / r² × (1/pdf).
    Traced as ``wrt.light``, its shadow legs' ``wrt.trace`` inside it. A
    sample is :data:`light_sample`, the shadow leg, :data:`light_add`: on
    the card two launches around the leg.

    NaN shading points (the reference's inverted offsetRay select, see
    :func:`offset_ray`) stay NaN: their shadow rays come out unshadowed
    and the contribution poisons the pixel, exactly as in the JAX package
    and the reference (deliberate parity)."""
    spp = settings.samples_per_point
    color = None
    for k in range(spp):
        ray = light_sample(point, state, tables)
        shadowed = trace_any(
            point, ray.d, ray.t_max, tables, settings, active, excl,
            sort=sort, seg=seg,
        )
        color = light_add(shadowed, ray.d, normal, ray.carry, color, tables,
                          spp, k == spp - 1)
        state = ray.state
    return color, state


class PathResult(NamedTuple):
    color: torch.Tensor  # (R, 3)
    state: torch.Tensor  # (R,) RNG state words
    first_hit: Hit  # primary-segment hit (G-buffer source)
    rays: torch.Tensor  # () f32: rays traced (bench accounting)


@traced("wrt.shade")
def path_trace(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max0: torch.Tensor,  # (R,) primary-segment bound
    state: torch.Tensor,  # (R,) RNG state words
    tables,
    env_data,
    settings: RenderSettings,
) -> PathResult:
    """pixelColor (render.ts:1167-1212), wavefront-unrolled. With
    ``next_event_estimation`` each vertex also samples the lights; with
    ``env_importance_sampling`` (``env_data`` an :class:`EnvDistribution`)
    each vertex up to ``env_nee_depth`` also samples the environment, and
    both environment strategies are MIS-combined (balance heuristic).
    The environment's work (the env-IS draws, pdfs and MIS weights, the
    deferred fetch) is traced as ``wrt.env``, the lights' as
    ``wrt.light`` (:func:`direct_light`); the shadow legs are ``wrt.trace``
    legs.

    ``chained_sort`` (with ``sort_bounce_rays``, and a traversal other than
    ``"threaded"``; JAX ``path_trace``): before every segment past the
    first the whole per-lane state is permuted into nearest-cluster order
    (:func:`.ray_sort.nearest_cluster_key` over the live lanes, a stable
    sort, :func:`.ray_sort.permute_rows`); the traces inside the segment
    are not sorted again, and one scatter restores pixel order of color
    and state at the end. Every step is per lane, so the result is the
    unchained one's bit for bit."""
    env_is = settings.env_importance_sampling
    dist = env_data if env_is else None
    env_img = env_data.img if isinstance(env_data, EnvDistribution) else env_data

    r = o.shape[0]
    dev = o.device
    color = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((r, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    first_hit = None
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    prev_bsdf_pdf = torch.zeros((r,), dtype=torch.float32, device=dev)

    # deferred environment lookup: each lane misses at most once
    env_dir = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    env_w = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    env_mis_pdf = torch.full((r,), -1.0, dtype=torch.float32, device=dev)

    excl = None

    chained = (settings.chained_sort and settings.sort_bounce_rays
               and settings.traversal != "threaded")
    orig = None  # the pixel of each lane, once the lanes are permuted

    for seg in range(max(settings.bounces_depth - 1, 0)):
        live = alive.to(torch.float32).sum()
        rays = rays + live
        count("trace.closest.live", live)
        count("trace.closest.lanes", r)
        t_max = (
            t_max0
            if seg == 0
            else torch.full((r,), F32_MAX, dtype=torch.float32, device=dev)
        )
        if chained and seg > 0:
            key = ray_sort.nearest_cluster_key(
                o, d, torch.where(alive, t_max, torch.zeros_like(t_max)),
                tables.clusters.sort_box,
                route=_ROUTES.get(settings.traversal, "twin"))
            perm = ray_sort.sort_keys(key)[1]
            if orig is None:
                orig = torch.arange(r, device=dev)
            st = dict(o=o, d=d, state=state, color=color,
                      throughput=throughput, alive=alive, env_dir=env_dir,
                      env_w=env_w, env_mis_pdf=env_mis_pdf, orig=orig)
            if env_is:
                st["prev_bsdf_pdf"] = prev_bsdf_pdf
            if excl is not None:
                st["excl"] = excl
            st = ray_sort.permute_rows(perm, st)
            o, d, state, color = st["o"], st["d"], st["state"], st["color"]
            throughput, alive = st["throughput"], st["alive"]
            env_dir, env_w = st["env_dir"], st["env_w"]
            env_mis_pdf, orig = st["env_mis_pdf"], st["orig"]
            prev_bsdf_pdf = st.get("prev_bsdf_pdf", prev_bsdf_pdf)
            excl = st.get("excl")
        sort_here = seg > 0 and not chained
        hit = trace_closest(o, d, t_max, tables, settings, alive, excl,
                            primary=seg == 0, sort=sort_here, seg=seg)
        if seg == 0:
            first_hit = hit

        sh = shade_hit(hit, alive, d, color, throughput, env_dir, env_w,
                       env_mis_pdf, prev_bsdf_pdf, tables,
                       settings.shading_type, env_is and seg > 0)
        color, throughput, env_dir, env_w, env_mis_pdf = sh[:5]
        n, new_o, excl, h = sh.n, sh.new_o, sh.excl, sh.h
        h3 = h.unsqueeze(-1)

        if settings.next_event_estimation:
            nee, state = direct_light(
                new_o, n, state, tables, settings, active=h, excl=excl,
                sort=sort_here, seg=seg,
            )
            color = torch.where(h3, color + nee * throughput, color)
            live = h.to(torch.float32).sum() * float(
                settings.samples_per_point
            )
            rays = rays + live
            count("trace.shadow.live", live)
            count("trace.shadow.lanes", r * settings.samples_per_point)

        # env-NEE up to env_nee_depth vertices (0: all); deeper vertices
        # keep BSDF sampling as their only env strategy (MIS weight 1)
        run_env = env_is and (
            settings.env_nee_depth == 0 or seg < settings.env_nee_depth
        )
        if run_env:
            with span("wrt.env"):
                ed, erad, epdf, s_env = sample_env(dist, state)
                state = rng.masked_advance(state, s_env, h)
                nn = detmath.normalize(n)
                facing = sdot3(ed, nn) > 0.0
            blocked = trace_any(
                new_o, ed,
                torch.full((r,), F32_MAX, dtype=torch.float32, device=dev),
                tables, settings, h & facing, excl, sort=sort_here, seg=seg,
            )
            with span("wrt.env"):
                vis = h & facing & ~blocked
                w_env = balance_weight(epdf, bsdf_pdf(ed, n))
                # f = albedo/π is already folded into throughput; × cos/pdf
                contrib = throughput * erad * (
                    torch.clamp(sdot3(ed, nn), min=0.0) * INV_PI * w_env
                    / torch.clamp(epdf, min=1e-20)
                ).unsqueeze(-1)
                color = torch.where(vis.unsqueeze(-1), color + contrib,
                                    color)
            live = (h & facing).to(torch.float32).sum()
            rays = rays + live
            count("trace.env_shadow.live", live)
            count("trace.env_shadow.lanes", r)

        state, throughput, alive, o, d, prev_bsdf_pdf = shade_bounce(
            state, h, n, new_o, throughput, o, d, prev_bsdf_pdf, env_is,
            run_env)

    with span("wrt.env"):
        env = sample_environment(env_img, env_dir, settings.environment)
        if env_is:
            w_bsdf = balance_weight(
                torch.clamp(env_mis_pdf, min=0.0), env_pdf(dist, env_dir)
            )
            env = env * torch.where(env_mis_pdf >= 0.0, w_bsdf,
                                    1.0).unsqueeze(-1)
        color = color + env * env_w
    if orig is not None:  # back to pixel order: the chain's one scatter
        color, state = ray_sort.unsort(orig, (color, state))

    if first_hit is None:
        first_hit = Hit(
            t=torch.full((r,), F32_MAX, dtype=torch.float32, device=dev),
            u=torch.zeros((r,), dtype=torch.float32, device=dev),
            v=torch.zeros((r,), dtype=torch.float32, device=dev),
            face=torch.full((r,), -1, dtype=torch.int32, device=dev),
        )
    return PathResult(color=color, state=state, first_hit=first_hit, rays=rays)


@traced("wrt.shade")
def trace_direct(o, d, t_max0, state, tables, env_data,
                 settings: RenderSettings) -> PathResult:
    """Direct-lighting-only integrator (BASELINE config #1, chosen when
    ``bounces_depth <= 1``): one primary hit, emission + light NEE, the
    environment on a miss (``wrt.env``)."""
    if isinstance(env_data, EnvDistribution):
        env_data = env_data.img
    r = o.shape[0]
    hit = trace_closest(o, d, t_max0, tables, settings, primary=True)
    count("trace.closest.live", r)  # every lane of the leg is live
    count("trace.closest.lanes", r)
    found = hit.face >= 0
    f3 = found.unsqueeze(-1)
    with span("wrt.env"):
        env = sample_environment(env_data, d, settings.environment)
        color = torch.where(f3, 0.0, env)

    face = hit.face.clamp(min=0).long()
    mat = tables.face_material[face].long()
    emission = tables.mat_emission[mat]
    albedo = tables.mat_color[mat]
    tri = tables.tri[face]
    shade = tables.shade_normal[face]
    n = face_normal(shade, hit.u, hit.v, settings.shading_type)
    point = face_point_offset(tri, shade, hit.u, hit.v)

    pc = tables.clusters.partner_code
    excl = (
        None
        if pc is None
        else torch.where(found, pc[face], torch.full_like(hit.face, -1))
    )
    nee, state = direct_light(
        point, n, state, tables, settings, active=found, excl=excl
    )
    color = torch.where(f3, emission + albedo * nee, color)
    rays = torch.tensor(
        float(r * (1 + settings.samples_per_point)), dtype=torch.float32,
        device=o.device,
    )
    return PathResult(color=color, state=state, first_hit=hit, rays=rays)
