"""Exact re-adjudication of the exact-pairs trace's carried candidates
(counterpart of ``adjudicate_candidates``, ``adjudicate_pair`` and
``adjudicate_compact`` in ``webgpu_raytracing_tpu/ops/cluster_pallas.py``).

The pairs kernels (K2p, K3p in ``csrc/cluster_trace.cu``) rank candidates
on estimates and carry three faces per ray out: the two nearest
margin-valid candidates and the nearest robust one, with a flag on the
rays whose exact verdict could differ from the first. Here each carried
face is tested again with exact sequential f32 Möller–Trumbore under the
reference's semantics, and the valid one with the smallest exact t wins.
"""

from __future__ import annotations

import torch

from .cluster_trace import exact_face_eval, rederive_uv
from .intersect import Hit


def adjudicate_candidates(o, d, t_fallback, faces, tables) -> Hit:
    """The valid candidate of ``faces`` (a tuple of (R,) i32 faces, -1 =
    none) with the smallest exact t, under the reference's validity
    semantics (cull ``det < EPSILON²``, barycentrics against det before
    the division, ``0 < t < t_fallback``). A strict ``<`` keeps the
    earlier candidate on an exact-t tie. Misses return ``t_fallback``."""
    r = o.shape[0]
    dev = o.device
    hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    bt = t_fallback
    bu = torch.zeros((r,), dtype=torch.float32, device=dev)
    bv = torch.zeros((r,), dtype=torch.float32, device=dev)
    bf = torch.full((r,), -1, dtype=torch.int32, device=dev)
    for face in faces:
        tri = tables.tri[face.clamp(min=0).long()]
        v, t, u, w = exact_face_eval(o, d, tri, face >= 0, t_fallback)
        take = v & (~hit | (t < bt))
        bt = torch.where(take, t, bt)
        bu = torch.where(take, u, bu)
        bv = torch.where(take, w, bv)
        bf = torch.where(take, face, bf)
        hit = hit | v
    zero = torch.zeros_like(bu)
    return Hit(
        t=torch.where(hit, bt, t_fallback),
        u=torch.where(hit, bu, zero),
        v=torch.where(hit, bv, zero),
        face=bf.to(torch.int32),
    )


def adjudicate_pair(o, d, t_fallback, face1, face2, tables) -> Hit:
    """Two-candidate form of :func:`adjudicate_candidates`."""
    return adjudicate_candidates(o, d, t_fallback, (face1, face2), tables)


def adjudicate_compact(o, d, t_fallback, t1, faces, amb, tables,
                       cap_frac: int = 64) -> Hit:
    """:func:`adjudicate_candidates` on the flagged rays only.

    Unflagged rays (``amb == 0``) take :func:`rederive_uv` of their first
    candidate. The flagged rays are gathered into a batch of fixed
    capacity ``ceil(R / cap_frac)`` rounded up to 128 (the JAX
    ``nonzero(size=cap, fill_value=R)``: fill lanes gather the last ray,
    and their results are dropped by the scatter). When the capacity is
    not below R, or the flag count exceeds it, the dense form runs
    instead; the JAX package decides that on the device with
    ``lax.cond``, the port with one device-to-host read of the count. The
    result equals :func:`adjudicate_candidates` on the carried faces."""
    r = o.shape[0]
    f1 = faces[0]
    cap = -(-r // cap_frac)
    cap = max(128, -(-cap // 128) * 128)
    if cap >= r:
        return adjudicate_candidates(o, d, t_fallback, faces, tables)
    flag = amb != 0
    if int(flag.sum()) > cap:
        return adjudicate_candidates(o, d, t_fallback, faces, tables)
    base = rederive_uv(o, d, torch.where(f1 >= 0, t1, t_fallback), f1, tables)
    nz = torch.nonzero(flag).flatten()
    idx = torch.full((cap,), r, dtype=torch.long, device=o.device)
    idx[: nz.numel()] = nz
    take = idx.clamp(max=r - 1)
    sub = adjudicate_candidates(
        o[take], d[take], t_fallback[take], tuple(f[take] for f in faces),
        tables,
    )
    keep = idx < r

    def put(b, s):
        out = b.clone()
        out[idx[keep]] = s[keep]
        return out

    return Hit(*(put(b, s) for b, s in zip(base, sub)))
