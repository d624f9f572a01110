"""Cluster trace, closest-hit and any-hit: dispatchers, the CUDA kernel
wrapper and its plain-torch twins (counterpart of
``trace_closest_clustered_pallas`` with ``exact_pairs=False``, with
``any_hit`` False or True, and of ``code_to_face`` / ``rederive_uv`` in
``webgpu_raytracing_tpu/ops/cluster_pallas.py``).

Around the kernel, as plain torch (the JAX package does the same outside
Pallas): pad the rays to whole tiles, compute each tile's per-cluster
entry distance (:func:`.cluster_trace.tile_nears_fused`), and sort every
row ascending with a stable sort, giving each tile its cluster order.
The kernel (``csrc/cluster_trace.cu``) walks that order per ray. The
closest-hit entry returns the best ``t`` and code ``cid * S + slot``;
:func:`code_to_face` and :func:`rederive_uv` then give the face id and the
exact t, u, v. The any-hit entry (shadow rays) returns the code of the
first valid hit with ``t < t_max`` in walk order, or -1.

:func:`trace_closest_tiles` and :func:`trace_any_tiles` launch the kernel
for CUDA tensors and run :func:`_trace_closest_torch` /
:func:`_trace_any_torch` for CPU tensors only; any other device raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cluster_trace import EPS2, exact_face_eval, tile_nears_fused
from .detmath import det_div
from .intersect import Hit, safe_inv_dir
from .strictf import scross, sdot3


def code_to_face(code: torch.Tensor, face_id: torch.Tensor) -> torch.Tensor:
    """Cluster-slot code → global face id (-1 stays -1)."""
    f = face_id.reshape(-1)[code.clamp(min=0).long()]
    return torch.where(code >= 0, f, torch.full_like(f, -1)).to(torch.int32)


def rederive_uv(o, d, t, face, tables) -> Hit:
    """Exact t and barycentrics of the winning triangle, from the face
    alone (unmasked Möller–Trumbore algebra, correctly rounded divides);
    misses keep the incoming t."""
    hit_mask = face >= 0
    tri = tables.tri[face.clamp(min=0).long()]
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    hvec = scross(d, e2)
    det = sdot3(e1, hvec)
    svec = o - p0
    det_safe = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
    u = det_div(sdot3(svec, hvec), det_safe)
    qvec = scross(svec, e1)
    v = det_div(sdot3(d, qvec), det_safe)
    t_exact = det_div(sdot3(e2, qvec), det_safe)
    zero = torch.zeros_like(u)
    return Hit(
        t=torch.where(hit_mask, t_exact, t),
        u=torch.where(hit_mask, u, zero),
        v=torch.where(hit_mask, v, zero),
        face=face,
    )


def _slab(bx, o, inv_d):
    """Per-ray slab test against per-ray boxes (m, 6) → (near, far), with
    the kernel's axis order and NaN-propagating min/max."""
    near = far = None
    for ax in range(3):
        a = (bx[:, ax] - o[:, ax]) * inv_d[:, ax]
        b = (bx[:, 3 + ax] - o[:, ax]) * inv_d[:, ax]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return near, far


def _walk_torch(
    o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    any_hit: bool, chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel (both entries): the same per-ray
    walk, vectorized over the rays still walking. Step k takes every live
    ray's k-th cluster of its tile's order; a ray leaves the walk at the
    first entry whose tile distance is not below its best t (any-hit: its
    t_max, or once it has a hit), skips a cluster its own slab test
    rejects, and otherwise tests the cluster's slots in chunks of
    ``chunk`` rays (default 2**18 on a GPU, 2**15 elsewhere). Within a
    step the closest-hit winner is the lexicographic minimum of (t, code),
    exactly what the kernel's sequential slot loop keeps; the any-hit
    winner is the LOWEST valid slot (the kernel returns at the first
    one). Returns (best t, code); any-hit leaves best t at t_max."""
    r = o.shape[0]
    dev = o.device
    if chunk is None:
        chunk = 1 << 18 if dev.type == "cuda" else 1 << 15
    s = face_id.shape[1]
    best = t_max.clone()
    best_code = torch.full((r,), -1, dtype=torch.int32, device=dev)
    tile_of = torch.arange(r, device=dev) // tile
    live = torch.arange(r, device=dev)
    slot_iota = torch.arange(s, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    inf = float("inf")
    for k in range(snear.shape[1]):
        live = live[~(snear[tile_of[live], k] >= best[live])]
        if live.numel() == 0:
            break
        cid = order[tile_of[live], k].long()
        near, far = _slab(box[cid], o[live], inv_d[live])
        consider = (near < far) & (far > 0.0) & (near < best[live])
        rays, cids = live[consider], cid[consider]
        for c0 in range(0, rays.numel(), chunk):
            rr, cc = rays[c0 : c0 + chunk], cids[c0 : c0 + chunk]
            fid = face_id[cc]  # (m, S)
            codes = cc.to(torch.int32)[:, None] * s + slot_iota[None, :]
            present = (fid >= 0) & (codes != excl[rr][:, None])
            trow = tri[fid.clamp(min=0).long()]  # (m, S, 9)
            ok, t, _, _ = exact_face_eval(
                o[rr][:, None, :], d[rr][:, None, :], trow, present,
                best[rr][:, None] if any_hit else inf,
            )
            if any_hit:
                first = torch.amin(
                    torch.where(ok, codes, torch.full_like(codes, big)), dim=1
                )
                best_code[rr] = torch.where(
                    first < big, first, torch.full_like(first, -1)
                )
                continue
            t = torch.where(ok, t, torch.full_like(t, inf))
            t_c = torch.amin(t, dim=1)
            code_c = torch.amin(
                torch.where(
                    ok & (t == t_c[:, None]), codes, torch.full_like(codes, big)
                ),
                dim=1,
            )
            b_t, b_c = best[rr], best_code[rr]
            better = (t_c < b_t) | ((t_c == b_t) & (code_c < b_c))
            best[rr] = torch.where(better, t_c, b_t)
            best_code[rr] = torch.where(better, code_c, b_c)
        if any_hit:
            live = live[best_code[live] < 0]
    return best, best_code


def _trace_closest_torch(*args, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the closest-hit entry → (best t, code)."""
    return _walk_torch(*args, any_hit=False, **kw)


def _trace_any_torch(*args, **kw) -> torch.Tensor:
    """Plain twin of the any-hit entry → code of the first valid hit in
    walk order, or -1."""
    return _walk_torch(*args, any_hit=True, **kw)[1]


def _launch_kernel(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                   tri, tile, any_hit: bool = False):
    """Check the arguments and launch the closest-hit (→ (t, code)) or
    the any-hit (→ code) entry of the kernel; counts the launch."""
    from ._build import load

    tensors = dict(
        o=(o, torch.float32), d=(d, torch.float32),
        inv_d=(inv_d, torch.float32), t_max=(t_max, torch.float32),
        excl=(excl, torch.int32), snear=(snear, torch.float32),
        order=(order, torch.int32), box=(box, torch.float32),
        face_id=(face_id, torch.int32), tri=(tri, torch.float32),
    )
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the cluster trace kernel takes CUDA tensors, not {dev}")
    for name, (x, dt) in tensors.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {dt} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    r = o.shape[0]
    n_tiles, n_cols = snear.shape
    if (
        r != n_tiles * tile or o.shape != (r, 3) or d.shape != (r, 3)
        or inv_d.shape != (r, 3) or t_max.shape != (r,)
        or excl.shape != (r,) or order.shape != snear.shape
        or box.shape != (face_id.shape[0], 6) or tri.shape[1:] != (9,)
        or not 0 < tile <= 1024
    ):
        raise ValueError("cluster trace kernel: inconsistent shapes")
    lib = load()
    code_out = torch.empty((r,), dtype=torch.int32, device=dev)
    t_out = None if any_hit else torch.empty(
        (r,), dtype=torch.float32, device=dev
    )
    head = (
        o.data_ptr(), d.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(),
        excl.data_ptr(), snear.data_ptr(), order.data_ptr(), n_cols,
        box.data_ptr(), face_id.data_ptr(), face_id.shape[1],
        tri.data_ptr(), EPS2,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if any_hit:
            err = lib.wrt_trace_any(
                *head, code_out.data_ptr(), n_tiles, tile, stream
            )
        else:
            err = lib.wrt_trace_closest(
                *head, t_out.data_ptr(), code_out.data_ptr(), n_tiles,
                tile, stream,
            )
    if err != 0:
        raise RuntimeError(
            "cluster trace kernel launch failed: "
            + lib.wrt_error_string(err).decode()
        )
    if any_hit:
        trace_any_tiles.launches += 1
        return code_out
    trace_closest_tiles.launches += 1
    return t_out, code_out


def trace_closest_tiles(o, d, inv_d, t_max, excl, snear, order, box,
                        face_id, tri, tile):
    """Per-ray closest hit over each tile's sorted cluster order → (best
    t, code). CUDA tensors launch the kernel (and count the launch in
    ``trace_closest_tiles.launches``); CPU tensors run the plain twin."""
    if o.device.type == "cuda":
        return _launch_kernel(
            o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile
        )
    if o.device.type == "cpu":
        return _trace_closest_torch(
            o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile
        )
    raise ValueError(f"no closest-hit trace for device {o.device}")


trace_closest_tiles.launches = 0


def trace_any_tiles(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                    tri, tile):
    """Per-ray any-hit over each tile's sorted cluster order → code of
    the first valid hit with t < t_max in walk order, or -1. CUDA tensors
    launch the kernel (and count the launch in
    ``trace_any_tiles.launches``); CPU tensors run the plain twin."""
    if o.device.type == "cuda":
        return _launch_kernel(
            o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
            any_hit=True,
        )
    if o.device.type == "cpu":
        return _trace_any_torch(
            o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile
        )
    raise ValueError(f"no any-hit trace for device {o.device}")


trace_any_tiles.launches = 0


def prepare_tiles(o, d, t_max, tables, active=None, excl_code=None,
                  tile: int = 128):
    """Everything the kernel takes, as plain torch: rays padded to whole
    tiles (pad lanes inactive), inactive t_max zeroed, safe reciprocal
    directions, exclusion codes (-1 = none) and each tile's cluster order
    (ascending tile entry distance, stable sort). Returns a dict of the
    kernel's tensor arguments."""
    ct = tables.clusters
    r0 = o.shape[0]
    dev = o.device
    if active is None:
        active = torch.ones((r0,), dtype=torch.bool, device=dev)
    if excl_code is None:
        excl_code = torch.full((r0,), -1, dtype=torch.int32, device=dev)
    pad = (-r0) % tile
    if pad:
        ones = torch.ones((pad, 3), dtype=o.dtype, device=dev)
        o = torch.cat([o, ones])
        d = torch.cat([d, ones])
        t_max = torch.cat([t_max, torch.zeros((pad,), dtype=t_max.dtype, device=dev)])
        active = torch.cat([active, torch.zeros((pad,), dtype=torch.bool, device=dev)])
        excl_code = torch.cat(
            [excl_code, torch.full((pad,), -1, dtype=excl_code.dtype, device=dev)]
        )
    t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    inv_d = safe_inv_dir(d)
    near_tc = tile_nears_fused(o, inv_d, t_max, ct.box, tile)
    snear, order = torch.sort(near_tc, dim=1, stable=True)
    return dict(
        o=o.contiguous(), d=d.contiguous(), inv_d=inv_d.contiguous(),
        t_max=t_max.contiguous(),
        excl=excl_code.to(torch.int32).contiguous(),
        snear=snear.contiguous(), order=order.to(torch.int32).contiguous(),
        box=ct.box.contiguous(), face_id=ct.face_id.contiguous(),
        tri=tables.tri.contiguous(), tile=tile,
    )


def trace_closest_clustered_cuda(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    tables,
    active: Optional[torch.Tensor] = None,
    excl_code: Optional[torch.Tensor] = None,
    tile: int = 128,
) -> Hit:
    """Closest hit per ray → Hit(t, u, v, face). Inactive rays return
    face -1 and t 0, misses return their t_max; the face id is the
    contract and t, u, v are re-derived exactly from it."""
    r0 = o.shape[0]
    args = prepare_tiles(o, d, t_max, tables, active, excl_code, tile)
    best_t, code = trace_closest_tiles(**args)
    face = code_to_face(code[:r0], tables.clusters.face_id)
    return rederive_uv(o, d, best_t[:r0], face, tables)


def trace_any_clustered_cuda(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    tables,
    active: Optional[torch.Tensor] = None,
    excl_code: Optional[torch.Tensor] = None,
    tile: int = 128,
) -> torch.Tensor:
    """Shadow-ray query → (R,) bool, True where some triangle blocks the
    ray with 0 < t < t_max. Inactive rays and NaN origins are unblocked.
    ``prepare_tiles`` feeds t_max into the tile distances, so short rays
    prune clusters there."""
    r0 = o.shape[0]
    args = prepare_tiles(o, d, t_max, tables, active, excl_code, tile)
    return trace_any_tiles(**args)[:r0] >= 0
