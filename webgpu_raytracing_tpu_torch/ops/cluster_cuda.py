"""Cluster trace, closest-hit and any-hit, single- and two-level:
dispatchers, the CUDA kernel wrappers and their plain-torch twins
(counterpart of ``trace_closest_clustered_pallas`` with
``exact_pairs=False``, with ``any_hit`` False or True, and of
``is_two_level``, ``code_to_face`` and ``rederive_uv`` in
``webgpu_raytracing_tpu/ops/cluster_pallas.py``).

Around the kernels, as plain torch (the JAX package does the same outside
Pallas): pad the rays to whole tiles, compute each tile's entry distance
into every box (:func:`.cluster_trace.tile_nears_fused`) and sort every
row ascending with a stable sort, giving each tile its box order. The
boxes are the clusters (single-level, kernel K1) or, for two-level
tables, the superclusters (kernel K3, which culls and orders each super's
G child clusters itself). Both kernels (``csrc/cluster_trace.cu``) walk
that order per ray. The closest-hit entries return the best ``t`` and
code ``cid * S + slot``; :func:`code_to_face` and :func:`rederive_uv`
then give the face id and the exact t, u, v. The any-hit entries (shadow
rays) return the code of the first valid hit with ``t < t_max`` in walk
order, or -1.

The four wrappers (:func:`trace_closest_tiles`, :func:`trace_any_tiles`,
:func:`trace_closest_two_level_tiles`, :func:`trace_any_two_level_tiles`)
launch their kernel entry for CUDA tensors, counting each launch in their
own ``launches``, and run the plain twin for CPU tensors only; any other
device raises. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import F32_MAX
from .cluster_trace import EPS2, exact_face_eval, tile_nears_fused
from .detmath import det_div
from .intersect import Hit, safe_inv_dir
from .strictf import scross, sdot3

_INF = float(F32_MAX)


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


def is_two_level(ct) -> bool:
    """Whether the trace takes the two-level kernel: the JAX dispatch rule,
    including its 8 MB cap on ``child_box_t`` (a TPU VMEM budget, kept so
    both packages pick the same body; past it, the single-level kernel
    walks ``box``, which holds all C cluster boxes)."""
    return (
        ct.super_box is not None
        and ct.child_box_t.numel() * 4 <= 8 * 1024 * 1024
    )


def _slab(bx, o, inv_d):
    """Per-ray slab test against per-ray boxes (m, 6) → (near, far), with
    the kernel's axis order and NaN-propagating min/max. Broadcasts."""
    near = far = None
    for ax in range(3):
        a = (bx[..., ax] - o[..., ax]) * inv_d[..., ax]
        b = (bx[..., 3 + ax] - o[..., ax]) * inv_d[..., ax]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return near, far


def _count(stats, key, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _test_clusters(rays, cids, o, d, excl, face_id, tri, best, best_code,
                   any_hit: bool, chunk: int, stats) -> None:
    """Ray ``rays[i]`` tests the occupied slots of cluster ``cids[i]``, in
    chunks of ``chunk`` rays, updating ``best`` / ``best_code`` in place.
    The closest-hit winner is the lexicographic minimum of (t, code),
    exactly what the kernel's sequential slot loop keeps; the any-hit
    winner is the LOWEST valid slot (the kernel stops at the first one)."""
    s = face_id.shape[1]
    slot_iota = torch.arange(s, dtype=torch.int32, device=o.device)
    big = torch.iinfo(torch.int32).max
    inf = float("inf")
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
        if stats is not None:
            tested = present
            if any_hit:  # the kernel stops at the first valid slot
                first = torch.amin(
                    torch.where(ok, slot_iota, torch.full_like(slot_iota, s)),
                    dim=1,
                )
                tested = present & (slot_iota[None, :] <= first[:, None])
            e1, e2 = trow[..., 3:6], trow[..., 6:9]
            det = sdot3(e1, scross(d[rr][:, None, :], e2))
            _count(stats, "slot_tests", tested.sum())
            _count(stats, "slot_tests_past_cull",
                   (tested & ~(det < EPS2)).sum())
            stats["clusters_tested"][cc] = True
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


def _walk_setup(o, t_max, face_id, chunk, stats):
    dev = o.device
    if chunk is None:
        chunk = 1 << 18 if dev.type == "cuda" else 1 << 15
    if stats is not None:
        c = face_id.shape[0]
        stats.setdefault(
            "clusters_tested", torch.zeros(c, dtype=torch.bool, device=dev)
        )
        stats.setdefault(
            "boxes_read", torch.zeros(c, dtype=torch.bool, device=dev)
        )
        _count(stats, "rays", o.shape[0])
    best = t_max.clone()
    best_code = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    return chunk, best, best_code


def _walk_torch(
    o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    any_hit: bool, chunk: Optional[int] = None, stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K1 (both entries): the same per-ray walk,
    vectorized over the rays still walking. Step k takes every live ray's
    k-th cluster of its tile's order; a ray leaves the walk at the first
    entry whose tile distance is not below its best t (any-hit: its
    t_max, or once it has a hit), skips a cluster its own slab test
    rejects, and otherwise tests the cluster's slots in chunks of
    ``chunk`` rays (default 2**18 on a GPU, 2**15 elsewhere). Returns
    (best t, code); any-hit leaves best t at t_max. ``stats`` (a dict)
    accumulates the work this walk does (see :func:`walk_stats`)."""
    chunk, best, best_code = _walk_setup(o, t_max, face_id, chunk, stats)
    dev = o.device
    tile_of = torch.arange(o.shape[0], device=dev) // tile
    live = torch.arange(o.shape[0], device=dev)
    for k in range(snear.shape[1]):
        if stats is not None:
            _count(stats, "table_steps", torch.unique(tile_of[live]).numel())
        live = live[~(snear[tile_of[live], k] >= best[live])]
        if live.numel() == 0:
            break
        cid = order[tile_of[live], k].long()
        near, far = _slab(box[cid], o[live], inv_d[live])
        if stats is not None:
            _count(stats, "box_tests", live.numel())
            stats["boxes_read"][cid] = True
        consider = (near < far) & (far > 0.0) & (near < best[live])
        _test_clusters(live[consider], cid[consider], o, d, excl, face_id,
                       tri, best, best_code, any_hit, chunk, stats)
        if any_hit:
            live = live[best_code[live] < 0]
    return best, best_code


def _child_minima(o, inv_d, t_max, box, full, tiles, kids, tile,
                  max_elems: int = 1 << 24):
    """K3's per-child tile minima: for each tile of ``tiles`` and each
    child cluster of ``kids`` (n, G), the minimum over the tile's rays of
    JAX's entry value (``max(near, 0)`` where near < far, near < t_max and
    far > 0, else F32_MAX; -0 made +0); children without faces stay
    F32_MAX."""
    n, g = kids.shape
    out = torch.empty((n, g), dtype=torch.float32, device=o.device)
    lane = torch.arange(tile, device=o.device)
    per = max(1, max_elems // (tile * g))
    for i0 in range(0, n, per):
        rows = tiles[i0 : i0 + per, None] * tile + lane[None, :]  # (m, T)
        bx = box[kids[i0 : i0 + per]][:, None, :, :]  # (m, 1, G, 6)
        near, far = _slab(bx, o[rows][:, :, None, :], inv_d[rows][:, :, None, :])
        hit = (near < far) & (near < t_max[rows][:, :, None]) & (far > 0.0)
        val = torch.where(
            hit, torch.clamp(near, min=0.0) + 0.0, torch.full_like(near, _INF)
        )
        out[i0 : i0 + per] = torch.amin(val, dim=1)
    return torch.where(full[kids], out, torch.full_like(out, _INF))


def _walk_two_level_torch(
    o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile, group,
    any_hit: bool, chunk: Optional[int] = None, stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K3 (both entries), vectorized over the rays
    still walking, in exactly the kernel's order. Outer step k: a ray
    stays in the walk while the tile distance of its tile's k-th super is
    below its best t (any-hit: and it has no hit); every tile with a ray
    left takes the minima of the super's G children over ALL its rays
    (:func:`_child_minima`) and ranks the children by (minimum, index),
    a stable ascending sort. Inner step q: each remaining ray takes its
    tile's q-th child unless that child's minimum is not below its best
    (the kernel's break: minima ascend and best only falls), skips it if
    its own slab test rejects it, and otherwise tests its slots as K1's
    twin does. Returns (best t, code)."""
    chunk, best, best_code = _walk_setup(o, t_max, face_id, chunk, stats)
    dev = o.device
    n_tiles = o.shape[0] // tile
    tile_of = torch.arange(o.shape[0], device=dev) // tile
    live = torch.arange(o.shape[0], device=dev)
    full = face_id[:, 0] >= 0
    g_iota = torch.arange(group, device=dev)
    pos_of = torch.full((n_tiles,), -1, dtype=torch.long, device=dev)
    for k in range(snear.shape[1]):
        live = live[~(snear[tile_of[live], k] >= best[live])]
        if live.numel() == 0:
            break
        tiles = torch.unique(tile_of[live])
        kids = order[tiles, k].long()[:, None] * group + g_iota[None, :]
        cmin = _child_minima(o, inv_d, t_max, box, full, tiles, kids, tile)
        cmin, rank = torch.sort(cmin, dim=1, stable=True)
        cids = torch.gather(kids, 1, rank)  # (n, G) in walk order
        pos_of[tiles] = torch.arange(tiles.numel(), device=dev)
        if stats is not None:
            _count(stats, "table_steps", tiles.numel())
            _count(stats, "box_tests", tile * int(full[kids].sum()))
            stats["boxes_read"][kids.reshape(-1)] = True
        inner = live
        for q in range(group):
            pos = pos_of[tile_of[inner]]
            inner = inner[~(cmin[pos, q] >= best[inner])]
            if inner.numel() == 0:
                break
            cid = cids[pos_of[tile_of[inner]], q]
            near, far = _slab(box[cid], o[inner], inv_d[inner])
            _count(stats, "box_tests", inner.numel())
            consider = (near < far) & (far > 0.0) & (near < best[inner])
            _test_clusters(inner[consider], cid[consider], o, d, excl,
                           face_id, tri, best, best_code, any_hit, chunk,
                           stats)
            if any_hit:
                inner = inner[best_code[inner] < 0]
        if any_hit:
            live = live[best_code[live] < 0]
    return best, best_code


# f32 operations per test, for the work counts of walk_stats: a slab test
# (per axis 2 sub, 2 mul, min, max; 4 to combine the axes; 3 compares); a
# triangle slot up to its cull (d x e2, det, the compare) and past it (s,
# u, s x e1, v, t_num, the gates, the divide, two compares)
BOX_TEST_OPS = 25
SLOT_CULL_OPS = 15
SLOT_REST_OPS = 35


def walk_stats(stats: dict, face_id: torch.Tensor, any_hit: bool) -> dict:
    """The work a twin's walk counted in ``stats``, as f32 operations and
    the least bytes the kernel must move: each ray's inputs (o, d, inv_d,
    t_max, excl) read once and its outputs written once, the table
    entries (tile distance and order) the tiles stepped through, each box
    read, and the face ids and triangle rows of each cluster tested."""
    tested = stats["clusters_tested"]
    n_faces = int((face_id[tested] >= 0).sum())
    ops = (
        BOX_TEST_OPS * stats.get("box_tests", 0)
        + SLOT_CULL_OPS * stats.get("slot_tests", 0)
        + SLOT_REST_OPS * stats.get("slot_tests_past_cull", 0)
    )
    out_bytes = 4 if any_hit else 8
    n_bytes = (
        (44 + out_bytes) * stats["rays"]
        + 8 * stats.get("table_steps", 0)
        + 24 * int(stats["boxes_read"].sum())
        + 4 * face_id.shape[1] * int(tested.sum())
        + 36 * n_faces
    )
    return dict(
        ops=ops, bytes=n_bytes, box_tests=stats.get("box_tests", 0),
        slot_tests=stats.get("slot_tests", 0),
        clusters_tested=int(tested.sum()), faces_tested=n_faces,
    )


def _trace_closest_torch(*args, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1's closest-hit entry → (best t, code)."""
    return _walk_torch(*args, any_hit=False, **kw)


def _trace_any_torch(*args, **kw) -> torch.Tensor:
    """Plain twin of K1's any-hit entry → code of the first valid hit in
    walk order, or -1."""
    return _walk_torch(*args, any_hit=True, **kw)[1]


def _trace_closest_two_level_torch(*args, **kw):
    """Plain twin of K3's closest-hit entry → (best t, code)."""
    return _walk_two_level_torch(*args, any_hit=False, **kw)


def _trace_any_two_level_torch(*args, **kw) -> torch.Tensor:
    """Plain twin of K3's any-hit entry → code of the first valid hit in
    walk order, or -1."""
    return _walk_two_level_torch(*args, any_hit=True, **kw)[1]


def _launch_kernel(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                   tri, tile, any_hit: bool = False, group: int = 0):
    """Check the arguments and launch a kernel entry: K1 (``group`` 0) or
    K3 (``group`` = G), closest-hit (→ (t, code)) or any-hit (→ code).
    Counts the launch on its wrapper."""
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
    if group and (
        box.shape[0] != n_cols * group or group > min(tile, 128)
        or tile % 32
    ):
        raise ValueError(
            f"two-level trace kernel: {box.shape[0]} clusters are not "
            f"{n_cols} supers of {group}, or G = {group} exceeds "
            f"min(tile, 128), or tile {tile} is not a multiple of 32"
        )
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
    outs = (code_out.data_ptr(),) if any_hit else (
        t_out.data_ptr(), code_out.data_ptr()
    )
    if group:
        entry = (
            lib.wrt_trace_any_two_level if any_hit
            else lib.wrt_trace_closest_two_level
        )
        wrapper = (
            trace_any_two_level_tiles if any_hit
            else trace_closest_two_level_tiles
        )
        head = head + (group,)
    else:
        entry = lib.wrt_trace_any if any_hit else lib.wrt_trace_closest
        wrapper = trace_any_tiles if any_hit else trace_closest_tiles
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*head, *outs, n_tiles, tile, stream)
    if err != 0:
        raise RuntimeError(
            "cluster trace kernel launch failed: "
            + lib.wrt_error_string(err).decode()
        )
    wrapper.launches += 1
    return code_out if any_hit else (t_out, code_out)


def _dispatch(twin, args, any_hit: bool = False, group: int = 0):
    dev = args[0].device
    if dev.type == "cuda":
        return _launch_kernel(*args, any_hit=any_hit, group=group)
    if dev.type == "cpu":
        return twin(*args, group) if group else twin(*args)
    raise ValueError(f"no cluster trace for device {dev}")


def trace_closest_tiles(o, d, inv_d, t_max, excl, snear, order, box,
                        face_id, tri, tile):
    """K1: per-ray closest hit over each tile's sorted cluster order →
    (best t, code). CUDA tensors launch the kernel (and count the launch
    in ``trace_closest_tiles.launches``); CPU tensors run the plain twin."""
    return _dispatch(_trace_closest_torch, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile))


trace_closest_tiles.launches = 0


def trace_any_tiles(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                    tri, tile):
    """K1: per-ray any-hit over each tile's sorted cluster order → code of
    the first valid hit with t < t_max in walk order, or -1. CUDA tensors
    launch the kernel (and count the launch in
    ``trace_any_tiles.launches``); CPU tensors run the plain twin."""
    return _dispatch(_trace_any_torch, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    ), any_hit=True)


trace_any_tiles.launches = 0


def trace_closest_two_level_tiles(o, d, inv_d, t_max, excl, snear, order,
                                  box, face_id, tri, tile, group):
    """K3: per-ray closest hit over each tile's sorted SUPER order, the G
    children of each super culled and ordered in the kernel → (best t,
    code). CUDA tensors launch the kernel (counted in
    ``trace_closest_two_level_tiles.launches``); CPU tensors run the
    plain twin."""
    return _dispatch(_trace_closest_two_level_torch, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    ), group=group)


trace_closest_two_level_tiles.launches = 0


def trace_any_two_level_tiles(o, d, inv_d, t_max, excl, snear, order, box,
                              face_id, tri, tile, group):
    """K3: per-ray any-hit over each tile's sorted super order → code of
    the first valid hit with t < t_max in walk order, or -1. CUDA tensors
    launch the kernel (counted in
    ``trace_any_two_level_tiles.launches``); CPU tensors run the plain
    twin."""
    return _dispatch(_trace_any_two_level_torch, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    ), any_hit=True, group=group)


trace_any_two_level_tiles.launches = 0


def prepare_tiles(o, d, t_max, tables, active=None, excl_code=None,
                  tile: int = 128, two_level: Optional[bool] = None):
    """Everything a kernel takes, as plain torch: rays padded to whole
    tiles (pad lanes inactive), inactive t_max zeroed, safe reciprocal
    directions, exclusion codes (-1 = none) and each tile's box order
    (ascending tile entry distance, stable sort). The boxes are the
    superclusters when ``two_level`` (default: :func:`is_two_level` of
    the tables), and the dict then carries ``group`` = G for the K3
    wrappers; else the clusters, for the K1 wrappers. Returns a dict of
    the kernel's arguments."""
    ct = tables.clusters
    if two_level is None:
        two_level = is_two_level(ct)
    elif two_level and ct.super_box is None:
        raise ValueError("two_level=True needs two-level cluster tables")
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
    near_boxes = ct.super_box if two_level else ct.box
    near_tc = tile_nears_fused(o, inv_d, t_max, near_boxes, tile)
    snear, order = torch.sort(near_tc, dim=1, stable=True)
    args = dict(
        o=o.contiguous(), d=d.contiguous(), inv_d=inv_d.contiguous(),
        t_max=t_max.contiguous(),
        excl=excl_code.to(torch.int32).contiguous(),
        snear=snear.contiguous(), order=order.to(torch.int32).contiguous(),
        box=ct.box.contiguous(), face_id=ct.face_id.contiguous(),
        tri=tables.tri.contiguous(), tile=tile,
    )
    if two_level:
        args["group"] = ct.group
    return args


def trace_closest_args(args):
    """(wrapper, its plain twin) for the closest-hit entry that takes a
    :func:`prepare_tiles` dict: K3 when it carries ``group``, else K1."""
    if "group" in args:
        return trace_closest_two_level_tiles, _trace_closest_two_level_torch
    return trace_closest_tiles, _trace_closest_torch


def trace_any_args(args):
    """(wrapper, its plain twin) for the any-hit entry that takes a
    :func:`prepare_tiles` dict: K3 when it carries ``group``, else K1."""
    if "group" in args:
        return trace_any_two_level_tiles, _trace_any_two_level_torch
    return trace_any_tiles, _trace_any_torch


def trace_closest_clustered_cuda(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    tables,
    active: Optional[torch.Tensor] = None,
    excl_code: Optional[torch.Tensor] = None,
    tile: int = 128,
) -> Hit:
    """Closest hit per ray → Hit(t, u, v, face), through K3 for two-level
    tables and K1 otherwise. Inactive rays return face -1 and t 0, misses
    return their t_max; the face id is the contract and t, u, v are
    re-derived exactly from it."""
    r0 = o.shape[0]
    args = prepare_tiles(o, d, t_max, tables, active, excl_code, tile)
    best_t, code = trace_closest_args(args)[0](**args)
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
    ray with 0 < t < t_max, through K3 for two-level tables and K1
    otherwise. Inactive rays and NaN origins are unblocked.
    ``prepare_tiles`` feeds t_max into the tile distances, so short rays
    prune boxes there."""
    r0 = o.shape[0]
    args = prepare_tiles(o, d, t_max, tables, active, excl_code, tile)
    return trace_any_args(args)[0](**args)[:r0] >= 0
