"""Cluster trace, closest-hit, any-hit and exact pairs, single- and
two-level: dispatchers, the CUDA kernel wrappers and their plain-torch
twins (counterpart of ``trace_closest_clustered_pallas`` with
``exact_pairs`` False or True and ``any_hit`` False or True, and of
``is_two_level`` and ``code_to_face`` in
``webgpu_raytracing_tpu/ops/cluster_pallas.py``).

Around the kernels, as plain torch (the JAX package does the same outside
Pallas): pad the rays to whole tiles, compute each tile's entry distance
into every box (:func:`.cluster_trace.tile_nears_fused`) and sort every
row ascending with a stable sort, giving each tile its box order. The
boxes are the clusters (single-level: kernels K1, K2p) or, for two-level
tables, the superclusters (K3, K3p, which cull and order each super's G
child clusters themselves). All kernels (``csrc/cluster_trace.cu``) walk
that order per ray. The closest-hit entries return the best ``t`` and
code ``cid * S + slot``; :func:`code_to_face` and :func:`rederive_uv`
then give the face id and the exact t, u, v. The any-hit entries (shadow
rays) return the code of the first valid hit with ``t < t_max`` in walk
order, or -1. The pairs entries (``exact_pairs``) rank candidates on the
bilinear-form estimates A·B (``mat_b``) and return three candidate codes
and an ambiguity flag per ray, which :mod:`.adjudicate` settles exactly.

The six wrappers (:func:`trace_closest_tiles`, :func:`trace_any_tiles`,
:func:`trace_pairs_tiles` and their ``_two_level`` forms) launch their
kernel entry for CUDA tensors, counting each launch in their own
``launches``, and run the plain twin for CPU tensors only; any other
device raises. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import F32_MAX
from .adjudicate import adjudicate_compact
from .cluster_trace import (
    EPS2,
    exact_face_eval,
    ray_matrix,
    rederive_uv,
    tile_nears_fused,
)
from .intersect import Hit, safe_inv_dir
from .strictf import scross, sdot3

_INF = float(F32_MAX)
_F32_MAX_BITS = 0x7F7FFFFF

# Pairs mode (cluster_pallas.py): the validity margin, relative to the
# magnitude |A|·|B|; the stop-rule widening in ulps of the robust best t
# (:566); the near-tie band of the ambiguity flag (:389, without the
# slot-bit term: the port's t is not truncated).
#
# The margin follows the TPU kernel's rule, not its value. There (:60)
# 2^-14 is the bf16 hi/lo error bound, 2^-15 of the magnitude, with 2x
# safety. Here the estimates are f32 sums of at most 6 products, whose
# error is at most about 6 x 2^-24 (2^-21.4) of the magnitude; with 2x
# safety, 2^-20. A wider margin is not safer. Every triangle that a ray
# passes within the margin becomes a candidate, and the margin scales with
# the distance of a triangle from the origin (the q and k0 rows of B), so
# on small triangles the two carried slots fill with such impostors ahead
# of the true winner, whose own hit is then not robust either: with 2^-14,
# 78 of the 2,073,600 primary rays of the 1080p slice and 2,604 of the
# 1,036,800 of a config #5 slab came out wrong after the adjudication,
# with 2^-20 none (tools/torch_pairs_margin.py).
MARGIN = 2.0**-20
BOUND_ULPS = 1 << 9
AMB_BAND = 2 * BOUND_ULPS
# The structurally nonzero rows of mat_b in each column block
# (pack_cluster_tables): det = d·(-n), t_num = o·n - k0, u_num = w·e2 +
# d·q2, v_num = -(w·e1) - d·q1, over A = [o | w = o×d | d | 1]. The pairs
# kernels and twins sum exactly these terms, in this row order.
PAIRS_ROWS = ((6, 7, 8), (0, 1, 2, 9), (3, 4, 5, 6, 7, 8),
              (3, 4, 5, 6, 7, 8))


def code_to_face(code: torch.Tensor, face_id: torch.Tensor) -> torch.Tensor:
    """Cluster-slot code → global face id (-1 stays -1)."""
    f = face_id.reshape(-1)[code.clamp(min=0).long()]
    return torch.where(code >= 0, f, torch.full_like(f, -1)).to(torch.int32)


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
        t_c, code_c = _cluster_min(ok, t, codes, big)
        b_t, b_c = best[rr], best_code[rr]
        better = _lex_less(t_c, code_c, b_t, b_c)
        best[rr] = torch.where(better, t_c, b_t)
        best_code[rr] = torch.where(better, code_c, b_c)


def _lex_less(ta, ca, tb, cb):
    """(ta, ca) < (tb, cb) in lexicographic order."""
    return (ta < tb) | ((ta == tb) & (ca < cb))


def _cluster_min(mask, t, codes, big):
    """The lexicographic minimum (t, code) over each row's ``mask`` →
    ((m,) t, (m,) code); (inf, big) where the mask is empty."""
    t_m = torch.amin(torch.where(mask, t, torch.full_like(t, float("inf"))),
                     dim=1)
    c_m = torch.amin(
        torch.where(mask & (t == t_m[:, None]), codes,
                    torch.full_like(codes, big)),
        dim=1,
    )
    return t_m, c_m


class _PairsState:
    """The pairs walk's carried state per ray: (t1, c1) and (t2, c2), the
    two smallest margin-valid (t, code) pairs, and (t3, c3), the smallest
    robust pair, all starting at (t_max, -1)."""

    def __init__(self, t_max):
        self.t1, self.t2, self.t3 = t_max.clone(), t_max.clone(), t_max.clone()
        neg = torch.full(t_max.shape, -1, dtype=torch.int32,
                         device=t_max.device)
        self.c1, self.c2, self.c3 = neg, neg.clone(), neg.clone()

    def bound(self, rays):
        """The stop and skip bound: the robust best t widened by
        BOUND_ULPS ulps on its bits (unsigned 32-bit arithmetic), capped
        at F32_MAX."""
        bits = self.t3[rays].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        bits = ((bits + BOUND_ULPS) & 0xFFFFFFFF).clamp(max=_F32_MAX_BITS)
        return bits.to(torch.int32).view(torch.float32)

    def outputs(self):
        """(t1, c1, c2, c3, amb) with amb = (c3 != c1) | (c2 >= 0 and the
        bits of t2 and t1 less than AMB_BAND apart)."""
        gap = (self.t2.view(torch.int32).to(torch.int64)
               - self.t1.view(torch.int32).to(torch.int64))
        amb = (self.c3 != self.c1) | ((self.c2 >= 0) & (gap < AMB_BAND))
        return self.t1, self.c1, self.c2, self.c3, amb.to(torch.int32)


def _pairs_columns(mat_b):
    """mat_b's structurally nonzero (row, column block) slices, in
    PAIRS_ROWS order → (C, 19, S)."""
    s = mat_b.shape[2] // 4
    return torch.stack(
        [mat_b[:, row, blk * s : (blk + 1) * s]
         for blk, rows in enumerate(PAIRS_ROWS) for row in rows],
        dim=1,
    )


def _test_clusters_pairs(rays, cids, a, excl, face_id, bcols, st, chunk,
                         stats) -> None:
    """The pairs slot test (``_round_pick``'s pairs branch,
    cluster_pallas.py:236-270 and :335-373), ray ``rays[i]`` against the
    occupied slots of cluster ``cids[i]``, merged into ``st``.

    Estimates: det, t_num, u_num, v_num are A·B over the rows of
    PAIRS_ROWS, strict products summed left to right in that order; the
    magnitudes are |A|·|B| over the same terms. With m_x = magnitude_x ×
    MARGIN, a slot is margin-valid when ``det >= EPS2`` (not margined),
    ``u >= -m_u``, ``u <= det + m_u``, ``v >= -m_v`` and
    ``u + v <= (det + m_u) + m_v``, and ``t = t_num / det`` (IEEE) is
    above 0; robust when it is margin-valid and passes every gate with
    the margin negated, ``det >= EPS2 + m_d`` and ``t_num >= m_t``. The
    exclusion code masks both sets. The kernel inserts slot by slot; the
    result is the same set minimum, so here each cluster's two smallest
    margin-valid pairs and smallest robust pair are merged at once."""
    s = face_id.shape[1]
    slot_iota = torch.arange(s, dtype=torch.int32, device=a.device)
    big = torch.iinfo(torch.int32).max
    for c0 in range(0, rays.numel(), chunk):
        rr, cc = rays[c0 : c0 + chunk], cids[c0 : c0 + chunk]
        fid = face_id[cc]  # (m, S)
        codes = cc.to(torch.int32)[:, None] * s + slot_iota[None, :]
        present = (fid >= 0) & (codes != excl[rr][:, None])
        ar = a[rr]
        aa = ar.abs()
        est, mag = [], []
        j = 0
        for rows in PAIRS_ROWS:
            e = m = None
            for row in rows:
                b = bcols[cc, j]  # (m, S)
                pe = ar[:, row, None] * b
                pm = aa[:, row, None] * b.abs()
                e = pe if e is None else e + pe
                m = pm if m is None else m + pm
                j += 1
            est.append(e)
            mag.append(m)
        det, t_num, u, v = est
        m_d, m_t, m_u, m_v = (x * MARGIN for x in mag)
        past_cull = present & (det >= EPS2)
        uv = u + v
        t = t_num / det
        valid = (
            past_cull & (u >= -m_u) & (u <= det + m_u) & (v >= -m_v)
            & (uv <= (det + m_u) + m_v) & (t > 0.0)
        )
        robust = (
            valid & (det >= EPS2 + m_d) & (u >= m_u) & (u <= det - m_u)
            & (v >= m_v) & (uv <= (det - m_u) - m_v) & (t_num >= m_t)
        )
        if stats is not None:
            _count(stats, "slot_tests", present.sum())
            _count(stats, "slot_tests_past_cull", past_cull.sum())
            stats["clusters_tested"][cc] = True
        q1t, q1c = _cluster_min(valid, t, codes, big)
        q2t, q2c = _cluster_min(valid & (codes != q1c[:, None]), t, codes,
                                big)
        q3t, q3c = _cluster_min(robust, t, codes, big)
        p1t, p1c, p2t, p2c = st.t1[rr], st.c1[rr], st.t2[rr], st.c2[rr]
        first = _lex_less(q1t, q1c, p1t, p1c)
        # top two of {p1, p2, q1, q2}: q1 ahead of p1 leaves min(p1, q2)
        # second, else min(p2, q1)
        at = torch.where(first, p1t, p2t)
        ac = torch.where(first, p1c, p2c)
        bt = torch.where(first, q2t, q1t)
        bc = torch.where(first, q2c, q1c)
        second = _lex_less(bt, bc, at, ac)
        st.t1[rr] = torch.where(first, q1t, p1t)
        st.c1[rr] = torch.where(first, q1c, p1c)
        st.t2[rr] = torch.where(second, bt, at)
        st.c2[rr] = torch.where(second, bc, ac)
        p3t, p3c = st.t3[rr], st.c3[rr]
        third = _lex_less(q3t, q3c, p3t, p3c)
        st.t3[rr] = torch.where(third, q3t, p3t)
        st.c3[rr] = torch.where(third, q3c, p3c)


def _walk_setup(o, face_id, chunk, stats):
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
    return chunk


def _walk(o, inv_d, snear, order, box, tile, bound, test, pending, stats):
    """The single-level walk of K1 and K2p, vectorized over the rays
    still walking. Step k takes every live ray's k-th cluster of its
    tile's order; a ray leaves the walk at the first entry whose tile
    distance is not below ``bound(rays)`` (or once ``pending(rays)`` is
    false), skips a cluster its own slab test rejects or enters no nearer
    than its bound, and otherwise tests the cluster: ``test(rays, cids)``."""
    dev = o.device
    tile_of = torch.arange(o.shape[0], device=dev) // tile
    live = torch.arange(o.shape[0], device=dev)
    for k in range(snear.shape[1]):
        if stats is not None:
            _count(stats, "table_steps", torch.unique(tile_of[live]).numel())
        live = live[~(snear[tile_of[live], k] >= bound(live))]
        if live.numel() == 0:
            break
        cid = order[tile_of[live], k].long()
        near, far = _slab(box[cid], o[live], inv_d[live])
        if stats is not None:
            _count(stats, "box_tests", live.numel())
            stats["boxes_read"][cid] = True
        consider = (near < far) & (far > 0.0) & (near < bound(live))
        test(live[consider], cid[consider])
        if pending is not None:
            live = live[pending(live)]


def _walk_torch(
    o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    any_hit: bool, chunk: Optional[int] = None, stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K1 (both entries): :func:`_walk` with the best
    t (any-hit: t_max, until the ray has a hit) as its bound and the exact
    slot test, in chunks of ``chunk`` rays (default 2**18 on a GPU, 2**15
    elsewhere). Returns (best t, code); any-hit leaves best t at t_max.
    ``stats`` (a dict) accumulates the work this walk does (see
    :func:`walk_stats`)."""
    chunk = _walk_setup(o, face_id, chunk, stats)
    best = t_max.clone()
    best_code = torch.full((o.shape[0],), -1, dtype=torch.int32,
                           device=o.device)

    def test(rays, cids):
        _test_clusters(rays, cids, o, d, excl, face_id, tri, best, best_code,
                       any_hit, chunk, stats)

    _walk(o, inv_d, snear, order, box, tile, lambda r: best[r], test,
          (lambda r: best_code[r] < 0) if any_hit else None, stats)
    return best, best_code


def _walk_pairs_torch(
    a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile,
    chunk: Optional[int] = None, stats: Optional[dict] = None,
):
    """Plain-torch twin of K2p: K1's walk (:func:`_walk`) with the pairs
    slot test (:func:`_test_clusters_pairs`) and the stop and skip bound
    anchored on the ROBUST best t3, widened by BOUND_ULPS ulps
    (cluster_pallas.py:552-566, :583-590): a bound on t1 would let a
    margin-limbo impostor stop the walk before the true winner's cluster.
    ``a`` is the ray matrix (R, 10), whose columns 0:3 are the origins.
    Returns (t1, c1, c2, c3, amb).

    Unlike ``_round_pick``, which merges packed (t | slot) keys whose low
    mantissa bits are truncated, the carried pairs are exact (t, code)
    pairs in lexicographic order, as K1 keeps its best; so the flag has no
    slot-bit term."""
    chunk = _walk_setup(a, face_id, chunk, stats)
    st = _PairsState(t_max)
    bcols = _pairs_columns(mat_b)

    def test(rays, cids):
        _test_clusters_pairs(rays, cids, a, excl, face_id, bcols, st, chunk,
                             stats)

    _walk(a[:, 0:3], inv_d, snear, order, box, tile, st.bound, test, None,
          stats)
    return st.outputs()


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


def _walk_two_level(o, inv_d, t_max, snear, order, box, face_id, tile,
                    group, bound, test, pending, stats):
    """The two-level walk of K3 and K3p, vectorized over the rays still
    walking, in exactly the kernel's order. Outer step k: a ray stays in
    the walk while the tile distance of its tile's k-th super is below
    ``bound(rays)`` (and ``pending(rays)`` holds); every tile with a ray
    left takes the minima of the super's G children over ALL its rays
    (:func:`_child_minima`) and ranks the children by (minimum, index),
    a stable ascending sort. Inner step q: each remaining ray takes its
    tile's q-th child unless that child's minimum is not below its bound
    (the kernel's break: minima ascend and the bound only falls), skips it
    if its own slab test rejects it, and otherwise tests its slots."""
    dev = o.device
    n_tiles = o.shape[0] // tile
    tile_of = torch.arange(o.shape[0], device=dev) // tile
    live = torch.arange(o.shape[0], device=dev)
    full = face_id[:, 0] >= 0
    g_iota = torch.arange(group, device=dev)
    pos_of = torch.full((n_tiles,), -1, dtype=torch.long, device=dev)
    for k in range(snear.shape[1]):
        live = live[~(snear[tile_of[live], k] >= bound(live))]
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
            inner = inner[~(cmin[pos, q] >= bound(inner))]
            if inner.numel() == 0:
                break
            cid = cids[pos_of[tile_of[inner]], q]
            near, far = _slab(box[cid], o[inner], inv_d[inner])
            _count(stats, "box_tests", inner.numel())
            consider = (near < far) & (far > 0.0) & (near < bound(inner))
            test(inner[consider], cid[consider])
            if pending is not None:
                inner = inner[pending(inner)]
        if pending is not None:
            live = live[pending(live)]


def _walk_two_level_torch(
    o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile, group,
    any_hit: bool, chunk: Optional[int] = None, stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K3 (both entries): :func:`_walk_two_level` with
    the best t (any-hit: t_max, until the ray has a hit) as its bound and
    K1's exact slot test. Returns (best t, code)."""
    chunk = _walk_setup(o, face_id, chunk, stats)
    best = t_max.clone()
    best_code = torch.full((o.shape[0],), -1, dtype=torch.int32,
                           device=o.device)

    def test(rays, cids):
        _test_clusters(rays, cids, o, d, excl, face_id, tri, best, best_code,
                       any_hit, chunk, stats)

    _walk_two_level(o, inv_d, t_max, snear, order, box, face_id, tile, group,
                    lambda r: best[r], test,
                    (lambda r: best_code[r] < 0) if any_hit else None, stats)
    return best, best_code


def _walk_pairs_two_level_torch(
    a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile, group,
    chunk: Optional[int] = None, stats: Optional[dict] = None,
):
    """Plain-torch twin of K3p: K3's walk (:func:`_walk_two_level`) with
    K2p's slot test and K2p's widened robust bound, which gates the super
    walk, the child walk and the per-ray skip alike. Returns (t1, c1, c2,
    c3, amb); see :func:`_walk_pairs_torch`."""
    chunk = _walk_setup(a, face_id, chunk, stats)
    st = _PairsState(t_max)
    bcols = _pairs_columns(mat_b)

    def test(rays, cids):
        _test_clusters_pairs(rays, cids, a, excl, face_id, bcols, st, chunk,
                             stats)

    _walk_two_level(a[:, 0:3], inv_d, t_max, snear, order, box, face_id,
                    tile, group, st.bound, test, None, stats)
    return st.outputs()


# f32 operations per test, for the work counts of walk_stats: a slab test
# (per axis 2 sub, 2 mul, min, max; 4 to combine the axes; 3 compares); a
# triangle slot up to its cull (d x e2, det, the compare) and past it (s,
# u, s x e1, v, t_num, the gates, the divide, two compares)
BOX_TEST_OPS = 25
SLOT_CULL_OPS = 15
SLOT_REST_OPS = 35
# a pairs slot up to its cull (the 3 terms of det, the compare) and past
# it (t_num, u, v: 16 terms; the magnitudes of all four: 19 terms, as
# many products and 15 adds; 4 margins, 6 gate sums, 10 gate compares,
# the divide, t > 0, 4 merge compares)
PAIRS_SLOT_CULL_OPS = 6
PAIRS_SLOT_REST_OPS = 29 + 34 + 4 + 6 + 10 + 1 + 1 + 4
PAIRS_ESTIMATE_TERMS = (3, 16)  # A·B terms per slot up to / past the cull
PAIRS_MAGNITUDE_TERMS = 19  # |A|·|B| terms per slot past the cull


def walk_stats(stats: dict, face_id: torch.Tensor, any_hit: bool,
               pairs: bool = False) -> dict:
    """The work a twin's walk counted in ``stats``, as f32 operations and
    the least bytes the kernel must move: each ray's inputs read once and
    its outputs written once (o, d, inv_d, t_max, excl → t, code; pairs:
    A, inv_d, t_max, excl → t1, three codes, the flag), the table entries
    (tile distance and order) the tiles stepped through, each box read,
    and the face ids of each cluster tested with, per occupied slot, the
    triangle row (pairs: the 19 B entries of its columns)."""
    tested = stats["clusters_tested"]
    n_faces = int((face_id[tested] >= 0).sum())
    slot_tests = stats.get("slot_tests", 0)
    past_cull = stats.get("slot_tests_past_cull", 0)
    if pairs:
        slot_ops = (PAIRS_SLOT_CULL_OPS * slot_tests
                    + PAIRS_SLOT_REST_OPS * past_cull)
        ray_bytes, face_bytes = 60 + 20, 4 * PAIRS_MAGNITUDE_TERMS
    else:
        slot_ops = SLOT_CULL_OPS * slot_tests + SLOT_REST_OPS * past_cull
        ray_bytes, face_bytes = 44 + (4 if any_hit else 8), 36
    n_bytes = (
        ray_bytes * stats["rays"]
        + 8 * stats.get("table_steps", 0)
        + 24 * int(stats["boxes_read"].sum())
        + 4 * face_id.shape[1] * int(tested.sum())
        + face_bytes * n_faces
    )
    out = dict(
        ops=BOX_TEST_OPS * stats.get("box_tests", 0) + slot_ops,
        bytes=n_bytes, box_tests=stats.get("box_tests", 0),
        slot_tests=slot_tests, clusters_tested=int(tested.sum()),
        faces_tested=n_faces,
    )
    if pairs:
        out["estimate_terms"] = (PAIRS_ESTIMATE_TERMS[0] * slot_tests
                                 + PAIRS_ESTIMATE_TERMS[1] * past_cull)
        out["magnitude_terms"] = PAIRS_MAGNITUDE_TERMS * past_cull
    return out


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


def _check_cuda(tensors: dict) -> torch.device:
    """The device of a kernel's tensors, which must all be contiguous, of
    their dtype and on one CUDA device."""
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"the cluster trace kernel takes CUDA tensors, not {dev}")
    for name, (x, dt) in tensors.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {dt} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    return dev


def _check_walk(r, inv_d, t_max, excl, snear, order, box, face_id, tile,
                group):
    """Shapes every walk takes → (n_tiles, n_cols)."""
    n_tiles, n_cols = snear.shape
    if (
        r != n_tiles * tile or inv_d.shape != (r, 3) or t_max.shape != (r,)
        or excl.shape != (r,) or order.shape != snear.shape
        or box.shape != (face_id.shape[0], 6) or not 0 < tile <= 1024
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
    return n_tiles, n_cols


def _run(lib, entry, wrapper, dev, args) -> None:
    """Launch ``entry`` on the current stream of ``dev``, raise on a
    launch error, count the launch on ``wrapper``."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(
            "cluster trace kernel launch failed: "
            + lib.wrt_error_string(err).decode()
        )
    wrapper.launches += 1


def _launch_kernel(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                   tri, tile, any_hit: bool = False, group: int = 0):
    """Check the arguments and launch a kernel entry: K1 (``group`` 0) or
    K3 (``group`` = G), closest-hit (→ (t, code)) or any-hit (→ code).
    Counts the launch on its wrapper."""
    from ._build import load

    dev = _check_cuda(dict(
        o=(o, torch.float32), d=(d, torch.float32),
        inv_d=(inv_d, torch.float32), t_max=(t_max, torch.float32),
        excl=(excl, torch.int32), snear=(snear, torch.float32),
        order=(order, torch.int32), box=(box, torch.float32),
        face_id=(face_id, torch.int32), tri=(tri, torch.float32),
    ))
    r = o.shape[0]
    if o.shape != (r, 3) or d.shape != (r, 3) or tri.shape[1:] != (9,):
        raise ValueError("cluster trace kernel: inconsistent shapes")
    n_tiles, n_cols = _check_walk(r, inv_d, t_max, excl, snear, order, box,
                                  face_id, tile, group)
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
    _run(lib, entry, wrapper, dev, head + outs + (n_tiles, tile))
    return code_out if any_hit else (t_out, code_out)


def _launch_pairs(a, inv_d, t_max, excl, snear, order, box, face_id, mat_b,
                  tile, group: int = 0):
    """Check the arguments and launch a pairs entry: K2p (``group`` 0) or
    K3p (``group`` = G) → (t1, c1, c2, c3, amb). Counts the launch on its
    wrapper."""
    from ._build import load

    dev = _check_cuda(dict(
        a=(a, torch.float32), inv_d=(inv_d, torch.float32),
        t_max=(t_max, torch.float32), excl=(excl, torch.int32),
        snear=(snear, torch.float32), order=(order, torch.int32),
        box=(box, torch.float32), face_id=(face_id, torch.int32),
        mat_b=(mat_b, torch.float32),
    ))
    r = a.shape[0]
    c, s = face_id.shape
    if a.shape != (r, 10) or mat_b.shape != (c, 10, 4 * s):
        raise ValueError("pairs trace kernel: inconsistent shapes")
    n_tiles, n_cols = _check_walk(r, inv_d, t_max, excl, snear, order, box,
                                  face_id, tile, group)
    lib = load()
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    codes = [torch.empty((r,), dtype=torch.int32, device=dev)
             for _ in range(4)]  # c1, c2, c3, amb
    head = (
        a.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(), excl.data_ptr(),
        snear.data_ptr(), order.data_ptr(), n_cols, box.data_ptr(),
        face_id.data_ptr(), s, mat_b.data_ptr(), EPS2, MARGIN,
    )
    outs = (t_out.data_ptr(),) + tuple(x.data_ptr() for x in codes)
    if group:
        entry = lib.wrt_trace_pairs_two_level
        wrapper = trace_pairs_two_level_tiles
        head = head + (group,)
    else:
        entry, wrapper = lib.wrt_trace_pairs, trace_pairs_tiles
    _run(lib, entry, wrapper, dev, head + outs + (n_tiles, tile))
    return (t_out, *codes)


def _dispatch(twin, launch, args, group: int = 0, **kw):
    dev = args[0].device
    if dev.type == "cuda":
        return launch(*args, group=group, **kw)
    if dev.type == "cpu":
        return twin(*args, group) if group else twin(*args)
    raise ValueError(f"no cluster trace for device {dev}")


def trace_closest_tiles(o, d, inv_d, t_max, excl, snear, order, box,
                        face_id, tri, tile):
    """K1: per-ray closest hit over each tile's sorted cluster order →
    (best t, code). CUDA tensors launch the kernel (and count the launch
    in ``trace_closest_tiles.launches``); CPU tensors run the plain twin."""
    return _dispatch(_trace_closest_torch, _launch_kernel, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile))


trace_closest_tiles.launches = 0


def trace_any_tiles(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                    tri, tile):
    """K1: per-ray any-hit over each tile's sorted cluster order → code of
    the first valid hit with t < t_max in walk order, or -1. CUDA tensors
    launch the kernel (and count the launch in
    ``trace_any_tiles.launches``); CPU tensors run the plain twin."""
    return _dispatch(_trace_any_torch, _launch_kernel, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    ), any_hit=True)


trace_any_tiles.launches = 0


def trace_pairs_tiles(a, inv_d, t_max, excl, snear, order, box, face_id,
                      mat_b, tile):
    """K2p: the exact-pairs trace over each tile's sorted cluster order →
    (t1, c1, c2, c3, amb): the two nearest margin-valid candidates (t1 is
    the first one's estimated t, or t_max), the nearest robust one and
    the ambiguity flag (:func:`_walk_pairs_torch`). CUDA tensors launch
    the kernel (counted in ``trace_pairs_tiles.launches``); CPU tensors
    run the plain twin."""
    return _dispatch(_walk_pairs_torch, _launch_pairs, (
        a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile))


trace_pairs_tiles.launches = 0


def trace_closest_two_level_tiles(o, d, inv_d, t_max, excl, snear, order,
                                  box, face_id, tri, tile, group):
    """K3: per-ray closest hit over each tile's sorted SUPER order, the G
    children of each super culled and ordered in the kernel → (best t,
    code). CUDA tensors launch the kernel (counted in
    ``trace_closest_two_level_tiles.launches``); CPU tensors run the
    plain twin."""
    return _dispatch(_trace_closest_two_level_torch, _launch_kernel, (
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
    return _dispatch(_trace_any_two_level_torch, _launch_kernel, (
        o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    ), group=group, any_hit=True)


trace_any_two_level_tiles.launches = 0


def trace_pairs_two_level_tiles(a, inv_d, t_max, excl, snear, order, box,
                                face_id, mat_b, tile, group):
    """K3p: the exact-pairs trace over each tile's sorted super order →
    (t1, c1, c2, c3, amb), as K2p. CUDA tensors launch the kernel
    (counted in ``trace_pairs_two_level_tiles.launches``); CPU tensors run
    the plain twin."""
    return _dispatch(_walk_pairs_two_level_torch, _launch_pairs, (
        a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile,
    ), group=group)


trace_pairs_two_level_tiles.launches = 0


def prepare_tiles(o, d, t_max, tables, active=None, excl_code=None,
                  tile: int = 128, two_level: Optional[bool] = None,
                  pairs: bool = False):
    """Everything a kernel takes, as plain torch: rays padded to whole
    tiles (pad lanes inactive), inactive t_max zeroed, safe reciprocal
    directions, exclusion codes (-1 = none) and each tile's box order
    (ascending tile entry distance, stable sort). The boxes are the
    superclusters when ``two_level`` (default: :func:`is_two_level` of
    the tables), and the dict then carries ``group`` = G for the
    two-level wrappers; else the clusters. With ``pairs`` the dict holds
    the ray matrix ``a`` and ``mat_b`` for the pairs wrappers in place of
    o, d and ``tri``. Returns a dict of the kernel's arguments."""
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
    rays = (
        dict(a=ray_matrix(o, d).contiguous()) if pairs
        else dict(o=o.contiguous(), d=d.contiguous())
    )
    args = dict(
        **rays, inv_d=inv_d.contiguous(), t_max=t_max.contiguous(),
        excl=excl_code.to(torch.int32).contiguous(),
        snear=snear.contiguous(), order=order.to(torch.int32).contiguous(),
        box=ct.box.contiguous(), face_id=ct.face_id.contiguous(),
    )
    if pairs:
        args["mat_b"] = ct.mat_b.contiguous()
    else:
        args["tri"] = tables.tri.contiguous()
    args["tile"] = tile
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


def trace_pairs_args(args):
    """(wrapper, its plain twin) for the pairs entry that takes a
    :func:`prepare_tiles` dict made with ``pairs=True``: K3p when it
    carries ``group``, else K2p."""
    if "group" in args:
        return trace_pairs_two_level_tiles, _walk_pairs_two_level_torch
    return trace_pairs_tiles, _walk_pairs_torch


def trace_closest_clustered_cuda(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    tables,
    active: Optional[torch.Tensor] = None,
    excl_code: Optional[torch.Tensor] = None,
    tile: int = 128,
    exact_pairs: bool = False,
) -> Hit:
    """Closest hit per ray → Hit(t, u, v, face), through K3 for two-level
    tables and K1 otherwise. Inactive rays return face -1 and t 0, misses
    return their t_max; the face id is the contract and t, u, v are
    re-derived exactly from it.

    ``exact_pairs`` takes the pairs route instead (JAX ``exact_pairs``):
    K3p or K2p, the three carried codes to faces, then
    :func:`.adjudicate.adjudicate_compact` against the padded,
    activity-masked t_max, as the JAX package passes it."""
    r0 = o.shape[0]
    args = prepare_tiles(o, d, t_max, tables, active, excl_code, tile,
                         pairs=exact_pairs)
    fid = tables.clusters.face_id
    if exact_pairs:
        t1, c1, c2, c3, amb = trace_pairs_args(args)[0](**args)
        faces = tuple(code_to_face(c[:r0], fid) for c in (c1, c2, c3))
        return adjudicate_compact(o, d, args["t_max"][:r0], t1[:r0], faces,
                                  amb[:r0], tables)
    best_t, code = trace_closest_args(args)[0](**args)
    return rederive_uv(o, d, best_t[:r0], code_to_face(code[:r0], fid),
                       tables)


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
