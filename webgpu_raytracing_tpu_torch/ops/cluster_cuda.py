"""Cluster trace, closest-hit, any-hit and exact pairs, single- and
two-level: dispatchers, the CUDA kernel wrappers and their plain-torch
twins (counterpart of ``trace_closest_clustered_pallas`` with
``exact_pairs`` False or True and ``any_hit`` False or True, and of
``is_two_level`` and ``code_to_face`` in
``webgpu_raytracing_tpu/ops/cluster_pallas.py``).

Around the kernels, as plain torch (the JAX package does the same outside
Pallas): pad the rays to whole tiles and, for the kernels that take their
order from outside (``near="outside"``; ``kernel_near=False``), compute each
tile's entry distance into every box
(:func:`.cluster_trace.tile_nears_fused`) and sort every row ascending with
a stable sort, giving each tile its box order. The
boxes are the clusters (single-level: kernels K1, K2p) or, for two-level
tables, the superclusters (K3, K3p, which cull and order each super's G
child clusters themselves). With ``near="kernel"`` (``kernel_near``, the
renderer's default) the kernel makes that order itself, tile by tile: K2n
over the clusters, K3 / K3p over the supers, and neither the distances nor
the sort run outside. All kernels (``csrc/cluster_trace.cu``) walk
that order per ray. The closest-hit entries return the best ``t`` and
code ``cid * S + slot``; :func:`code_to_face` and :func:`rederive_uv`
then give the face id and the exact t, u, v. The any-hit entries (shadow
rays) return the code of the first valid hit with ``t < t_max`` in walk
order, or -1. The pairs entries (``exact_pairs``) rank candidates on the
bilinear-form estimates A·B (``mat_b``) and return three candidate codes
and an ambiguity flag per ray, which :mod:`.adjudicate` settles exactly.

The tile-scheduling kernels return the same results another way (JAX
``sched_rounds``, ``kernel_near``, ``pipeline_rounds``): K5 runs K1's
order in rounds of several clusters staged in shared memory, looking at
the stop bound once per round; K2n computes the tile entry distances and
the order inside the kernel, so that the plain-torch pass and the sort
above are not run at all (and K3 / K3p do the same over their supers,
which the JAX dispatcher does not offer); K2pl fetches the next cluster
while the current one is tested.

K4 (:func:`trace_binned_tiles`, :func:`trace_binned_pass`; JAX
``trace_binned_pass``) is the pass of the binned traces (ops/ray_sort.py):
each 128-ray block of a ray stream sorted by nearest cluster tests the two
clusters of its schedule, staged in shared memory, with K1's gate and slot
test and no order at all. The ray sort's coherence key
(:func:`top_keys_tiles`, twin :func:`_top_keys_torch`; JAX
``nearest_cluster_key`` and ``nearest_cluster_keys2``, XLA code there) is
a kernel too: each ray's n nearest entered boxes as packed int32 keys.
The drain kernels take the hooks of those traces and of the multipass
trace (JAX ``t_start``, ``cap``, ``return_stop``): ``t_start`` leaves the
boxes a ray entered nearer than that out of its tile's order, ``cap`` ends
every tile's walk after that many clusters and reports where it stopped,
and ``start_code`` carries an earlier pass's best code in beside its best
t (given as t_max), so that a later pass keeps K1's tie rule.

The wrappers (:func:`trace_closest_tiles`, :func:`trace_any_tiles`,
:func:`trace_pairs_tiles` and their ``_two_level`` forms;
:func:`trace_sched_tiles`; ``trace_near_{closest,any,pairs}_tiles`` and
their ``_two_level`` forms;
``trace_pipelined_{closest,any,pairs}_tiles``; :func:`trace_binned_tiles`;
:func:`top_keys_tiles`; each a routed ``_build.Kernel`` made from its
launcher, its twin and the keywords that tell the entries apart)
launch their kernel entry for CUDA tensors, counting each launch in their
own ``launches``, and run the plain twin (their ``twin``) for CPU tensors
only; any other device raises. Their ``route`` (ROUTES; ``traversal``
``"pallas"`` and ``"pallas_interpret"``) can instead ask for the kernel
alone, which raises for tensors that are not on a CUDA device, or for the
twin on any device. A kernel's rays must lie on the current CUDA device
(``_build.check_current_device``). There is no
fallback from one to the other, and what a kernel does not take (two-level
tables for K5 and K2pl, more boxes than a block orders, tiles of more
than 128 rays or of a part of a warp, rounds K5 does not run) raises.
Every walk but K4's keeps a warp in step and lets its lanes share their
slot scans; that changes the kernels' work, never their results.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..config import F32_MAX, TRACE_SCHED_VALUES
from ..utils.timing import span, traced
from ._build import ROUTES, Kernel, check_args, check_current_device, launch
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
_I32_MAX = 0x7FFFFFFF
# the stop of a tile that walked its whole order: no best t lies above it
STOP_DRAINED = 0x7FFFFFFF

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


def _shared_scans(rays, serial: int) -> torch.Tensor:
    """Which of the rays that want a cluster at one step of a walk with
    the warp in step (all but K4's) have it scanned by their whole warp
    (``coop_test``): those of a warp (32 consecutive rays) in which fewer
    than ``serial`` rays want it."""
    _, inv, cnt = torch.unique(torch.div(rays, 32, rounding_mode="floor"),
                               return_inverse=True, return_counts=True)
    return cnt[inv] < serial


def _lane_tests(ok, present, slot_iota):
    """The slots an any-hit scan shared by a warp tests: lane l takes
    the slots l, l + 32, ... and stops after the first valid one of them
    (``ok``) → (m, S) mask."""
    m, s = ok.shape
    pad = (-s) % 32
    at = torch.where(ok, slot_iota, torch.full_like(slot_iota, s))
    at = torch.nn.functional.pad(at, (0, pad), value=s)
    lane_first = torch.amin(at.view(m, -1, 32), dim=1)  # (m, 32)
    return present & (slot_iota[None, :]
                      <= lane_first[:, (slot_iota % 32).long()])


def _test_clusters(rays, cids, o, d, excl, face_id, tri, best, best_code,
                   any_hit: bool, chunk: int, stats,
                   coop: bool = False) -> None:
    """Ray ``rays[i]`` tests the occupied slots of cluster ``cids[i]``, in
    chunks of ``chunk`` rays, updating ``best`` / ``best_code`` in place.
    The closest-hit winner is the lexicographic minimum of (t, code),
    exactly what the kernel's sequential slot loop keeps; the any-hit
    winner is the LOWEST valid slot (the kernel stops at the first one).

    ``coop``: the kernel's warps walk in step and share their slot scans
    (every walk but K4's). ``stats`` then also counts, as
    ``kernel_slot_tests``, the tests of an any-hit scan shared by a warp,
    which go past the first valid slot: work of the kernel, not of its
    function."""
    s = face_id.shape[1]
    slot_iota = torch.arange(s, dtype=torch.int32, device=o.device)
    big = torch.iinfo(torch.int32).max
    inf = float("inf")
    shared = None
    if coop and any_hit and stats is not None:
        shared = _shared_scans(rays, COOP_SERIAL)
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
            if shared is not None:
                k_tested = torch.where(shared[c0 : c0 + chunk, None],
                                       _lane_tests(ok, present, slot_iota),
                                       tested)
                _count(stats, "kernel_slot_tests", k_tested.sum())
                _count(stats, "kernel_slot_tests_past_cull",
                       (k_tested & ~(det < EPS2)).sum())
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
            _count_pairs_work(stats, past_cull, det, u, v, uv, m_u, m_v,
                              valid, _lex_less(t, codes, st.t3[rr][:, None],
                                               st.c3[rr][:, None]))
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


def _count_pairs_work(stats, past_cull, det, u, v, uv, m_u, m_v, valid,
                      below_t3) -> None:
    """What the pairs slot test needs past its cull, gate by gate (the
    kernel's ``pairs_scan`` does just this): a gate takes its magnitudes
    only when its estimate lies outside the exact triangle (u in [0, det],
    v >= 0, u + v <= det), t_num and the divide come past every gate, and
    the robust test (with the magnitudes of det and t_num) only for a
    valid slot below the robust pair it could replace; here the pair the
    ray carried into the cluster, which counts a few tests more than the
    kernel's running pair."""
    margined_u = past_cull & ~((u >= 0.0) & (u <= det))
    u_pass = past_cull & (u >= -m_u) & (u <= det + m_u)
    margined_v = u_pass & ~(v >= 0.0)
    v_pass = u_pass & (v >= -m_v)
    margined_uv = v_pass & ~(uv <= det)
    robust_tests = valid & below_t3
    for key, mask in (
        ("pairs_margined_u", margined_u), ("pairs_u_pass", u_pass),
        ("pairs_margined_v", margined_v), ("pairs_v_pass", v_pass),
        ("pairs_margined_uv", margined_uv),
        ("pairs_gate_pass", v_pass & (uv <= (det + m_u) + m_v)),
        ("pairs_valid", valid), ("pairs_robust_tests", robust_tests),
        ("pairs_magnitudes_u", margined_u | margined_uv | robust_tests),
        ("pairs_magnitudes_v", margined_v | margined_uv | robust_tests),
    ):
        _count(stats, key, mask.sum())


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


def _walk(o, inv_d, snear, order, box, tile, bound, test, pending, stats,
          jblk: int = 1, pipelined: bool = False, cap: int = 0):
    """The single-level walk of K1, K2p, K2n, K5 and K2pl, vectorized over
    the rays still walking. The order is run in rounds of ``jblk``
    clusters. A ray votes for a round when the tile distance of the
    round's first entry is below its bound, ``bound(rays)``, and leaves
    the walk at the first round it does not vote for (or once
    ``pending(rays)`` is false). Within a round it takes the entries whose
    tile distance is below the bound of its vote, skips a cluster its own
    slab test rejects or enters no nearer than that bound, and otherwise
    tests the cluster: ``test(rays, cids)``.

    With ``jblk`` 1 that is K1's walk: the bound is looked at before every
    cluster. K5 (``jblk`` > 1) looks once per round, so a ray may test
    clusters that a fresher bound would have skipped; their candidates
    lose the (t, code) merge, so the results are K1's, and ``stats``
    counts the extra tests. K2pl (``pipelined``) fetches each round on a
    vote taken one round early and tests it by the bound as it stands at
    the round's turn: the tests are K1's, and ``stats`` counts the rounds
    fetched (``staged_rounds``) and marks their clusters as read. Those
    extra tests and fetches are what the two kernels spend, not what
    their function needs: K5 and K2pl return K1's results from K1's
    inputs, so the least work is what the ``jblk`` 1, not pipelined walk
    counts on the same rays, and a bound is taken from that.

    ``cap`` > 0 (K1 only) walks the first ``cap`` entries of each tile's
    order and no more (:func:`_tile_stop` says where that leaves a ray)."""
    dev = o.device
    n_cols = snear.shape[1]
    if cap:
        n_cols = min(n_cols, cap)
    tile_of = torch.arange(o.shape[0], device=dev) // tile
    live = torch.arange(o.shape[0], device=dev)
    for j in range(0, n_cols, jblk):
        nb = min(jblk, n_cols - j)
        if stats is not None:
            _count(stats, "table_steps",
                   nb * torch.unique(tile_of[live]).numel())
        rb = bound(live)
        if pipelined and stats is not None:
            # this round was fetched by the tiles that voted for it one
            # round ago; the vote for the next round is taken now
            for jv in ((0, nb) if j == 0 else (nb,)):
                if j + jv >= n_cols:
                    continue
                tiles = torch.unique(
                    tile_of[live[~(snear[tile_of[live], j + jv] >= rb)]])
                _count(stats, "staged_rounds", tiles.numel())
                stats["clusters_tested"][
                    order[tiles, j + jv : j + jv + jblk].long()] = True
        keep = ~(snear[tile_of[live], j] >= rb)
        live, rb = live[keep], rb[keep]
        if live.numel() == 0:
            break
        rays = live
        for k in range(j, j + nb):
            if k > j:
                keep = ~(snear[tile_of[rays], k] >= rb)
                rays, rb = rays[keep], rb[keep]
                if rays.numel() == 0:
                    break
            cid = order[tile_of[rays], k].long()
            near, far = _slab(box[cid], o[rays], inv_d[rays])
            if stats is not None:
                _count(stats, "box_tests", rays.numel())
                stats["boxes_read"][cid] = True
            consider = (near < far) & (far > 0.0) & (near < rb)
            test(rays[consider], cid[consider])
            if pending is not None and k + 1 < j + nb:
                keep = pending(rays)
                rays, rb = rays[keep], rb[keep]
        if pending is not None:
            live = live[pending(live)]


def _tile_stop(snear, cap: int, tile: int) -> torch.Tensor:
    """Where a walk capped at ``cap`` entries left each ray → (R,) int32:
    the bits of the first entry distance its tile did not walk (-0 made
    +0), or STOP_DRAINED when the order was walked to its end or the next
    entry is the F32_MAX sentinel. The order is ascending, so every box
    the tile has not walked is entered, by every ray, no nearer than
    that: a ray whose best t is not above it (as int32 bits, ``bits(t) >
    stop``) is finished, and the others go on with it as ``t_start``."""
    n_tiles, n_cols = snear.shape
    stop = torch.full((n_tiles,), STOP_DRAINED, dtype=torch.int32,
                      device=snear.device)
    if 0 < cap < n_cols:
        nxt = snear[:, cap] + 0.0
        stop = torch.where(nxt < _INF, nxt.view(torch.int32), stop)
    return stop.repeat_interleave(tile)


def _check_hooks(any_hit=False, group=0, jblk=0, pipelined=False,
                 near=False, start_code=None, cap=0, return_stop=False):
    """The drain hooks each kernel takes; anything else raises."""
    if (cap or return_stop) and (any_hit or group or jblk or pipelined
                                 or near):
        raise ValueError(
            "only K1's closest-hit entry takes cap and return_stop"
        )
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if start_code is not None and (any_hit or group or jblk):
        raise ValueError(
            "start_code is for the single-level closest-hit entries of K1, "
            "K2pl and K2n"
        )


def _start_codes(t_max, start_code, stats=None, more_words: int = 0):
    """The codes a search starts from; counts the 4-byte words per ray
    that the hooks add to a kernel's inputs and outputs (``start_code``,
    and ``more_words``: a stop written, a ``t_start`` read)."""
    words = more_words + (start_code is not None)
    if words:
        _count(stats, "hook_words", words * t_max.shape[0])
    if start_code is not None:
        return start_code.clone()
    return torch.full(t_max.shape, -1, dtype=torch.int32,
                      device=t_max.device)


def _walk_torch(
    o, d, inv_d, t_max, excl, snear, order, box, face_id, tri, tile,
    any_hit: bool, jblk: int = 1, pipelined: bool = False,
    start_code: Optional[torch.Tensor] = None, cap: int = 0,
    return_stop: bool = False, coop: bool = True,
    chunk: Optional[int] = None, stats: Optional[dict] = None,
):
    """Plain-torch twin of K1 (both entries), of K5 (``jblk``), of K2pl
    (``pipelined``) and of K2n's walk: :func:`_walk` with the best t
    (any-hit: t_max, until the ray has a hit) as its bound and the exact
    slot test, in chunks of ``chunk`` rays (default 2**18 on a GPU, 2**15
    elsewhere). Returns (best t, code); any-hit leaves best t at t_max.
    ``stats`` (a dict) accumulates the work this walk does (see
    :func:`walk_stats`). ``coop``: the kernels' warps share their slot
    scans, as every one of these kernels does; False counts the scans of
    one thread each instead. Only ``stats`` differ.

    The drain hooks (closest-hit): the search starts from (t_max,
    ``start_code``), the best an earlier pass carried in, instead of
    (t_max, -1), so a hit at the carried t with a lower code wins as it
    would in one walk; ``cap`` ends the walk after that many entries
    (K1), and ``return_stop`` adds :func:`_tile_stop` to the result."""
    _check_hooks(any_hit, 0, jblk if jblk > 1 else 0, pipelined, False,
                 start_code, cap, return_stop)
    chunk = _walk_setup(o, face_id, chunk, stats)
    best = t_max.clone()
    best_code = _start_codes(t_max, start_code, stats, int(return_stop))

    def test(rays, cids):
        _test_clusters(rays, cids, o, d, excl, face_id, tri, best, best_code,
                       any_hit, chunk, stats, coop)

    _walk(o, inv_d, snear, order, box, tile, lambda r: best[r], test,
          (lambda r: best_code[r] < 0) if any_hit else None, stats, jblk,
          pipelined, cap)
    if return_stop:
        return best, best_code, _tile_stop(snear, cap, tile)
    return best, best_code


def _binned_pass_torch(
    o, d, inv_d, t_max, excl, sched, box, face_id, tri, tile,
    start_code: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None, stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K4, in the kernel's order: every ray of block
    b takes cluster ``sched[b, 0]``, then ``sched[b, 1]`` on top of the
    best it carries (-1: skipped). A cluster is tested when the ray's own
    slab test admits it, K1's gate (``near < far``, ``far > 0``, ``near <
    best t``), with K1's exact slot test and (t, code) merge. There is no
    order and no stop rule. Returns (best t, code), starting from (t_max,
    ``start_code`` or -1); lanes with t_max 0 stay as they start.

    The JAX kernel tests all slots of a scheduled cluster with no box
    test, as its drain kernels do. Here the drain (K1) tests a cluster
    only through this gate, so K4 must too: otherwise a triangle on the
    knife edge of its cluster's box would be found by K4 and not by K1."""
    chunk = _walk_setup(o, face_id, chunk, stats)
    best = t_max.clone()
    best_code = _start_codes(t_max, start_code, stats)
    block_of = torch.arange(o.shape[0], device=o.device) // tile
    # a block reads its two schedule entries: 8 bytes, as a table step
    _count(stats, "table_steps", sched.shape[0])
    for j in range(2):
        cid_r = sched[block_of, j].long()
        rays = torch.nonzero(cid_r >= 0).flatten()
        cid = cid_r[rays]
        near, far = _slab(box[cid], o[rays], inv_d[rays])
        if stats is not None:
            _count(stats, "box_tests", rays.numel())
            stats["boxes_read"][cid] = True
        consider = (near < far) & (far > 0.0) & (near < best[rays])
        _test_clusters(rays[consider], cid[consider], o, d, excl, face_id,
                       tri, best, best_code, False, chunk, stats)
    return best, best_code


def key_masks(c: int):
    """(kmask, miss_th) of the ray sort's packed keys over ``c`` boxes: the
    low mantissa bits that hold the box id, and the truncated F32_MAX at or
    above which a key's distance means "no box"."""
    kmask = (1 << max(1, (c - 1).bit_length())) - 1
    return kmask, _F32_MAX_BITS & ~kmask


def _top_keys_torch(o, inv_d, t_max, boxes, n: int, t_start=None,
                    chunk: int = 65536):
    """Plain-torch twin of the key kernel (the body of ``ray_sort._top_keys``;
    JAX ``nearest_cluster_key`` and ``nearest_cluster_keys2``): the ``n``
    smallest packed ``(near | box id)`` keys of every ray → n tensors (R,)
    int32. The entry distance of each box the ray's slab test admits (near
    < far, near < t_max, far > 0; clamped at 0, -0 made +0; F32_MAX
    otherwise, and below the ray's ``t_start`` when given) and the box id
    share one int32, the id in the low mantissa bits (:func:`key_masks`),
    so each pick is one masked minimum and near ties within the truncation
    break toward the lower id. ``chunk`` rays at a time keep the (chunk, C)
    temporaries small."""
    r = o.shape[0]
    c = boxes.shape[0]
    dev = o.device
    kmask, _ = key_masks(c)
    iota = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    keys = [torch.empty((r,), dtype=torch.int32, device=dev)
            for _ in range(n)]
    for r0 in range(0, r, chunk):
        sl = slice(r0, r0 + chunk)
        tc = t_max[sl]
        near, far = _slab(boxes[None], o[sl][:, None], inv_d[sl][:, None])
        hit = (near < far) & (near < tc[:, None]) & (far > 0.0)
        nears = torch.where(
            hit, torch.clamp(near, min=0.0) + 0.0, torch.full_like(near, _INF)
        )
        if t_start is not None:
            nears = torch.where(nears >= t_start[sl][:, None], nears,
                                torch.full_like(nears, _INF))
        pk = (nears.view(torch.int32) & ~kmask) | iota
        for j in range(n):
            k = torch.amin(pk, dim=1)
            keys[j][sl] = k
            if j + 1 < n:  # keys are unique by their id bits
                pk = torch.where(pk == k[:, None],
                                 torch.full_like(pk, _I32_MAX), pk)
    return tuple(keys)


def _walk_pairs_torch(
    a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile,
    pipelined: bool = False, chunk: Optional[int] = None,
    stats: Optional[dict] = None,
):
    """Plain-torch twin of K2p and, ``pipelined``, of K2pl's pairs entry:
    K1's walk (:func:`_walk`) with the pairs
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
          stats, 1, pipelined)
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
                       any_hit, chunk, stats, coop=True)

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
# a pairs slot up to its cull (the 3 terms of det, the compare) and, with
# every estimate and magnitude computed, past it (t_num, u, v: 16 terms;
# the magnitudes of all four: 19 terms, as many products and 15 adds; 4
# margins, 6 gate sums, 10 gate compares, the divide, t > 0, 4 merge
# compares): `ops_full_test` of walk_stats
PAIRS_SLOT_CULL_OPS = 6
PAIRS_SLOT_REST_OPS = 29 + 34 + 4 + 6 + 10 + 1 + 1 + 4
PAIRS_ESTIMATE_TERMS = (3, 16)  # A·B terms per slot up to / past the cull
PAIRS_MAGNITUDE_TERMS = 19  # |A|·|B| terms per slot past the cull
# What the pairs slot test needs past its cull (`_count_pairs_work`), by
# step: u (6 products, 5 adds) and its exact test (2 compares); a
# magnitude of u or v (6 products, 5 adds, the margin); a margined u gate
# (det + m_u, 2 compares); v and v >= 0; a margined v gate; u + v and its
# exact test; a margined u + v gate (2 adds, a compare); t_num (4
# products, 3 adds), the divide and t > 0; the two merge tests of a valid
# slot (4 compares); a robust test (m_d: 3 products, 2 adds, the margin;
# m_t: 4, 3, 1; its gates: 3 sums and 6 compares)
PAIRS_STEP_OPS = dict(
    slot_tests_past_cull=13, pairs_magnitudes_u=12, pairs_magnitudes_v=12,
    pairs_margined_u=3, pairs_u_pass=12, pairs_margined_v=1,
    pairs_v_pass=2, pairs_margined_uv=3, pairs_gate_pass=9, pairs_valid=4,
    pairs_robust_tests=23,
)


def walk_stats(stats: dict, face_id: torch.Tensor, any_hit: bool,
               pairs: bool = False, kernel: bool = False) -> dict:
    """The work a twin's walk counted in ``stats``, as f32 operations and
    the least bytes the kernel must move: each ray's inputs read once and
    its outputs written once (o, d, inv_d, t_max, excl → t, code; pairs:
    A, inv_d, t_max, excl → t1, three codes, the flag), the table entries
    (tile distance and order) the tiles stepped through, each box read,
    and the face ids of each cluster tested with, per occupied slot, the
    triangle row (pairs: the 19 B entries of its columns); the drain hooks
    add a word per ray each (the carried code, the stop, K2n's
    ``t_start``), and K4 reads its block schedules as table steps. A K2n twin
    adds the tile entry distances' slab tests (``near_box_tests``, every
    ray against every box) and reads every box but no table entry; a twin
    of K3 with its own super order the same over the super boxes. The
    counts of a K5 or K2pl twin include the speculative tests and fetches
    (see :func:`_walk`): they say what the kernel did, and the bound of
    its function is the K1 (K2p) twin's counts on the same rays.

    The slot tests are those of the sequential scan, which the function
    needs; ``kernel`` counts those of the kernel instead, where its warps
    share any-hit scans (``kernel_slot_tests``: past the first valid
    slot). A pairs slot past its cull counts what its gates need
    (:func:`_count_pairs_work`, ``PAIRS_STEP_OPS``); ``ops_full_test``
    counts every estimate and magnitude of every such slot
    (``PAIRS_SLOT_REST_OPS``)."""
    tested = stats["clusters_tested"]
    n_faces = int((face_id[tested] >= 0).sum())
    pre = "kernel_" if kernel and "kernel_slot_tests" in stats else ""
    slot_tests = stats.get(pre + "slot_tests", 0)
    past_cull = stats.get(pre + "slot_tests_past_cull", 0)
    full_ops = None
    if pairs:
        slot_ops = PAIRS_SLOT_CULL_OPS * slot_tests + sum(
            n * stats.get(k, 0) for k, n in PAIRS_STEP_OPS.items())
        full_ops = (PAIRS_SLOT_CULL_OPS * slot_tests
                    + PAIRS_SLOT_REST_OPS * past_cull)
        ray_bytes, face_bytes = 60 + 20, 4 * PAIRS_MAGNITUDE_TERMS
    else:
        slot_ops = SLOT_CULL_OPS * slot_tests + SLOT_REST_OPS * past_cull
        ray_bytes, face_bytes = 44 + (4 if any_hit else 8), 36
    n_bytes = (
        ray_bytes * stats["rays"]
        + 4 * stats.get("hook_words", 0)
        + 8 * stats.get("table_steps", 0)
        + 24 * (int(stats["boxes_read"].sum())
                + stats.get("super_boxes_read", 0))
        + 4 * face_id.shape[1] * int(tested.sum())
        + face_bytes * n_faces
    )
    box_tests = stats.get("box_tests", 0) + stats.get("near_box_tests", 0)
    out = dict(
        ops=BOX_TEST_OPS * box_tests + slot_ops,
        bytes=n_bytes, box_tests=box_tests,
        slot_tests=slot_tests, clusters_tested=int(tested.sum()),
        faces_tested=n_faces,
    )
    if pairs:
        # det; u; v past the u gate; t_num past every gate. |A|·|B|: u's
        # and v's where computed, det's and t_num's in the robust tests
        out["estimate_terms"] = (
            3 * slot_tests + 6 * past_cull
            + 6 * stats.get("pairs_u_pass", 0)
            + 4 * stats.get("pairs_gate_pass", 0))
        out["magnitude_terms"] = (
            6 * stats.get("pairs_magnitudes_u", 0)
            + 6 * stats.get("pairs_magnitudes_v", 0)
            + 7 * stats.get("pairs_robust_tests", 0))
        out["ops_full_test"] = BOX_TEST_OPS * box_tests + full_ops
    return out


def _near_order(o, inv_d, t_max, box, tile, stats, t_start=None):
    """K2n's first half as plain torch: each tile's entry distance into
    every box (entries below a ray's ``t_start`` left out) and the stable
    ascending order → (snear, order)."""
    snear, order = torch.sort(
        tile_nears_fused(o, inv_d, t_max, box, tile, t_start=t_start),
        dim=1, stable=True,
    )
    if stats is not None:
        _count(stats, "near_box_tests", o.shape[0] * box.shape[0])
    return snear, order.to(torch.int32)


def _near_stats(stats) -> None:
    """K2n reads every box once and no table entry."""
    if stats is not None:
        stats["boxes_read"][:] = True
        stats["table_steps"] = 0


def _trace_near_torch(o, d, inv_d, t_max, excl, box, face_id, tri, tile,
                      any_hit: bool, pipelined: bool = False, t_start=None,
                      stats=None, **kw):
    """Plain twin of K2n's closest-hit and any-hit entries → (best t,
    code): the tile entry distances (masked by ``t_start``), the stable
    sort and K1's walk (K2pl's when ``pipelined``; ``start_code`` as
    there)."""
    _check_hooks(near=True, cap=kw.get("cap", 0),
                 return_stop=kw.get("return_stop", False))
    snear, order = _near_order(o, inv_d, t_max, box, tile, stats, t_start)
    if t_start is not None:
        _count(stats, "hook_words", o.shape[0])
    out = _walk_torch(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                      tri, tile, any_hit=any_hit, pipelined=pipelined,
                      stats=stats, **kw)
    _near_stats(stats)
    return out


def _trace_near_pairs_torch(a, inv_d, t_max, excl, box, face_id, mat_b,
                            tile, pipelined: bool = False, stats=None, **kw):
    """Plain twin of K2n's pairs entry → (t1, c1, c2, c3, amb)."""
    snear, order = _near_order(a[:, 0:3], inv_d, t_max, box, tile, stats)
    out = _walk_pairs_torch(a, inv_d, t_max, excl, snear, order, box,
                            face_id, mat_b, tile, pipelined=pipelined,
                            stats=stats, **kw)
    _near_stats(stats)
    return out


def _trace_near_two_level_torch(o, d, inv_d, t_max, excl, super_box, box,
                                face_id, tri, tile, group, any_hit: bool,
                                chunk=None, stats=None):
    """Plain twin of K3's closest-hit and any-hit entries that order their
    supers themselves → (best t, code): the tile entry distances into
    every super box and the stable sort (:func:`_near_order`), then K3's
    walk. ``stats`` counts the supers' slab tests as ``near_box_tests``,
    every super box as read, and no table step."""
    snear, order = _near_order(o, inv_d, t_max, super_box, tile, stats)
    out = _walk_two_level_torch(o, d, inv_d, t_max, excl, snear, order, box,
                                face_id, tri, tile, group, any_hit, chunk,
                                stats)
    _near_two_level_stats(stats, super_box)
    return out


def _trace_near_pairs_two_level_torch(a, inv_d, t_max, excl, super_box, box,
                                      face_id, mat_b, tile, group,
                                      chunk=None, stats=None):
    """Plain twin of K3p ordering its supers itself → (t1, c1, c2, c3,
    amb)."""
    snear, order = _near_order(a[:, 0:3], inv_d, t_max, super_box, tile,
                               stats)
    out = _walk_pairs_two_level_torch(a, inv_d, t_max, excl, snear, order,
                                      box, face_id, mat_b, tile, group, chunk,
                                      stats)
    _near_two_level_stats(stats, super_box)
    return out


def _near_two_level_stats(stats, super_box) -> None:
    """K3 with its own super order reads every super box once and no table
    entry."""
    if stats is not None:
        stats["super_boxes_read"] = super_box.shape[0]
        stats["table_steps"] = 0


# K5's rounds (JAX ``sched_rounds``); the dynamic shared memory a block may
# ask for on sm_90 (232,448 bytes less 1 KB kept for the kernels' static
# variables); the most boxes a block orders itself (K2n: clusters; K3 with
# its own super order: supers) and the most rays of such a block and of
# every K3 one (the ray stage); the boxes a thread of the first half holds
# at a time, clusters and supers (csrc/cluster_trace.cu kMaxNearClusters,
# kMaxTile, kNearRows, kSuperRows). NEAR_MAX_TILE bounds every walk's tile
# but K4's.
SCHED_ROUNDS = TRACE_SCHED_VALUES[1:]
SHARED_LIMIT = 232448 - 1024
NEAR_MAX_CLUSTERS = 4096
NEAR_MAX_TILE = 128
NEAR_BOX_ROWS = 4
NEAR_SUPER_ROWS = 2
# the 16-byte words a ray that the pairs search of the walks with shared
# slot scans keeps in shared memory (csrc/cluster_trace.cu Pairs::kRayVecs)
PAIRS_STAGE_VECS = 6
# the wanting lanes of a warp from which a cluster's any-hit slot scan is
# not shared (csrc/cluster_trace.cu kCoopSerial); the twins count the shared
# scans' tests with it
COOP_SERIAL = 24


def near_order_bytes(n_boxes: int, tile: int, rays: bool,
                     coop_vecs: int = 0) -> int:
    """Dynamic shared memory of the kernels' first half: 8 bytes a key for
    the next power of two of the box count (at least 64), K2n's ray stage
    (32 bytes a ray; K3 keeps its own statically) and the box stage, which
    the walk's search then takes for its rays (``coop_vecs`` 16-byte words
    a ray: PAIRS_STAGE_VECS for pairs)."""
    keys = max(64, 1 << max(0, n_boxes - 1).bit_length())
    rows = NEAR_BOX_ROWS if rays else NEAR_SUPER_ROWS
    return (8 * keys + (32 * tile if rays else 0)
            + max(24 * rows, 16 * coop_vecs) * tile)


def staged_bytes(slots: int, row_words: int, jblk: int,
                 pipelined: bool) -> int:
    """Shared memory of a staged walk (K5, K2pl): per cluster of a round
    the face ids and ``row_words`` words per slot (9: a triangle row; 19:
    the pairs terms), two buffers when ``pipelined``."""
    return (2 if pipelined else 1) * jblk * slots * (1 + row_words) * 4


def _check_walk(r, inv_d, t_max, excl, snear, order, box, face_id, tile,
                group, row_words, jblk=0, pipelined=False, super_box=None):
    """Shapes every walk takes, and the shared memory the staged and
    in-kernel-order walks need → (n_tiles, n_cols). ``snear`` None: the
    block orders its boxes itself, the clusters (K2n) or, with ``group``,
    the supers of ``super_box`` (K3)."""
    near = snear is None
    if not near:
        n_tiles, n_cols = snear.shape
    else:
        n_tiles = r // tile
        n_cols = (super_box if group else box).shape[0]
    if (
        r != n_tiles * tile or inv_d.shape != (r, 3) or t_max.shape != (r,)
        or excl.shape != (r,) or (not near and order.shape != snear.shape)
        or box.shape != (face_id.shape[0], 6) or not 0 < tile <= 1024
        or (near and group and super_box.shape != (n_cols, 6))
    ):
        raise ValueError("cluster trace kernel: inconsistent shapes")
    if group and (
        box.shape[0] != n_cols * group or group > min(tile, 128)
    ):
        raise ValueError(
            f"two-level trace kernel: {box.shape[0]} clusters are not "
            f"{n_cols} supers of {group}, or G = {group} exceeds "
            f"min(tile, 128)"
        )
    if tile % 32 or tile > NEAR_MAX_TILE:
        raise ValueError(
            "the warps of every walk go in step over the order, and a block "
            f"holds at most {NEAR_MAX_TILE} rays: the tile must be a "
            f"multiple of 32 up to {NEAR_MAX_TILE}, got {tile}"
        )
    if group and (jblk or pipelined):
        raise ValueError(
            "the two-level kernels have no rounds of several clusters and "
            "no pipelined form"
        )
    if jblk and (jblk not in SCHED_ROUNDS or near or pipelined):
        raise ValueError(
            f"K5 runs rounds of {SCHED_ROUNDS} clusters over an order "
            f"sorted outside, not pipelined; got jblk = {jblk}"
        )
    shared = 0
    if near:
        if n_cols > NEAR_MAX_CLUSTERS:
            raise ValueError(
                f"a block orders at most {NEAR_MAX_CLUSTERS} boxes itself "
                f"(K2n: clusters; K3: supers); got {n_cols}"
            )
        shared = near_order_bytes(
            n_cols, tile, rays=not group,
            coop_vecs=PAIRS_STAGE_VECS if row_words == 19 else 0)
    elif row_words == 19 and not group:  # K2p, K2pl: the rays' stage
        shared = 16 * PAIRS_STAGE_VECS * tile
    if jblk or pipelined:
        shared += staged_bytes(face_id.shape[1], row_words, max(jblk, 1),
                               pipelined)
    if shared > SHARED_LIMIT:
        raise ValueError(
            f"cluster trace kernel: {shared} bytes of shared memory exceed "
            f"the block's {SHARED_LIMIT}"
        )
    return n_tiles, n_cols


def _run(entry, dev, args) -> None:
    """Launch the trace kernel's ``entry`` with ``args``
    (:func:`._build.launch`). Every launch of a trace kernel is this span,
    ``wrt.trace.kernel``; the key kernel launches outside it."""
    with span("wrt.trace.kernel"):
        launch("cluster trace", entry, dev, *args)


def _entry(kind, snear, group, jblk, pipelined):
    """Which entry of the library these arguments select → (its name
    after ``wrt_trace_``, the arguments it takes after the tables)."""
    if snear is None and group:
        return f"near_{kind}_two_level", (group,)
    if snear is None:
        return f"near_{kind}", (int(pipelined),)
    if group:
        return f"{kind}_two_level", (group,)
    if jblk:
        return "sched", (jblk,)
    return (f"pipelined_{kind}" if pipelined else kind), ()


def _order_args(snear, order, n_cols, super_box=None):
    """The order a kernel walks: sorted outside, or only the number of
    boxes (K2n: the clusters; K3: the supers and their boxes)."""
    if snear is not None:
        return (snear.data_ptr(), order.data_ptr(), n_cols)
    if super_box is not None:
        return (n_cols, super_box.data_ptr())
    return (n_cols,)


def _ptr(x) -> Optional[int]:
    """A tensor's address, or None (a null pointer) for no tensor."""
    return None if x is None else x.data_ptr()


def _check_super_box(super_box, near, group) -> None:
    if (super_box is not None) != bool(near and group):
        raise ValueError(
            "super_box goes with a two-level walk that orders its supers "
            "itself, and only with that"
        )


def _launch_kernel(o, d, inv_d, t_max, excl, snear, order, box, face_id,
                   tri, tile, any_hit: bool = False, group: int = 0,
                   jblk: int = 0, pipelined: bool = False, t_start=None,
                   start_code=None, cap: int = 0,
                   return_stop: bool = False, super_box=None):
    """Check the arguments and launch an exact-search entry, closest-hit
    (→ (t, code)) or any-hit (→ code): K1; K3 (``group`` = G); K5
    (``jblk`` clusters a round, closest-hit only); K2pl (``pipelined``);
    K2n (``snear`` and ``order`` None, with or without ``pipelined``); K3
    ordering its supers itself (``snear`` and ``order`` None, ``group``
    and ``super_box``).
    The drain hooks as :func:`_walk_torch` and :func:`_trace_near_torch`
    take them: ``start_code`` (closest-hit K1, K2pl, K2n), ``cap`` and
    ``return_stop`` (closest-hit K1 → (t, code, stop)), ``t_start``
    (K2n; for the others the order they are given is already masked)."""
    near = snear is None
    _check_hooks(any_hit, group, jblk, pipelined, near, start_code, cap,
                 return_stop)
    if t_start is not None and not near:
        raise ValueError(
            "t_start masks the tile entry distances: outside the kernel "
            "for an order sorted outside (prepare_tiles), inside for K2n"
        )
    _check_super_box(super_box, near, group)
    dev, r = o.device, o.shape[0]
    f32, i32 = torch.float32, torch.int32
    check_args("cluster trace", dev, [
        ("o", o, f32, (r, 3)), ("d", d, f32, (r, 3)),
        ("inv_d", inv_d, f32, None), ("t_max", t_max, f32, None),
        ("excl", excl, i32, None), ("snear", snear, f32, None),
        ("order", order, i32, None), ("super_box", super_box, f32, None),
        ("box", box, f32, None), ("face_id", face_id, i32, None),
        ("tri", tri, f32, (len(tri), 9)), ("t_start", t_start, f32, (r,)),
        ("start_code", start_code, i32, (r,)),
    ])
    if jblk and any_hit:
        raise ValueError("K5 has a closest-hit entry only")
    n_tiles, n_cols = _check_walk(r, inv_d, t_max, excl, snear, order, box,
                                  face_id, tile, group, 9, jblk, pipelined,
                                  super_box)
    code_out = torch.empty((r,), dtype=torch.int32, device=dev)
    t_out = None if any_hit else torch.empty(
        (r,), dtype=torch.float32, device=dev
    )
    name, tail = _entry("any" if any_hit else "closest", snear, group, jblk,
                        pipelined)
    stop_out = torch.empty((r,), dtype=torch.int32, device=dev) if (
        return_stop) else None
    # the hooks each entry takes, after its own arguments
    if name == "closest":
        tail += (_ptr(start_code), cap, _ptr(stop_out))
    elif name == "pipelined_closest":
        tail += (_ptr(start_code),)
    elif name == "near_closest":
        tail += (_ptr(t_start), _ptr(start_code))
    elif name == "near_any":
        tail += (_ptr(t_start),)
    head = (
        o.data_ptr(), d.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(),
        excl.data_ptr(), *_order_args(snear, order, n_cols, super_box),
        box.data_ptr(), face_id.data_ptr(), face_id.shape[1],
        tri.data_ptr(), EPS2, *tail,
    )
    outs = (code_out.data_ptr(),) if any_hit else (
        t_out.data_ptr(), code_out.data_ptr()
    )
    _run("wrt_trace_" + name, dev, head + outs + (n_tiles, tile))
    if return_stop:
        return t_out, code_out, stop_out
    return code_out if any_hit else (t_out, code_out)


def _launch_binned(o, d, inv_d, t_max, excl, sched, box, face_id, tri, tile,
                   start_code=None):
    """Check the arguments and launch K4 → (t, code)."""
    dev, r = o.device, o.shape[0]
    if not 0 < tile <= 1024 or r % tile:
        raise ValueError(
            f"binned pass kernel: {r} rays are not whole tiles of {tile}")
    f32, i32 = torch.float32, torch.int32
    check_args("cluster trace", dev, [
        ("o", o, f32, (r, 3)), ("d", d, f32, (r, 3)),
        ("inv_d", inv_d, f32, (r, 3)), ("t_max", t_max, f32, (r,)),
        ("excl", excl, i32, (r,)), ("sched", sched, i32, (r // tile, 2)),
        ("box", box, f32, (len(face_id), 6)), ("face_id", face_id, i32, None),
        ("tri", tri, f32, (len(tri), 9)),
        ("start_code", start_code, i32, (r,)),
    ])
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    code_out = torch.empty((r,), dtype=torch.int32, device=dev)
    _run("wrt_trace_binned", dev, (
        o.data_ptr(), d.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(),
        excl.data_ptr(), sched.data_ptr(), box.data_ptr(),
        face_id.data_ptr(), face_id.shape[1], tri.data_ptr(), EPS2,
        _ptr(start_code), t_out.data_ptr(), code_out.data_ptr(),
        r // tile, tile,
    ))
    return t_out, code_out


def _launch_top_keys(o, inv_d, t_max, boxes, n: int, t_start=None,
                     chunk=None):
    """Check the arguments and launch the key kernel → n tensors (R,) int32
    (``chunk``, the twin's memory knob, is not read)."""
    dev, r, c = o.device, o.shape[0], len(boxes)
    f32 = torch.float32
    check_args("cluster trace", dev, [
        ("o", o, f32, (r, 3)), ("inv_d", inv_d, f32, (r, 3)),
        ("t_max", t_max, f32, (r,)), ("boxes", boxes, f32, (c, 6)),
        ("t_start", t_start, f32, (r,)),
    ])
    if n not in (2, 3) or c < 1:
        raise ValueError(f"top keys kernel: n = {n} is not 2 or 3, or no "
                         f"box ({c})")
    keys = torch.empty((n, r), dtype=torch.int32, device=dev)
    launch("cluster trace", "wrt_top_keys", dev, *(
        o.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(), _ptr(t_start),
        boxes.data_ptr(), c, key_masks(c)[0], n, keys.data_ptr(), r,
    ))
    return keys.unbind(0)


def _launch_pairs(a, inv_d, t_max, excl, snear, order, box, face_id, mat_b,
                  tile, group: int = 0, pipelined: bool = False,
                  super_box=None):
    """Check the arguments and launch a pairs entry → (t1, c1, c2, c3,
    amb): K2p; K3p (``group`` = G); K2pl (``pipelined``); K2n (``snear``
    and ``order`` None, with or without ``pipelined``); K3p ordering its
    supers itself (``snear`` and ``order`` None, ``group``, ``super_box``)."""
    _check_super_box(super_box, snear is None, group)
    dev, r = a.device, a.shape[0]
    c, s = face_id.shape
    f32, i32 = torch.float32, torch.int32
    check_args("cluster trace", dev, [
        ("a", a, f32, (r, 10)), ("inv_d", inv_d, f32, None),
        ("t_max", t_max, f32, None), ("excl", excl, i32, None),
        ("snear", snear, f32, None), ("order", order, i32, None),
        ("super_box", super_box, f32, None), ("box", box, f32, None),
        ("face_id", face_id, i32, None),
        ("mat_b", mat_b, f32, (c, 10, 4 * s)),
    ])
    n_tiles, n_cols = _check_walk(r, inv_d, t_max, excl, snear, order, box,
                                  face_id, tile, group, 19, 0, pipelined,
                                  super_box)
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    codes = [torch.empty((r,), dtype=torch.int32, device=dev)
             for _ in range(4)]  # c1, c2, c3, amb
    name, tail = _entry("pairs", snear, group, 0, pipelined)
    head = (
        a.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(), excl.data_ptr(),
        *_order_args(snear, order, n_cols, super_box), box.data_ptr(),
        face_id.data_ptr(), s, mat_b.data_ptr(), EPS2, MARGIN, *tail,
    )
    outs = (t_out.data_ptr(),) + tuple(x.data_ptr() for x in codes)
    _run("wrt_trace_" + name, dev, head + outs + (n_tiles, tile))
    return (t_out, *codes)


def _launch_near(o, d, inv_d, t_max, excl, box, face_id, tri, tile, **kw):
    return _launch_kernel(o, d, inv_d, t_max, excl, None, None, box,
                          face_id, tri, tile, **kw)


def _launch_near_pairs(a, inv_d, t_max, excl, box, face_id, mat_b, tile,
                       **kw):
    return _launch_pairs(a, inv_d, t_max, excl, None, None, box, face_id,
                         mat_b, tile, **kw)


def _launch_near_two_level(o, d, inv_d, t_max, excl, super_box, box,
                           face_id, tri, tile, group, **kw):
    return _launch_kernel(o, d, inv_d, t_max, excl, None, None, box,
                          face_id, tri, tile, group=group,
                          super_box=super_box, **kw)


def _launch_near_pairs_two_level(a, inv_d, t_max, excl, super_box, box,
                                 face_id, mat_b, tile, group):
    return _launch_pairs(a, inv_d, t_max, excl, None, None, box, face_id,
                         mat_b, tile, group=group, super_box=super_box)


def _wrapper(name, twin, launch, doc, **fixed):
    """A trace kernel's routed :class:`._build.Kernel`. It takes the
    arguments of ``launch`` and of ``twin`` (the same names, so a
    :func:`prepare_tiles` dict fits both) less the keywords ``fixed``,
    which say what the entry is (``any_hit``, ``pipelined``); an any-hit
    twin returns the codes alone."""
    def plain(*args, **kw):
        out = twin(*args, **fixed, **kw)
        return out[1] if fixed.get("any_hit") else out

    return Kernel(name, plain, functools.partial(launch, **fixed),
                  "cluster trace", doc, routed=True)


_RAYS = "(o, d, inv_d, t_max, excl"
_PAIRS_OUT = (
    "(t1, c1, c2, c3, amb): the two nearest margin-valid candidates (t1 is "
    "the first one's estimated t, or t_max), the nearest robust one and the "
    "ambiguity flag (:func:`_walk_pairs_torch`)."
)
trace_closest_tiles = _wrapper(
    "trace_closest_tiles", _walk_torch, _launch_kernel,
    f"K1 {_RAYS}, snear, order, box, face_id, tri, tile): per-ray closest "
    "hit over each tile's sorted cluster order → (best t, code).",
    any_hit=False)
trace_any_tiles = _wrapper(
    "trace_any_tiles", _walk_torch, _launch_kernel,
    f"K1 {_RAYS}, snear, order, box, face_id, tri, tile): per-ray any-hit "
    "over each tile's sorted cluster order → code of the first valid hit "
    "with t < t_max in walk order, or -1.", any_hit=True)
trace_pairs_tiles = _wrapper(
    "trace_pairs_tiles", _walk_pairs_torch, _launch_pairs,
    "K2p (a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile): "
    "the exact-pairs trace over each tile's sorted cluster order → "
    + _PAIRS_OUT)
trace_closest_two_level_tiles = _wrapper(
    "trace_closest_two_level_tiles", _walk_two_level_torch, _launch_kernel,
    f"K3 {_RAYS}, snear, order, box, face_id, tri, tile, group): per-ray "
    "closest hit over each tile's sorted SUPER order, the G children of "
    "each super culled and ordered in the kernel → (best t, code).",
    any_hit=False)
trace_any_two_level_tiles = _wrapper(
    "trace_any_two_level_tiles", _walk_two_level_torch, _launch_kernel,
    f"K3 {_RAYS}, snear, order, box, face_id, tri, tile, group): per-ray "
    "any-hit over each tile's sorted super order → code of the first valid "
    "hit with t < t_max in walk order, or -1.", any_hit=True)
trace_pairs_two_level_tiles = _wrapper(
    "trace_pairs_two_level_tiles", _walk_pairs_two_level_torch,
    _launch_pairs,
    "K3p (a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, tile, "
    "group): the exact-pairs trace over each tile's sorted super order → "
    "(t1, c1, c2, c3, amb), as K2p.")
trace_sched_tiles = _wrapper(
    "trace_sched_tiles", _walk_torch, _launch_kernel,
    f"K5 {_RAYS}, snear, order, box, face_id, tri, tile, jblk): K1's "
    "closest hit over the same sorted order, run in rounds of ``jblk`` "
    "clusters (1, 2, 4 or 8) staged in shared memory, the bound looked at "
    "once per round → (best t, code), equal to K1's.", any_hit=False)
trace_pipelined_closest_tiles = _wrapper(
    "trace_pipelined_closest_tiles", _walk_torch, _launch_kernel,
    f"K2pl {_RAYS}, snear, order, box, face_id, tri, tile): K1's closest "
    "hit with the next cluster fetched into shared memory while the "
    "current one is tested, each round voted one round ahead → (best t, "
    "code), equal to K1's.", any_hit=False, pipelined=True)
trace_pipelined_any_tiles = _wrapper(
    "trace_pipelined_any_tiles", _walk_torch, _launch_kernel,
    f"K2pl {_RAYS}, snear, order, box, face_id, tri, tile), any-hit → code "
    "of the first valid hit with t < t_max in walk order, or -1, equal to "
    "K1's.", any_hit=True, pipelined=True)
trace_pipelined_pairs_tiles = _wrapper(
    "trace_pipelined_pairs_tiles", _walk_pairs_torch, _launch_pairs,
    "K2pl (a, inv_d, t_max, excl, snear, order, box, face_id, mat_b, "
    "tile), pairs → (t1, c1, c2, c3, amb), equal to K2p's.", pipelined=True)
trace_near_closest_tiles = _wrapper(
    "trace_near_closest_tiles", _trace_near_torch, _launch_near,
    f"K2n {_RAYS}, box, face_id, tri, tile, pipelined=False): the tile's "
    "entry distance into every cluster box and the order they give, "
    "computed inside the kernel, then K1's walk (K2pl's when "
    "``pipelined``) → (best t, code), equal to K1's after "
    ":func:`.cluster_trace.tile_nears_fused` and the stable sort. At most "
    "NEAR_MAX_CLUSTERS boxes.", any_hit=False)
trace_near_any_tiles = _wrapper(
    "trace_near_any_tiles", _trace_near_torch, _launch_near,
    f"K2n {_RAYS}, box, face_id, tri, tile, pipelined=False), any-hit → "
    "code of the first valid hit with t < t_max in walk order, or -1; the "
    "order is exactly the stable sort's, so the codes are K1's.",
    any_hit=True)
trace_near_pairs_tiles = _wrapper(
    "trace_near_pairs_tiles", _trace_near_pairs_torch, _launch_near_pairs,
    "K2n (a, inv_d, t_max, excl, box, face_id, mat_b, tile, "
    "pipelined=False), pairs → (t1, c1, c2, c3, amb), equal to K2p's.")
trace_near_closest_two_level_tiles = _wrapper(
    "trace_near_closest_two_level_tiles", _trace_near_two_level_torch,
    _launch_near_two_level,
    f"K3 {_RAYS}, super_box, box, face_id, tri, tile, group): the tile's "
    "entry distance into every SUPER box and the order they give, computed "
    "inside the kernel, then K3's walk → (best t, code), equal to K3's "
    "after :func:`.cluster_trace.tile_nears_fused` over the supers and the "
    "stable sort. At most NEAR_MAX_CLUSTERS supers.", any_hit=False)
trace_near_any_two_level_tiles = _wrapper(
    "trace_near_any_two_level_tiles", _trace_near_two_level_torch,
    _launch_near_two_level,
    f"K3 {_RAYS}, super_box, box, face_id, tri, tile, group), any-hit, the "
    "super order made in the kernel → code of the first valid hit with t < "
    "t_max in walk order, or -1; the order is exactly the stable sort's, "
    "so the codes are K3's.", any_hit=True)
trace_near_pairs_two_level_tiles = _wrapper(
    "trace_near_pairs_two_level_tiles", _trace_near_pairs_two_level_torch,
    _launch_near_pairs_two_level,
    "K3p (a, inv_d, t_max, excl, super_box, box, face_id, mat_b, tile, "
    "group), the super order made in the kernel → (t1, c1, c2, c3, amb), "
    "equal to K3p's.")
trace_binned_tiles = _wrapper(
    "trace_binned_tiles", _binned_pass_torch, _launch_binned,
    f"K4 {_RAYS}, sched, box, face_id, tri, tile, start_code=None): every "
    "ray of block b of a ray stream sorted by nearest cluster tests the "
    "clusters ``sched[b, 0]`` and ``sched[b, 1]`` (-1: none) by K1's gate "
    "and slot test → (best t, code), starting from (t_max, start_code or "
    "-1).")
# the span of the key's whole call, kernel or twin: the ray sort's, not a
# trace kernel's (the key kernel is not launched through _run)
top_keys_tiles = Kernel(
    "top_keys_tiles", _top_keys_torch, _launch_top_keys, "cluster trace",
    "The ray sort's coherence key (o, inv_d, t_max, boxes, n, t_start=None, "
    "chunk=65536): per ray the ``n`` (2 or 3) smallest packed ``(near | box "
    "id)`` keys over the boxes, misses included → n tensors (R,) int32 "
    "(:func:`_top_keys_torch`).", routed=True, span_name="wrt.trace.sort.key")

# variant of a prepare_tiles dict → its (closest-hit, any-hit, pairs)
# wrappers; K5 has a closest-hit entry only
WRAPPERS = {
    "single": (trace_closest_tiles, trace_any_tiles, trace_pairs_tiles),
    "two_level": (trace_closest_two_level_tiles, trace_any_two_level_tiles,
                  trace_pairs_two_level_tiles),
    "sched": (trace_sched_tiles, None, None),
    "pipelined": (trace_pipelined_closest_tiles, trace_pipelined_any_tiles,
                  trace_pipelined_pairs_tiles),
    "near": (trace_near_closest_tiles, trace_near_any_tiles,
             trace_near_pairs_tiles),
    "near_two_level": (trace_near_closest_two_level_tiles,
                       trace_near_any_two_level_tiles,
                       trace_near_pairs_two_level_tiles),
}


class TileArgs(dict):
    """What :func:`prepare_tiles` returns: the keyword arguments of a
    wrapper, and in ``variant`` (a key of WRAPPERS) which kernel they are
    for."""

    variant = "single"


@traced("wrt.trace.prep")
def prepare_tiles(o, d, t_max, tables, active=None, excl_code=None,
                  tile: int = 128, two_level: Optional[bool] = None,
                  pairs: bool = False, near: str = "outside",
                  sched_rounds: int = 0, pipelined: bool = False,
                  t_start=None, start_code=None, cap: int = 0,
                  return_stop: bool = False):
    """Everything a kernel takes, as plain torch: rays padded to whole
    tiles (pad lanes inactive), inactive t_max zeroed, safe reciprocal
    directions, exclusion codes (-1 = none) and each tile's box order
    (ascending tile entry distance, stable sort). The boxes are the
    superclusters when ``two_level`` (default: :func:`is_two_level` of
    the tables), and the dict then carries ``group`` = G for the
    two-level wrappers; else the clusters. With ``pairs`` the dict holds
    the ray matrix ``a`` and ``mat_b`` for the pairs wrappers in place of
    o, d and ``tri``. Returns a :class:`TileArgs`: the keyword arguments
    of the wrapper that its ``variant`` names (:func:`trace_closest_args`
    and its kin look it up).

    ``near="kernel"`` leaves the entry distances and the sort to the
    kernel: the dict has no ``snear`` and ``order``. Single-level that is
    K2n, and the dict carries ``pipelined``, K2n's choice of walk;
    two-level it is K3 ordering its supers itself (variant
    ``"near_two_level"``), and the dict carries ``super_box``.
    ``sched_rounds`` (1, 2, 4, 8) adds ``jblk`` for K5; ``pipelined`` alone
    selects K2pl. Those two are single-level only, and K5 takes neither of
    the other two; anything else raises.

    The drain hooks (single-level, not pairs; see :func:`_walk_torch`):
    ``t_start`` (R,) masks the tile entry distances here, or goes into the
    dict for K2n; ``start_code`` (R,), ``cap`` and ``return_stop`` go into
    the dict for the closest-hit wrapper (``cap`` and ``return_stop``: K1's
    only; ``start_code``: not K5's). Pad lanes get t_start 0 and code
    -1."""
    ct = tables.clusters
    if two_level is None:
        two_level = is_two_level(ct)
    elif two_level and ct.super_box is None:
        raise ValueError("two_level=True needs two-level cluster tables")
    if near not in ("outside", "kernel"):
        raise ValueError(f"near must be 'outside' or 'kernel', got {near!r}")
    in_near = near == "kernel"
    if two_level and (sched_rounds or pipelined):
        raise ValueError(
            "trace_sched and pipeline_rounds are single-level kernels; "
            "these tables are two-level"
        )
    if sched_rounds and (
        sched_rounds not in SCHED_ROUNDS or in_near or pipelined or pairs
    ):
        raise ValueError(
            f"trace_sched runs rounds of {SCHED_ROUNDS} clusters, closest-"
            "hit and not pairs, over an order sorted outside, not "
            f"pipelined; got {sched_rounds}"
        )
    hooked = (t_start is not None or start_code is not None or cap
              or return_stop)
    if hooked and (two_level or pairs):
        raise ValueError(
            "t_start, start_code, cap and return_stop are hooks of the "
            "single-level closest-hit and any-hit entries"
        )
    _check_hooks(False, 0, sched_rounds, pipelined, in_near, start_code,
                 cap, return_stop)
    near_boxes = ct.super_box if two_level else ct.box
    if in_near and near_boxes.shape[0] > NEAR_MAX_CLUSTERS:
        raise ValueError(
            f"kernel_near orders at most {NEAR_MAX_CLUSTERS} "
            f"{'superclusters' if two_level else 'clusters'} in a block; "
            f"the tables have {near_boxes.shape[0]}"
        )
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
        if t_start is not None:
            t_start = torch.cat([t_start, t_start.new_zeros((pad,))])
        if start_code is not None:
            start_code = torch.cat(
                [start_code, start_code.new_full((pad,), -1)])
    t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    inv_d = safe_inv_dir(d)
    rays = (
        dict(a=ray_matrix(o, d).contiguous()) if pairs
        else dict(o=o.contiguous(), d=d.contiguous())
    )
    args = TileArgs(
        **rays, inv_d=inv_d.contiguous(), t_max=t_max.contiguous(),
        excl=excl_code.to(torch.int32).contiguous(),
    )
    if not in_near:
        near_tc = tile_nears_fused(o, inv_d, t_max, near_boxes, tile,
                                   t_start=t_start)
        snear, order = torch.sort(near_tc, dim=1, stable=True)
        args.update(snear=snear.contiguous(),
                    order=order.to(torch.int32).contiguous())
    elif two_level:
        args["super_box"] = ct.super_box.contiguous()
    args.update(box=ct.box.contiguous(), face_id=ct.face_id.contiguous())
    if pairs:
        args["mat_b"] = ct.mat_b.contiguous()
    else:
        args["tri"] = tables.tri.contiguous()
    args["tile"] = tile
    if two_level:
        args.variant = "near_two_level" if in_near else "two_level"
        args["group"] = ct.group
    elif in_near:
        args.variant = "near"
        args["pipelined"] = bool(pipelined)
        if t_start is not None:
            args["t_start"] = t_start.contiguous()
    elif sched_rounds:
        args.variant = "sched"
        args["jblk"] = sched_rounds
    elif pipelined:
        args.variant = "pipelined"
    if start_code is not None:
        args["start_code"] = start_code.to(torch.int32).contiguous()
    if cap or return_stop:
        args.update(cap=cap, return_stop=return_stop)
    return args


def _select(args, kind: int):
    wrapper = WRAPPERS[args.variant][kind]
    if wrapper is None:
        raise ValueError(f"the {args.variant} kernel has no such entry")
    return wrapper, wrapper.twin


def trace_closest_args(args):
    """(wrapper, its plain twin) of the closest-hit entry that a
    :func:`prepare_tiles` dict is for."""
    return _select(args, 0)


def trace_any_args(args):
    """(wrapper, its plain twin) of the any-hit entry that a
    :func:`prepare_tiles` dict is for."""
    return _select(args, 1)


def trace_pairs_args(args):
    """(wrapper, its plain twin) of the pairs entry that a
    :func:`prepare_tiles` dict made with ``pairs=True`` is for."""
    return _select(args, 2)


def trace_closest_clustered_cuda(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    tables,
    active: Optional[torch.Tensor] = None,
    excl_code: Optional[torch.Tensor] = None,
    tile: int = 128,
    exact_pairs: bool = False,
    sched_rounds: int = 0,
    kernel_near: bool = False,
    pipelined: bool = False,
    raw=False,
    t_start: Optional[torch.Tensor] = None,
    start_code: Optional[torch.Tensor] = None,
    cap: int = 0,
    return_stop: bool = False,
    route: str = "auto",
):
    """Closest hit per ray → Hit(t, u, v, face), through K3 for two-level
    tables and K1 otherwise. Inactive rays return face -1 and t 0, misses
    return their t_max; the face id is the contract and t, u, v are
    re-derived exactly from it.

    ``exact_pairs`` takes the pairs route instead (JAX ``exact_pairs``):
    K3p or K2p, the three carried codes to faces, then
    :func:`.adjudicate.adjudicate_compact` against the padded,
    activity-masked t_max, as the JAX package passes it.

    The tile-scheduling kernels, routed as the JAX dispatcher routes
    them: ``kernel_near`` takes K2n (the entry distances and the order
    inside the kernel; ``prepare_tiles`` then skips both) or, on two-level
    tables, K3 / K3p ordering their supers themselves (the JAX dispatcher
    turns ``kernel_near`` off there, a limit of its VMEM residency); else
    ``sched_rounds`` > 0 takes K5, closest-hit and not pairs only (a pairs
    leg keeps K2p); ``pipelined`` takes K2pl, or K2n's pipelined walk,
    and is not read by K5. With two-level tables those two raise.

    ``raw`` returns what the sorted trace unsorts, before anything is
    re-derived: (best t, face), or with ``exact_pairs`` (t1, face1,
    face2, face3, amb); ``raw="code"`` (best t, code), which a later pass
    can carry on from.

    The hooks of the multipass and binned traces (ops/ray_sort.py; JAX
    ``t_start``, ``cap``, ``return_stop``), single-level tables and not
    ``exact_pairs`` (both raise): ``t_start`` (R,) leaves every box a ray
    enters below its own t_start out of its tile's order (an earlier pass
    ran it); ``start_code`` (R,) is the code that pass carried beside its
    best t, which comes in as ``t_max``: the search starts from that pair,
    so the result is the merged best of both passes, ties to the lower
    code as in one walk. ``cap`` > 0 ends every tile's walk after that
    many clusters; ``return_stop`` appends the per-ray stop (int32 bits,
    :func:`_tile_stop`): a ray is unfinished iff ``bits(t) > stop``. Only
    K1 can cap. With ``kernel_near``, ``sched_rounds`` or ``pipelined``
    the walk runs uncapped and the stop says so (STOP_DRAINED everywhere),
    the JAX dispatcher's rule.

    ``route`` (ROUTES) picks the kernel or its twin for every launch."""
    r0 = o.shape[0]
    hooked = t_start is not None or start_code is not None
    if (hooked or cap or return_stop) and (
        exact_pairs or is_two_level(tables.clusters)
    ):
        raise ValueError(
            "t_start, start_code, cap and return_stop need single-level "
            "tables and a leg that is not exact_pairs"
        )
    if sched_rounds and (
        sched_rounds not in SCHED_ROUNDS or is_two_level(tables.clusters)
    ):
        raise ValueError(
            f"trace_sched must be 0 or one of {SCHED_ROUNDS}, on "
            f"single-level tables; got {sched_rounds}"
        )
    jblk = 0 if (kernel_near or exact_pairs) else sched_rounds
    can_cap = not (kernel_near or jblk or pipelined)
    args = prepare_tiles(
        o, d, t_max, tables, active, excl_code, tile, pairs=exact_pairs,
        near="kernel" if kernel_near else "outside", sched_rounds=jblk,
        pipelined=pipelined and not jblk, t_start=t_start,
        start_code=start_code, cap=cap if can_cap else 0,
        return_stop=return_stop and can_cap,
    )
    fid = tables.clusters.face_id
    if exact_pairs:
        t1, c1, c2, c3, amb = trace_pairs_args(args)[0](**args, route=route)
        faces = tuple(code_to_face(c[:r0], fid) for c in (c1, c2, c3))
        if raw:
            return (t1[:r0], *faces, amb[:r0])
        return adjudicate_compact(o, d, args["t_max"][:r0], t1[:r0], faces,
                                  amb[:r0], tables)
    best_t, code, *stop = trace_closest_args(args)[0](**args, route=route)
    if return_stop:
        stop = (stop[0][:r0] if can_cap else torch.full(
            (r0,), STOP_DRAINED, dtype=torch.int32, device=o.device),)
    best_t, code = best_t[:r0], code[:r0]
    if raw == "code":
        return (best_t, code, *stop)
    face = code_to_face(code, fid)
    if raw:
        return (best_t, face, *stop)
    hit = rederive_uv(o, d, best_t, face, tables)
    return (hit, *stop) if return_stop else hit


def trace_any_clustered_cuda(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    tables,
    active: Optional[torch.Tensor] = None,
    excl_code: Optional[torch.Tensor] = None,
    tile: int = 128,
    kernel_near: bool = False,
    pipelined: bool = False,
    t_start: Optional[torch.Tensor] = None,
    route: str = "auto",
) -> torch.Tensor:
    """Shadow-ray query → (R,) bool, True where some triangle blocks the
    ray with 0 < t < t_max, through K3 for two-level tables and K1
    otherwise; ``kernel_near`` takes K2n (two-level: K3 ordering its
    supers itself) and ``pipelined`` K2pl (K5 has no any-hit entry).
    Inactive rays and NaN origins are unblocked.
    ``prepare_tiles`` (or K2n) feeds t_max into the tile distances, so
    short rays prune boxes there. ``t_start`` as in
    :func:`trace_closest_clustered_cuda` (single-level tables only), and
    ``route``."""
    r0 = o.shape[0]
    args = prepare_tiles(
        o, d, t_max, tables, active, excl_code, tile,
        near="kernel" if kernel_near else "outside", pipelined=pipelined,
        t_start=t_start,
    )
    return trace_any_args(args)[0](**args, route=route)[:r0] >= 0


def binned_args(o, d, t_max, tables, sched, excl_code=None, start_code=None,
                tile: int = 128) -> dict:
    """The keyword arguments of :func:`trace_binned_tiles` for a ray
    stream that is already sorted by nearest cluster and a whole number of
    ``tile``-ray blocks, with ``sched`` (R // tile, 2) the two cluster ids
    of each block (-1: none). Dead and pad lanes come with t_max 0.
    Single-level tables only: the ids index ``clusters.box``."""
    ct = tables.clusters
    if ct.super_box is not None:
        raise ValueError("the binned pass needs single-level tables")
    r = o.shape[0]
    if r % tile or tuple(sched.shape) != (r // tile, 2):
        raise ValueError(
            f"the binned pass takes whole blocks of {tile} rays and one "
            f"(s0, s1) pair per block; got {r} rays, sched "
            f"{tuple(sched.shape)}"
        )
    if excl_code is None:
        excl_code = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    args = dict(
        o=o.contiguous(), d=d.contiguous(),
        inv_d=safe_inv_dir(d).contiguous(), t_max=t_max.contiguous(),
        excl=excl_code.to(torch.int32).contiguous(),
        sched=sched.to(torch.int32).contiguous(), box=ct.box.contiguous(),
        face_id=ct.face_id.contiguous(), tri=tables.tri.contiguous(),
        tile=tile,
    )
    if start_code is not None:
        args["start_code"] = start_code.to(torch.int32).contiguous()
    return args


def trace_binned_pass(o, d, t_max, tables, sched, excl_code=None,
                      start_code=None, tile: int = 128, codes: bool = False,
                      route: str = "auto"):
    """One binned pass (K4; JAX ``trace_binned_pass``) over a sorted,
    padded ray stream (:func:`binned_args`) → (t, face) in the given
    order, or (t, code) with ``codes``; t is the exact best t, t_max on a
    miss. ``route`` as in ROUTES."""
    t, code = trace_binned_tiles(
        **binned_args(o, d, t_max, tables, sched, excl_code, start_code,
                      tile), route=route)
    if codes:
        return t, code
    return t, code_to_face(code, tables.clusters.face_id)
