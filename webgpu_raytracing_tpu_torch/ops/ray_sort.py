"""Ray reordering for traversal coherence, and the per-ray-scheduled
traces built on it (counterpart of ``webgpu_raytracing_tpu/ops/ray_sort.py``:
``nearest_cluster_key``, ``nearest_cluster_keys2``, ``permute_rows``,
``sorted_trace``, ``binned_trace``, ``binned_trace_any``,
``sorted_trace_multipass`` and their helpers).

Bounce and shadow rays are incoherent in pixel order: the rays of a
128-ray tile together enter many more clusters than any one of them
needs. Sorting the rays by their two nearest entered clusters groups rays
that start their walk in the same clusters, and sends dead lanes and rays
that enter no cluster to the back, where whole tiles do no rounds and,
with ``live_slice``, are not traced at all. The sort is a pure
reordering: every result is restored to the original ray order and equals
the unsorted trace bit for bit.

The binned traces (:func:`binned_trace`, :func:`binned_trace_any`;
``RenderSettings.binned_sort`` and ``binned_any_sort``) go further: rays
are sorted by their NEAREST entered cluster alone, every 128-ray block
runs the at most two distinct clusters it spans through K4
(:func:`.cluster_cuda.trace_binned_pass`), the rays that still need more
run a second such pass binned by their second-nearest cluster, and only
the rest, compacted to a slice, go through the drain kernel, which skips
what the passes before it ran (``t_start``). The multipass trace
(:func:`sorted_trace_multipass`; ``multipass_cap``) caps the drain
kernel's walk per tile, regroups the rays it left unfinished by the next
cluster they need, and traces those again. All three return the plain
sorted trace's results.

The keys are the slab test of every ray against every box (the supers,
for two-level tables), each ray's nearest entered boxes kept by the key
kernel (:func:`.cluster_cuda.top_keys_tiles`; its plain twin on CPU
tensors), whose call is the span ``wrt.trace.sort.key`` inside the
sort's ``wrt.trace.sort``. The rest is plain torch: every permutation is
a stable ``torch.sort``; rows are gathered by it and results scattered
back through its inverse. Each ``lax.cond`` of the JAX
package on a count of rays becomes one device-to-host read of that count
(:func:`live_count`, :func:`survivor_count`).

The chained sort (``chained_sort``, ops/integrator.py) permutes the whole
path state with :func:`nearest_cluster_key`, :func:`sort_keys` and
:func:`permute_rows` once per segment, and :func:`unsort` by the composed
permutation restores pixel order once at the end.
"""

from __future__ import annotations

import torch

from ..utils.timing import count, traced
from .cluster_cuda import (
    code_to_face,
    key_masks,
    top_keys_tiles,
    trace_binned_pass,
)
from .intersect import safe_inv_dir

_I32_MAX = 0x7FFFFFFF
_key_masks = key_masks


def _cid_of(k: torch.Tensor, c: int) -> torch.Tensor:
    """The box id of a packed key, ``c`` for "no box"."""
    kmask, miss_th = _key_masks(c)
    return torch.where((k & ~kmask) < miss_th, k & kmask,
                       torch.full_like(k, c))


def _top_keys(o, d, t_max, boxes, chunk: int, n: int, t_start=None,
              route: str = "auto"):
    """The ``n`` smallest packed ``(near | box id)`` keys of every ray →
    n tensors (R,) int32 (:func:`.cluster_cuda.top_keys_tiles`: the key
    kernel for CUDA tensors, its plain twin for CPU tensors; ``route`` as
    in cluster_cuda.ROUTES). The entry distance of each box the ray's slab
    test admits (near < far, near < t_max, far > 0; clamped at 0, -0 made
    +0; F32_MAX otherwise, and below the ray's ``t_start`` when given) and
    the box id share one int32, the id in the low mantissa bits, so near
    ties within the truncation break toward the lower id. ``chunk`` rays
    at a time keep the twin's (chunk, C) temporaries small."""
    return top_keys_tiles(
        o.contiguous(), safe_inv_dir(d).contiguous(), t_max.contiguous(),
        boxes.contiguous(), n,
        t_start=None if t_start is None else t_start.contiguous(),
        chunk=chunk, route=route)


@traced("wrt.trace.sort")
def nearest_cluster_key(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,) 0 for dead lanes
    boxes: torch.Tensor,  # (C, 6)
    chunk: int = 65536,
    t_start: torch.Tensor | None = None,  # (R,)
    route: str = "auto",
) -> torch.Tensor:
    """Coherence key (R,) int32: ``cid0 * (C + 1) + cid1`` of the ray's
    two nearest-entry hit boxes (:func:`_top_keys`), C standing for
    "none", so dead rays and rays that enter no box sort to the back.
    ``t_start`` restricts the key to the boxes the ray has NOT run yet
    (entry not below t_start: the skip mask of the multipass and binned
    traces). The key only orders rays; no result depends on it."""
    c = boxes.shape[0]
    k1, k2 = _top_keys(o, d, t_max, boxes, chunk, 2, t_start, route)
    return _cid_of(k1, c) * (c + 1) + _cid_of(k2, c)


def nearest_cluster_key_fused(o, d, t_max, boxes, route: str = "auto"):
    """:func:`nearest_cluster_key` as one reduction (JAX
    ``nearest_cluster_key_fused``, which takes the top two in one variadic
    reduce instead of two masked minima): the key kernel keeps each ray's
    two nearest keys in registers and writes nothing else, so here it is
    :func:`nearest_cluster_key` with no ``chunk`` and no ``t_start``; the
    same keys bit for bit."""
    return nearest_cluster_key(o, d, t_max, boxes, route=route)


@traced("wrt.trace.sort")
def nearest_cluster_keys2(o, d, t_max, boxes, chunk: int = 65536,
                          n: int = 2, route: str = "auto"):
    """The raw top-``n`` (2 or 3) packed keys per ray (:func:`_top_keys`),
    the binned traces' scheduling primitive: the caller decodes cid1 (the
    bin of pass 1), cid2 (the bin of the mid pass) and the truncated
    near2 and near3, the bounds below which a ray has nothing left to
    run."""
    return _top_keys(o, d, t_max, boxes, chunk, n, route=route)


def _block_schedules(cid_s, n_blocks: int, tile: int, c: int):
    """Per block of ``tile`` rays the two smallest distinct box ids it
    holds, (n_blocks, 2) int32 with -1 for none (``c`` is "no box"), and
    per ray whether its own id made that schedule: s0 is the block's
    minimum and s1 the minimum of the strictly greater rest, so no id
    lies between them and ``cid <= s1`` means ``cid in {s0, s1}``."""
    vals = cid_s.reshape(n_blocks, tile)
    s0 = torch.amin(vals, dim=1)
    s1 = torch.amin(
        torch.where(vals > s0[:, None], vals,
                    torch.full_like(vals, _I32_MAX)), dim=1)
    flag = (vals <= s1[:, None]).reshape(-1)
    none = torch.full_like(s0, -1)
    sched = torch.stack(
        [torch.where(s0 < c, s0, none), torch.where(s1 < c, s1, none)],
        dim=-1)
    return sched, flag


@traced("wrt.trace.sort")
def permute_rows(perm: torch.Tensor, tree):
    """Gather the rows ``perm`` of every tensor of ``tree`` (a tensor, or
    a tuple, list or dict of trees; None stays None)."""
    return _gather(perm, tree)


def _gather(perm, tree):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree[perm]
    if isinstance(tree, dict):
        return {k: _gather(perm, v) for k, v in tree.items()}
    return type(tree)(_gather(perm, v) for v in tree)


@traced("wrt.trace.sort")
def sort_keys(key: torch.Tensor):
    """(sorted keys, the permutation that sorts them): a stable sort, so
    the permutation is deterministic."""
    return torch.sort(key, stable=True)


@traced("wrt.trace.sort")
def live_count(key_s: torch.Tensor, n_boxes: int) -> int:
    """How many rays enter some box (a key below ``n_boxes * (n_boxes +
    1)``: at or above it the nearest box is already "none"), read from the
    device."""
    return int((key_s < n_boxes * (n_boxes + 1)).sum())


@traced("wrt.trace.sort")
def survivor_count(surv: torch.Tensor) -> int:
    """How many rays of a pass still need work, read from the device: it
    decides whether they fit the next pass's slice."""
    return int(surv.sum())


@traced("wrt.trace.sort")
def unsort(perm: torch.Tensor, leaves, rest=None):
    """Restore ``leaves`` (tensors in sorted order, followed by ``rest``,
    the rows that were not traced, when the leg was sliced) to the
    original ray order."""
    if rest is not None:
        leaves = tuple(torch.cat([a, b]) for a, b in zip(leaves, rest))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return tuple(x[inv] for x in leaves)


def sorted_trace(trace_fn, o, d, t_max, tables, active=None, extra=None,
                 live_slice=None, tail=None, route: str = "auto"):
    """Run ``trace_fn(o, d, t_max, tables, None[, extra])`` with the rays
    permuted by :func:`nearest_cluster_key`; the result (a tensor or a
    tuple of tensors with R rows) is restored to the original ray order.
    ``active`` is folded into ``t_max`` (a dead lane has an empty
    interval).

    ``live_slice`` (a fraction below 1, with ``tail``) traces only the
    leading ``ceil(R * live_slice / 128) * 128`` rows of the sorted
    stream, when every ray that enters some box lies within them: the
    rays behind (dead lanes, and live rays whose line enters no box) are
    misses whatever the trace does, and ``tail(t_max of those rows)``
    makes their result. Slicing at a multiple of 128 keeps every traced
    tile's rays together, so the result is the full trace's bit for bit.
    When the live rays overflow the slice, the full width is traced. The
    count is read from the device once per sliced leg.

    The stages are this module's functions (:func:`nearest_cluster_key`,
    :func:`sort_keys`, :func:`permute_rows`, :func:`live_count`,
    :func:`unsort`), looked up when called, so that a profile can wrap
    each one. With tracing on, the leg counts (utils/timing.count) itself
    in ``trace.sort.legs`` (1), ``trace.sort.rays`` (R),
    ``trace.sort.traced`` (the rows traced), ``trace.sort.count_reads``
    (1 where the live rays were counted on the host) and
    ``trace.sort.full_width`` (1 where they overflowed the slice): host
    numbers it holds anyway. ``route`` (cluster_cuda.ROUTES) is the
    key's."""
    r = o.shape[0]
    if active is not None:
        t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    boxes = tables.clusters.sort_box
    key_s, perm = sort_keys(nearest_cluster_key(o, d, t_max, boxes,
                                                route=route))
    o_s, d_s, tm_s, ex_s = permute_rows(perm, (o, d, t_max, extra))
    w = r
    if live_slice is not None and tail is not None and live_slice < 1.0:
        w = min(r, ((int(r * live_slice) + 127) // 128) * 128)
    if w < r:
        count("trace.sort.count_reads", 1)
        if live_count(key_s, boxes.shape[0]) > w:
            count("trace.sort.full_width", 1)
            w = r
    count("trace.sort.legs", 1)
    count("trace.sort.rays", r)
    count("trace.sort.traced", w)
    args = (o_s[:w], d_s[:w], tm_s[:w], tables, None)
    if extra is not None:
        args = args + (ex_s[:w],)
    res_s = trace_fn(*args)
    single = torch.is_tensor(res_s)
    rest = None
    if w < r:
        rest = tail(tm_s[w:])
        rest = (rest,) if torch.is_tensor(rest) else tuple(rest)
    out = unsort(perm, (res_s,) if single else tuple(res_s), rest)
    return out[0] if single else out


def _pad_rays(o, d, t_max, extra, tile: int):
    """Pad to whole blocks of ``tile`` rays with dead lanes (t_max 0, no
    exclusion), which sort to the back."""
    pad = (-o.shape[0]) % tile
    if pad:
        o = torch.cat([o, o.new_ones((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros((pad,))])
        if extra is not None:
            extra = torch.cat([extra, extra.new_full((pad,), -1)])
    return o, d, t_max, extra


def _slice_width(r: int, frac: int, tile: int) -> int:
    """ceil(r / frac) rounded up to whole tiles, at least one, at most r."""
    return min(r, max(tile, (-(-r // frac) + tile - 1) // tile * tile))


def _compact(surv: torch.Tensor, width: int) -> torch.Tensor:
    """The rows of the leading ``width`` lanes once survivors are moved to
    the front (stable: the order within each class is kept)."""
    return sort_keys((~surv).to(torch.int32))[1][:width]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _mid_pass(o_s, d_s, ex_s, t_in, code_in, cid2, surv1, w1, tables, tile,
              c, route):
    """The second binned pass: the leading ``w1`` lanes of the
    survivors-first order, re-sorted by their second-nearest cluster, run
    K4 once more from the best they carry (``t_in`` as t_max, ``code_in``
    beside it or None; lanes that are no survivors ride along dead) →
    (rows of the sorted stream, survivor mask, t, code, schedule flag),
    all in the pass's own order."""
    idx1 = _compact(surv1, w1)
    cid2_ss, p2 = sort_keys(cid2[idx1])
    rows = idx1[p2]
    o_m, d_m, t_m, c_m, sv, ex_m = permute_rows(
        rows, (o_s, d_s, t_in, code_in, surv1, ex_s))
    sched2, flag2 = _block_schedules(cid2_ss, w1 // tile, tile, c)
    t2, c2 = trace_binned_pass(
        o_m, d_m, torch.where(sv, t_m, torch.zeros_like(t_m)), tables,
        sched2, excl_code=ex_m, start_code=c_m, tile=tile, codes=True,
        route=route)
    return rows, sv, torch.where(sv, t2, t_m), c2, flag2


def binned_trace(fn, o, d, t_max, tables, active=None, extra=None,
                 surv_frac: int = 3, tile: int = 128, route: str = "auto"):
    """Per-ray-scheduled sorted trace, closest-hit (JAX ``binned_trace``)
    → (t, face) in the original ray order, equal to the plain sorted
    trace's.

    Pass 1 runs each ray's NEAREST entered cluster: the rays are sorted
    by it (stable), and every block of ``tile`` rays runs the at most two
    distinct clusters it spans through K4. A ray needs more only if its
    second-nearest entry could still beat its best t; those survivors, if
    they fit half the width, run a second K4 pass binned by their
    second-nearest cluster, after which the bound moves to the third
    entry. What is left goes through :func:`_recompact_final_pass`: the
    drain kernel ``fn`` on a slice of ``1 / surv_frac`` of the width (the
    full width if the survivors overflow it), skipping what is proven run.

    The stop key is JAX's, per ray: with ``flag`` = "my nearest cluster
    made my block's schedule", ``stop = max(trunc(near2) - 1, 0)`` for
    flagged rays (``trunc(near3)`` once the mid pass ran their second
    cluster too), 0 for the others (nothing is proven run), int32 max for
    dead lanes; a ray survives iff ``bits(t) > stop`` and goes on with
    ``t_start = f32(stop)``. ``trunc`` clears the id bits of the packed
    key; the port's t carries no slot bits, so nothing else is masked.

    Ties: every pass starts from the (t, code) the pass before it
    carried, so at equal t the lower code wins, as in one K1 walk. Like
    any regrouping of rays (the plain sort too) the passes differ from
    one walk only in which clusters a ray tests beyond those it enters
    below its final t, which matters only when such a cluster holds a hit
    at exactly that t with a lower code.

    ``fn(o, d, t_max, tables, None, excl_code=, t_start=, start_code=)``
    → (t, code) is the single-level closest-hit dispatcher with
    ``raw="code"``; ``route`` (cluster_cuda.ROUTES) is K4's and the
    keys'."""
    r0 = o.shape[0]
    if active is not None:
        t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    ct = tables.clusters
    boxes = ct.sort_box
    c = boxes.shape[0]
    kmask, _ = _key_masks(c)
    o, d, t_max, extra = _pad_rays(o, d, t_max, extra, tile)
    r = o.shape[0]

    k1, k2, k3 = nearest_cluster_keys2(o, d, t_max, boxes, n=3, route=route)
    cid_s, perm = sort_keys(_cid_of(k1, c))
    o_s, d_s, tm_s, k2_s, k3_s, ex_s = permute_rows(
        perm, (o, d, t_max, k2, k3, extra))
    sched, flag = _block_schedules(cid_s, r // tile, tile, c)
    t1, c1 = trace_binned_pass(o_s, d_s, tm_s, tables, sched,
                               excl_code=ex_s, tile=tile, codes=True,
                               route=route)

    live = tm_s > 0.0
    zero = torch.zeros_like(k2_s)
    dead = torch.full_like(k2_s, _I32_MAX)
    stop_near2 = torch.where(flag, torch.clamp((k2_s & ~kmask) - 1, min=0),
                             zero)
    surv1 = _bits(t1) > torch.where(live, stop_near2, dead)
    flag2 = torch.zeros_like(flag)
    w1 = _slice_width(r, 2, tile)
    if w1 >= r or survivor_count(surv1) <= w1:
        rows, sv, t2, c2, fl2 = _mid_pass(
            o_s, d_s, ex_s, t1, c1, _cid_of(k2_s, c), surv1, w1, tables,
            tile, c, route)
        t1, c1 = t1.clone(), c1.clone()
        t1[rows] = t2
        c1[rows] = torch.where(sv, c2, c1[rows])
        flag2[rows] = fl2
    # both nearest clusters proven run: the bound moves to near3
    stop = torch.where(
        live,
        torch.where(flag & flag2,
                    torch.clamp((k3_s & ~kmask) - 1, min=0), stop_near2),
        dead)
    t_fin, c_fin = _recompact_final_pass(
        fn, o_s, d_s, ex_s, t1, c1, stop, tables, boxes, surv_frac, tile,
        route)
    t, code = unsort(perm, (t_fin, c_fin))
    return t[:r0], code_to_face(code[:r0], ct.face_id)


def binned_trace_any(fn, o, d, t_max, tables, active=None, extra=None,
                     surv_frac: int = 4, tile: int = 128, mid: bool = False,
                     route: str = "auto"):
    """Any-hit :func:`binned_trace` (JAX ``binned_trace_any``) → (R,) bool
    blocked, in the original ray order: exactly the plain sorted any-hit
    trace's set, since "blocked" is existence and any order proves it.

    Pass 1 (K4, whose code is read only as hit or miss) tests each ray's
    nearest cluster; a ray survives when it is live, has no hit yet and a
    further entered cluster exists (its second, or its first if that made
    no schedule). ``mid`` adds the second K4 pass over the survivors, as
    in :func:`binned_trace`; off by default as in the JAX package. The
    survivors, compacted to ``1 / surv_frac`` of the width (else the full
    width), run the any-hit drain ``fn(o, d, t_max, tables, None,
    excl_code=, t_start=)`` → blocked, with ``t_start`` = the truncated
    entry of the first cluster not proven run (0: none is). ``route`` is
    K4's and the keys', as in :func:`binned_trace`."""
    r0 = o.shape[0]
    if active is not None:
        t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    boxes = tables.clusters.sort_box
    c = boxes.shape[0]
    kmask, miss_th = _key_masks(c)
    o, d, t_max, extra = _pad_rays(o, d, t_max, extra, tile)
    r = o.shape[0]

    ks = nearest_cluster_keys2(o, d, t_max, boxes, n=3 if mid else 2,
                               route=route)
    cid_s, perm = sort_keys(_cid_of(ks[0], c))
    o_s, d_s, tm_s, ks_s, ex_s = permute_rows(perm, (o, d, t_max, ks, extra))
    k1_s, k2_s = ks_s[0], ks_s[1]
    k3_s = ks_s[2] if mid else k2_s
    sched, flag = _block_schedules(cid_s, r // tile, tile, c)
    hit = trace_binned_pass(o_s, d_s, tm_s, tables, sched, excl_code=ex_s,
                            tile=tile, codes=True, route=route)[1] >= 0

    live = tm_s > 0.0
    entered1, entered2, entered3 = (
        (k & ~kmask) < miss_th for k in (k1_s, k2_s, k3_s))
    more1 = torch.where(flag, entered2, entered1)
    flag2 = torch.zeros_like(flag)
    if mid:
        surv1 = live & ~hit & more1
        w1 = _slice_width(r, 2, tile)
        if w1 >= r or survivor_count(surv1) <= w1:
            rows, sv, _, c2, fl2 = _mid_pass(
                o_s, d_s, ex_s, tm_s, None, _cid_of(k2_s, c), surv1, w1,
                tables, tile, c, route)
            hit = hit.clone()
            hit[rows] |= sv & (c2 >= 0)
            flag2[rows] = fl2
    both = flag & flag2
    surv = live & ~hit & torch.where(both, entered3, more1)
    zero = torch.zeros_like(tm_s)
    t_start = torch.where(
        both & entered3, (k3_s & ~kmask).view(torch.float32),
        torch.where(flag & entered2, (k2_s & ~kmask).view(torch.float32),
                    zero))

    w2 = _slice_width(r, surv_frac, tile)
    width = w2 if (w2 >= r or survivor_count(surv) <= w2) else r
    rows = _compact(surv, width)
    o3, d3, tm3, ts3, sv3, ex3 = permute_rows(
        rows, (o_s, d_s, tm_s, t_start, surv, ex_s))
    found = fn(o3, d3, torch.where(sv3, tm3, zero[:width]), tables, None,
               excl_code=ex3, t_start=ts3)
    blocked = hit.clone()
    blocked[rows] |= found
    return unsort(perm, (blocked,))[0][:r0]


def _recompact_final_pass(fn, o_s, d_s, ex_s, t_cur, c_cur, stop, tables,
                          boxes, surv_frac: int, tile: int = 128,
                          route: str = "auto"):
    """The uncapped last pass over the SURVIVORS only (``bits(t_cur) >
    stop``), compacted to a slice of ``1 / surv_frac`` of the width (JAX
    ``_recompact_final_pass``) → (t, code) in the given order, the other
    rows untouched.

    One stable sort moves the survivors to the front; the slice's rows
    are gathered, keyed by the clusters they have NOT run yet
    (:func:`nearest_cluster_key` with ``t_start = f32(stop)``), sorted,
    and traced by ``fn`` from the best they carry, skipping what is
    proven run; the results are scattered back over the slice's rows. If
    the survivors overflow the slice, the same pass runs at the full
    width. Lanes of the slice that are no survivors ride along dead.
    ``route`` is the key's."""
    r = o_s.shape[0]
    surv = _bits(t_cur) > stop
    t_start = stop.view(torch.float32)  # int32 max: NaN, which masks all
    w2 = _slice_width(r, surv_frac, tile)
    width = w2 if (w2 >= r or survivor_count(surv) <= w2) else r
    idx = _compact(surv, width)
    o2, d2, ts2, t2, sv2 = permute_rows(
        idx, (o_s, d_s, t_start, t_cur, surv))
    tm2 = torch.where(sv2, t2, torch.zeros_like(t2))
    p = sort_keys(nearest_cluster_key(o2, d2, tm2, boxes, t_start=ts2,
                                      route=route))[1]
    rows = idx[p]
    o3, d3, tm3, ts3, c3, sv3, ex3 = permute_rows(p, (
        o2, d2, tm2, ts2, c_cur[idx], sv2, None if ex_s is None
        else ex_s[idx]))
    t_n, c_n = fn(o3, d3, tm3, tables, None, excl_code=ex3, t_start=ts3,
                  start_code=c3)
    t_out, c_out = t_cur.clone(), c_cur.clone()
    t_out[rows] = torch.where(sv3, t_n, t_out[rows])
    c_out[rows] = torch.where(sv3, c_n, c3)
    return t_out, c_out


def sorted_trace_multipass(fn, o, d, t_max, tables, active=None, extra=None,
                           cap: int = 4, passes: int = 2,
                           surv_frac: int = 8, route: str = "auto"):
    """Capped walks and recompaction, closest-hit (JAX
    ``sorted_trace_multipass``) → (t, face) in the original ray order,
    equal to the plain sorted trace's.

    Pass 1 is the plain sorted trace with every tile's walk ended after
    ``cap`` clusters; the kernel's stop (``return_stop``) says per ray
    where its tile stopped, and a ray whose best t lies above it (as
    bits) survives. With ``passes == 2`` the survivors run
    :func:`_recompact_final_pass` on ``1 / surv_frac`` of the width. With
    more passes every pass runs at the full width: the rays are re-sorted
    by the clusters they have not run yet, traced again from the best they
    carry with ``t_start = f32(stop)``, capped but for the last.

    ``fn(o, d, t_max, tables, None, excl_code=, t_start=, start_code=,
    cap=, return_stop=)`` → (t, code[, stop]) is the single-level
    closest-hit dispatcher with ``raw="code"``, on a kernel that can cap
    (K1); one that cannot reports every tile as drained and pass 1 is
    then the whole trace. ``route`` is the keys'."""
    if active is not None:
        t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    boxes = tables.clusters.sort_box
    perm = sort_keys(nearest_cluster_key(o, d, t_max, boxes, route=route))[1]
    o_s, d_s, ex_s = permute_rows(perm, (o, d, extra))
    t_cur, c_cur, stop = fn(o_s, d_s, t_max[perm], tables, None,
                            excl_code=ex_s, cap=cap, return_stop=True)
    if passes == 2:
        t_cur, c_cur = _recompact_final_pass(
            fn, o_s, d_s, ex_s, t_cur, c_cur, stop, tables, boxes,
            surv_frac, route=route)
        passes = 1  # no full-width pass follows
    for n_pass in range(1, passes):
        surv = _bits(t_cur) > stop
        tm_n = torch.where(surv, t_cur, torch.zeros_like(t_cur))
        t_start = stop.view(torch.float32)
        p = sort_keys(
            nearest_cluster_key(o_s, d_s, tm_n, boxes, t_start=t_start,
                                route=route))[1]
        perm = perm[p]
        o_s, d_s, tm_n, t_start, t_cur, c_cur, surv, ex_s = permute_rows(
            p, (o_s, d_s, tm_n, t_start, t_cur, c_cur, surv, ex_s))
        more = {} if n_pass == passes - 1 else dict(cap=cap,
                                                    return_stop=True)
        t_n, c_n, *stop_n = fn(o_s, d_s, tm_n, tables, None, excl_code=ex_s,
                               t_start=t_start, start_code=c_cur, **more)
        t_cur = torch.where(surv, t_n, t_cur)
        c_cur = torch.where(surv, c_n, c_cur)
        if stop_n:
            stop = stop_n[0]
    t, code = unsort(perm, (t_cur, c_cur))
    return t, code_to_face(code, tables.clusters.face_id)
