"""Ray reordering for traversal coherence (counterpart of
``nearest_cluster_key``, ``permute_rows`` and ``sorted_trace`` in
``webgpu_raytracing_tpu/ops/ray_sort.py``).

Bounce and shadow rays are incoherent in pixel order: the rays of a
128-ray tile together enter many more clusters than any one of them
needs. Sorting the rays by their two nearest entered clusters groups rays
that start their walk in the same clusters, and sends dead lanes and rays
that enter no cluster to the back, where whole tiles do no rounds and,
with ``live_slice``, are not traced at all. The sort is a pure
reordering: every result is restored to the original ray order and equals
the unsorted trace bit for bit.

Plain torch throughout: the key is a dense slab test of every ray against
every box (the supers, for two-level tables), in chunks of rays; the
permutation is a stable ``torch.sort`` of the keys; rows are gathered by
it and results scattered back through its inverse. The JAX package's
``lax.cond`` on the live count becomes one device-to-host read of that
count per sliced leg.

Not here: ``chained_sort``, ``sorted_trace_multipass``,
``nearest_cluster_keys2``, the binned traces and their recompaction pass.
"""

from __future__ import annotations

import torch

from ..config import F32_MAX, MIN_DIST
from .intersect import safe_inv_dir

_INF = float(F32_MAX)
_F32_MAX_BITS = 0x7F7FFFFF


def nearest_cluster_key(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,) 0 for dead lanes
    boxes: torch.Tensor,  # (C, 6)
    chunk: int = 65536,
) -> torch.Tensor:
    """Coherence key (R,) int32: ``cid0 * (C + 1) + cid1`` of the ray's
    two nearest-entry hit boxes, C standing for "none", so dead rays and
    rays that enter no box sort to the back. The entry distance (clamped
    at 0, -0 made +0) and the box id share one int32, the id in the low
    mantissa bits, and each pick is one masked minimum: near ties within
    the truncation break toward the lower id. The key only orders rays;
    no result depends on it. ``chunk`` rays at a time keep the (chunk, C)
    temporaries small."""
    r = o.shape[0]
    c = boxes.shape[0]
    dev = o.device
    inv_d = safe_inv_dir(d)
    cbits = max(1, (c - 1).bit_length())
    kmask = (1 << cbits) - 1
    miss_th = _F32_MAX_BITS & ~kmask
    iota = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    big = torch.iinfo(torch.int32).max
    keys = torch.empty((r,), dtype=torch.int32, device=dev)
    for r0 in range(0, r, chunk):
        sl = slice(r0, r0 + chunk)
        oc, ic, tc = o[sl], inv_d[sl], t_max[sl]
        near = far = None
        for ax in range(3):
            oa, ia = oc[:, ax : ax + 1], ic[:, ax : ax + 1]
            t0 = (boxes[None, :, ax] - oa) * ia
            t1 = (boxes[None, :, 3 + ax] - oa) * ia
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        hit = (near < far) & (near < tc[:, None]) & (far > MIN_DIST)
        nears = torch.where(
            hit, torch.clamp(near, min=0.0) + 0.0, torch.full_like(near, _INF)
        )
        pk = (nears.view(torch.int32) & ~kmask) | iota
        key = torch.zeros((oc.shape[0],), dtype=torch.int32, device=dev)
        for _ in range(2):  # the two nearest boxes, lexicographic
            k = torch.amin(pk, dim=1)
            cid = torch.where((k & ~kmask) < miss_th, k & kmask,
                              torch.full_like(k, c))
            key = key * (c + 1) + cid
            pk = torch.where(pk == k[:, None], torch.full_like(pk, big), pk)
        keys[sl] = key
    return keys


def permute_rows(perm: torch.Tensor, tree):
    """Gather the rows ``perm`` of every tensor of ``tree`` (a tensor, or
    a tuple, list or dict of trees; None stays None)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree[perm]
    if isinstance(tree, dict):
        return {k: permute_rows(perm, v) for k, v in tree.items()}
    return type(tree)(permute_rows(perm, v) for v in tree)


def sort_keys(key: torch.Tensor):
    """(sorted keys, the permutation that sorts them): a stable sort, so
    the permutation is deterministic."""
    return torch.sort(key, stable=True)


def live_count(key_s: torch.Tensor, n_boxes: int) -> int:
    """How many rays enter some box (a key below ``n_boxes * (n_boxes +
    1)``: at or above it the nearest box is already "none"), read from the
    device."""
    return int((key_s < n_boxes * (n_boxes + 1)).sum())


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
                 live_slice=None, tail=None):
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
    each one; nothing is measured here."""
    r = o.shape[0]
    if active is not None:
        t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    boxes = tables.clusters.sort_box
    key_s, perm = sort_keys(nearest_cluster_key(o, d, t_max, boxes))
    o_s, d_s, tm_s, ex_s = permute_rows(perm, (o, d, t_max, extra))
    w = r
    if live_slice is not None and tail is not None and live_slice < 1.0:
        w = min(r, ((int(r * live_slice) + 127) // 128) * 128)
    if w < r and live_count(key_s, boxes.shape[0]) > w:
        w = r
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
