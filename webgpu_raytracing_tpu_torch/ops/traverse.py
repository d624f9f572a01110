"""Stackless BVH traversal over ray batches, the threaded oracle
(counterpart of ``webgpu_raytracing_tpu/ops/traverse.py``; the reference's
per-thread stack walk, render.ts:433-640).

The build threads every preorder tree with skip links (models/bvh.py), so
a walk is one uniform loop per ray:

    idx = (node box hit and not a leaf) ? idx + 1 : skip[idx]

over ``SceneTables.node_box`` and ``node_meta``, vectorized over the batch
with per-lane gathers. The per-model trees are chained by their skip
links, so falling off one model's subtree lands on the next root.

The JAX package's semantics: the search interval tightens to the best t
as the walk goes (render.ts:581-583, 597), a leaf tests at most two faces
in sequence (render.ts:589-606), Möller–Trumbore culls back faces. JAX's
``lax.while_loop`` is a Python loop over masked tensors here: each turn
reads ``any()`` of the live lanes from the device, and the trip count is
the longest walk in the batch. This is an oracle that shares no code with
the cluster kernels, not a fast path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .intersect import Hit, ray_aabb, ray_triangle, safe_inv_dir

__all__ = ["Hit", "trace_closest", "trace_any"]


def _start(o: torch.Tensor, active: Optional[torch.Tensor], n: int):
    """Node index per lane: the root for active lanes, past the end (done)
    for the others."""
    r = o.shape[0]
    if active is None:
        return torch.zeros((r,), dtype=torch.int64, device=o.device)
    return torch.where(active, 0, n).to(torch.int64)


def _leaf_faces(tables, idxc):
    """(box, skip, f0, f1) of the nodes ``idxc``."""
    box = tables.node_box[idxc]
    meta = tables.node_meta[idxc]
    return box, meta[:, 0].long(), meta[:, 1], meta[:, 2]


def trace_closest(
    o: torch.Tensor,  # (R, 3)
    d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,) search upper bound
    tables,
    active: Optional[torch.Tensor] = None,  # (R,) bool
) -> Hit:
    """Closest-hit query (rayIntersectBVH, render.ts:447-465): misses and
    inactive lanes keep ``t_max`` and face -1."""
    r = o.shape[0]
    n = tables.node_box.shape[0]
    inv_d = safe_inv_dir(d)
    idx = _start(o, active, n)
    t = t_max.to(torch.float32).clone()
    u = torch.zeros((r,), dtype=torch.float32, device=o.device)
    v = torch.zeros_like(u)
    face = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    while bool((idx < n).any()):
        in_tree = idx < n
        box, skip, f0, f1 = _leaf_faces(tables, idx.clamp(max=n - 1))
        box_hit, _ = ray_aabb(o, inv_d, box[:, 0:3], box[:, 3:6], t)
        box_hit = box_hit & in_tree
        is_leaf = f0 >= 0
        at_leaf = box_hit & is_leaf
        for fi in (f0, f1):
            tri = tables.tri[fi.clamp(min=0).long()]
            th = ray_triangle(o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9],
                              0.0, t)
            ok = at_leaf & (fi >= 0) & th.hit
            t = torch.where(ok, th.t, t)
            u = torch.where(ok, th.u, u)
            v = torch.where(ok, th.v, v)
            face = torch.where(ok, fi, face)
        nxt = torch.where(box_hit & ~is_leaf, idx + 1, skip)
        idx = torch.where(in_tree, nxt, idx)
    return Hit(t=t, u=u, v=v, face=face)


def trace_any(
    o: torch.Tensor,
    d: torch.Tensor,
    t_max: torch.Tensor,
    tables,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Any-hit query (rayIntersectBVHAnyHit, render.ts:468-480) → (R,)
    bool. A lane stops walking at its first hit."""
    r = o.shape[0]
    n = tables.node_box.shape[0]
    inv_d = safe_inv_dir(d)
    idx = _start(o, active, n)
    hit = torch.zeros((r,), dtype=torch.bool, device=o.device)
    while bool(((idx < n) & ~hit).any()):
        in_tree = (idx < n) & ~hit
        box, skip, f0, f1 = _leaf_faces(tables, idx.clamp(max=n - 1))
        box_hit, _ = ray_aabb(o, inv_d, box[:, 0:3], box[:, 3:6], t_max)
        box_hit = box_hit & in_tree
        is_leaf = f0 >= 0
        at_leaf = box_hit & is_leaf
        for fi in (f0, f1):
            tri = tables.tri[fi.clamp(min=0).long()]
            th = ray_triangle(o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9],
                              0.0, t_max)
            hit = hit | (at_leaf & (fi >= 0) & th.hit)
        nxt = torch.where(box_hit & ~is_leaf, idx + 1, skip)
        idx = torch.where(in_tree, nxt, idx)
    return hit
