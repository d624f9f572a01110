"""The least time a closest-hit leg needs on the card, from what its
inputs need and never from the walk a kernel takes.

For each active ray of the leg, with t its returned distance (the hit's,
or t_max on a miss): one slab test for every cluster box whose slab
interval meets [0, t]; one slot cull for every occupied slot of those
clusters; and the rest of the triangle test for the hit slot. Bytes:
each active ray's inputs (origin, direction, t_max, the excluded code)
and outputs (t, code) once, and each table row the leg needs once: the
box of every cluster some ray meets, its face ids, and the triangle of
each occupied slot. The clusters are the program's tables, the data the
leg reads. The bound is the larger of the operations over the card's
float32 peak and the bytes over its memory bandwidth.
"""

from __future__ import annotations

import torch

import reference

# f32 operations of one slab test, one triangle slot up to its cull, and
# the rest of the test past it (the port's ops/cluster_cuda.py)
BOX_TEST_OPS = 25
SLOT_CULL_OPS = 15
SLOT_REST_OPS = 35
RAY_BYTES = 12 + 12 + 4 + 4 + 4 + 4  # o, d, t_max, excl -> t, code
BOX_BYTES = 24
FACE_ID_BYTES = 4
TRI_BYTES = 36
# NVIDIA's data sheet, SXM part: float32 outside the tensor cores, HBM3
PEAKS = {"H100": dict(flops=67e12, bytes_per_s=3.35e12)}


def peaks_of(kind: str):
    """The peaks of a card by its name, or None for a card not listed."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    return None


def leg_work(o, d, t_max, active, t, face, box, face_id) -> dict:
    """Operations and bytes that one leg's inputs need (module doc)."""
    occupied = (face_id >= 0).sum(1).to(torch.float64)
    t_end = torch.where(face >= 0, t, t_max).float()
    _, found = reference.box_pairs(o, d, t_end, active, box,
                                   reference.blocks_of(box))
    boxes = float(found.numel())
    slots = float(occupied[found].sum())
    need = torch.unique(found)
    hits = float((active & (face >= 0)).sum())
    rays = float(active.sum())
    table = (BOX_BYTES + FACE_ID_BYTES * face_id.shape[1]) * need.numel() \
        + TRI_BYTES * float(occupied[need].sum())
    return dict(
        ops=BOX_TEST_OPS * boxes + SLOT_CULL_OPS * slots
        + SLOT_REST_OPS * hits,
        bytes=RAY_BYTES * rays + table, rays=rays, box_tests=boxes,
        slot_tests=slots, hits=hits,
    )


def bound_s(work: dict, peaks: dict):
    """(least seconds, 'ops' or 'bytes': which of the two bounds it)."""
    t_ops = work["ops"] / peaks["flops"]
    t_bytes = work["bytes"] / peaks["bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
