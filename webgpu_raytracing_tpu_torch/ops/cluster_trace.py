"""Cluster tables and the plain-torch pieces of the clustered trace
(counterpart of ``webgpu_raytracing_tpu/ops/cluster_trace.py``).

The scene is cut into clusters of up to S triangles (models/cluster.py).
A trace walks, per 128-ray tile, the clusters whose boxes the tile's rays
enter, nearest entry first. Large scenes add a second level: G
consecutive clusters form a supercluster (``super_box``), the tile walks
supers nearest entry first, and the kernel slab-tests each super's G
children itself (``child_box_t`` keeps the JAX package's transposed copy
of those boxes). This module holds what runs outside the trace kernels
(ops/cluster_cuda.py): the tables, the per-tile entry distances
(:func:`tile_nears_fused`, over clusters or over supers), the ray matrix
A (:func:`ray_matrix`) and the exact sequential Möller–Trumbore
evaluation (:func:`exact_face_eval`, :func:`rederive_uv`).

The bilinear-form matrix ``mat_b`` gives, for a ray row A = [o | o×d | d
| 1], det, t_num, u_num and v_num of every slot as A·B. The exact-pairs
kernels (K2p, K3p) read it for their estimates; K1 and K3 test triangles
with exact sequential f32 arithmetic on ``tri`` instead. The bf16
pre-split twin ``mat_b2`` exists only for the TPU's matrix unit and is
not built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import EPSILON, F32_MAX, MIN_DIST
from .detmath import det_div
from .intersect import Hit
from .strictf import scross, sdot3

_INF = float(F32_MAX)
# f32(EPSILON²): the backface/parallel cull threshold of render.ts:384
EPS2 = float(np.float32(EPSILON * EPSILON))


@dataclasses.dataclass(frozen=True)
class ClusterTables:
    """Cluster tables on one device.

    Two-level layout (large scenes, models/cluster.py ``group_size``):
    ``super_box`` / ``child_box_t`` present, and supercluster ``s`` owns
    the cluster rows ``[s*G, (s+1)*G)`` (pad rows: inverted-empty boxes,
    no faces). ``box`` always holds all C cluster boxes. Single-level:
    both None."""

    box: torch.Tensor  # (C, 6) f32 AABB min.xyz, max.xyz
    mat_b: torch.Tensor  # (C, 10, 4*S) f32 Möller–Trumbore bilinear matrix
    face_id: torch.Tensor  # (C, S) i32 global face ids (-1 pad)
    # (n_faces,) i32 cluster-slot code (cid*S + slot) of each face's
    # two-sided duplicate, -1 when none (see the JAX ClusterTables)
    partner_code: Optional[torch.Tensor] = None
    super_box: Optional[torch.Tensor] = None  # (C2, 6) f32
    # (C2, 8, G) f32: rows 0:3 child bmin.xyz, 3:6 bmax.xyz, 6:8 zero
    child_box_t: Optional[torch.Tensor] = None

    @property
    def group(self) -> int:
        return 0 if self.super_box is None else self.child_box_t.shape[2]

    @property
    def sort_box(self) -> torch.Tensor:
        """Boxes of the ray sort's coherence key (ops/ray_sort.py): the
        supers when present, else the clusters."""
        return self.box if self.super_box is None else self.super_box

    def to(self, device) -> "ClusterTables":
        return ClusterTables(
            **{
                f.name: (
                    None
                    if getattr(self, f.name) is None
                    else getattr(self, f.name).to(device)
                )
                for f in dataclasses.fields(self)
            }
        )


def pack_cluster_tables(clusters, partner=None, *, device) -> ClusterTables:
    """models.cluster.ClusterSet → ClusterTables (same B layout, partner
    codes and two-level fields as the JAX package's
    ``pack_cluster_tables``)."""
    c, s, _ = clusters.n.shape
    b = np.zeros((c, 10, 4 * s), dtype=np.float32)
    nt = np.transpose(clusters.n, (0, 2, 1))
    b[:, 6:9, 0 * s : 1 * s] = -nt
    b[:, 0:3, 1 * s : 2 * s] = nt
    b[:, 9, 1 * s : 2 * s] = -clusters.k0
    b[:, 3:6, 2 * s : 3 * s] = np.transpose(clusters.e2, (0, 2, 1))
    b[:, 6:9, 2 * s : 3 * s] = np.transpose(clusters.q2, (0, 2, 1))
    b[:, 3:6, 3 * s : 4 * s] = -np.transpose(clusters.e1, (0, 2, 1))
    b[:, 6:9, 3 * s : 4 * s] = -np.transpose(clusters.q1, (0, 2, 1))

    super_box = child_box_t = None
    if clusters.super_box is not None:
        g = clusters.group
        c2 = clusters.super_box.shape[0]
        cb = np.zeros((c2, 8, g), dtype=np.float32)
        grp = clusters.box.reshape(c2, g, 6)
        cb[:, 0:3, :] = np.transpose(grp[:, :, 0:3], (0, 2, 1))
        cb[:, 3:6, :] = np.transpose(grp[:, :, 3:6], (0, 2, 1))
        super_box = torch.from_numpy(
            np.ascontiguousarray(clusters.super_box)
        ).to(device)
        child_box_t = torch.from_numpy(cb).to(device)

    partner_code = None
    if partner is not None:
        fid = np.asarray(clusters.face_id)
        n_faces = int(partner.shape[0])
        code_of = np.full(n_faces, -1, np.int32)
        sel = fid >= 0
        codes = (
            np.arange(c, dtype=np.int32)[:, None] * s
            + np.arange(s, dtype=np.int32)[None, :]
        )
        code_of[fid[sel]] = codes[sel]
        partner_code = torch.from_numpy(
            np.where(partner >= 0, code_of[np.maximum(partner, 0)], -1)
            .astype(np.int32)
        ).to(device)

    return ClusterTables(
        box=torch.from_numpy(np.ascontiguousarray(clusters.box)).to(device),
        mat_b=torch.from_numpy(b).to(device),
        face_id=torch.from_numpy(
            np.ascontiguousarray(clusters.face_id)
        ).to(device),
        partner_code=partner_code,
        super_box=super_box,
        child_box_t=child_box_t,
    )


def ray_matrix(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A = [o | o×d | d | 1] — (R, 10), the rows of ``mat_b``'s bilinear
    form (JAX ``ray_matrix``; o×d with strict products)."""
    ones = torch.ones(o.shape[:-1] + (1,), dtype=o.dtype, device=o.device)
    return torch.cat([o, scross(o, d), d, ones], dim=-1)


def exact_face_eval(o, d, tri, present, t_bound):
    """Exact sequential Möller–Trumbore under the reference's semantics
    (render.ts:359-409; JAX ``_exact_face_eval``): cull, barycentric gates
    against det, true division, strict t interval. Broadcasts over any
    leading shape. Returns (valid, t, u, v)."""
    p0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    h = scross(d, e2)
    det = sdot3(e1, h)
    sv = o - p0
    u_num = sdot3(sv, h)
    q = scross(sv, e1)
    v_num = sdot3(d, q)
    t_num = sdot3(e2, q)
    culled = det < EPS2
    bary_ok = (
        (u_num >= 0.0) & (u_num <= det) & (v_num >= 0.0)
        & (u_num + v_num <= det)
    )
    det_safe = torch.where(culled, torch.ones_like(det), det)
    t = t_num / det_safe
    valid = present & ~culled & bary_ok & (t > MIN_DIST) & (t < t_bound)
    return valid, t, u_num / det_safe, v_num / det_safe


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


def tile_nears_fused(
    o: torch.Tensor,  # (R, 3), R divisible by tile
    inv_d: torch.Tensor,  # (R, 3)
    t_max: torch.Tensor,  # (R,)
    boxes: torch.Tensor,  # (C, 6)
    tile: int,
    max_elems: int = 1 << 24,
    t_start: Optional[torch.Tensor] = None,  # (R,)
) -> torch.Tensor:
    """Per-tile per-cluster minimum entry distance (n_tiles, C): the
    slab test of every ray against every box (entry clamped at 0, +inf on
    a miss or when the entry is not below the ray's t_max), min-reduced
    over each tile. Same per-axis arithmetic as the JAX function; tiles
    are processed in batches of at most ``max_elems`` ray-box pairs.

    ``t_start`` is the skip mask of the multipass and binned traces
    (ops/ray_sort.py): a ray's entry into a box counts only when it is not
    below the ray's ``t_start``, since an earlier pass has already run
    every box the ray enters nearer than that. A NaN ``t_start`` masks
    every box of its ray."""
    r = o.shape[0]
    n_tiles = r // tile
    c = boxes.shape[0]
    out = torch.empty((n_tiles, c), dtype=torch.float32, device=o.device)
    per = max(1, min(n_tiles, max_elems // (tile * c)))
    bmin = boxes[:, 0:3]
    bmax = boxes[:, 3:6]
    for t0_ in range(0, n_tiles, per):
        t1_ = min(n_tiles, t0_ + per)
        sl = slice(t0_ * tile, t1_ * tile)
        ot, it, tt = o[sl], inv_d[sl], t_max[sl]
        near = None
        far = None
        for ax in range(3):
            a = (bmin[None, :, ax] - ot[:, ax : ax + 1]) * it[:, ax : ax + 1]
            b = (bmax[None, :, ax] - ot[:, ax : ax + 1]) * it[:, ax : ax + 1]
            lo = torch.minimum(a, b)
            hi = torch.maximum(a, b)
            # the JAX function starts from near=-inf / far=+inf; max/min
            # against those are identities (NaN-propagating alike)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        hit = (near < far) & (near < tt[:, None]) & (far > MIN_DIST)
        nears = torch.where(
            hit, torch.clamp(near, min=0.0), torch.full_like(near, _INF)
        )
        if t_start is not None:
            nears = torch.where(nears >= t_start[sl][:, None], nears,
                                torch.full_like(nears, _INF))
        out[t0_:t1_] = torch.amin(nears.view(t1_ - t0_, tile, c), dim=1)
    return out
