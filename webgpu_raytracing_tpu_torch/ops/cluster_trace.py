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
evaluation (:func:`exact_face_eval`, :func:`rederive_uv`). On CUDA
tensors :func:`rederive_uv` is one launch of ``wrt_rederive_uv``
(``csrc/rederive.cu``); its plain twin is ``_rederive_uv_torch``.

It also holds the clustered oracle (``traversal="clustered"``; the JAX
package's XLA trace): :func:`trace_closest_clustered` and
:func:`trace_any_clustered`, plain torch that shares none of the kernels'
walk. Each round, every tile takes its nearest unprocessed cluster, the
bilinear form A·B (``torch.matmul``, as the JAX package's ``jnp.dot``
outside any Pallas kernel) picks each ray's two nearest candidate slots
(:func:`intersect_cluster_block_top2`), and :func:`exact_face_eval`
settles them; rounds go on while some tile's nearest unprocessed cluster
could still beat a ray's best t (any-hit: while a ray without a hit
could still find one). The matmul must run in full f32: PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32 = False``.

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
from ..utils.timing import count
from ._build import Kernel, check_args, launch
from .detmath import det_div
from .intersect import Hit, safe_inv_dir
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


def _rederive_uv_torch(o, d, t, face, tables) -> Hit:
    """:func:`rederive_uv`'s plain twin."""
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


def _launch_rederive_uv(o, d, t, face, tables) -> Hit:
    """Check the arguments and launch ``wrt_rederive_uv`` into one (3, R)
    tensor → its rows (views) as t, u, v, and ``face`` itself."""
    dev, r = o.device, o.shape[0]
    f32 = torch.float32
    o, d, t, fc, tri = check_args("rederive", dev, [
        ("o", o, f32, (r, 3)), ("d", d, f32, (r, 3)), ("t", t, f32, (r,)),
        ("face", face, torch.int32, (r,)),
        ("tri", tables.tri, f32, (tables.tri.shape[0], 9)),
    ])
    out = torch.empty((3, r), dtype=f32, device=dev)
    launch("rederive", "wrt_rederive_uv", dev, o.data_ptr(), d.data_ptr(),
           t.data_ptr(), fc.data_ptr(), tri.data_ptr(), out.data_ptr(), r)
    count("rederive.kernel_launches", 1)
    return Hit(*out.unbind(0), face=face)


rederive_uv = Kernel(
    "rederive_uv", _rederive_uv_torch, _launch_rederive_uv, "rederive",
    "Exact t and barycentrics of the winning triangle, from the face alone "
    "(o, d, t, face, tables) → Hit (unmasked Möller–Trumbore algebra, "
    "correctly rounded divides); misses keep the incoming t, with u = v = "
    "0. The kernel is ``wrt_rederive_uv`` (``csrc/rederive.cu``), its "
    "launches also counted in the frame's ``rederive.kernel_launches``.",
    span_name="wrt.trace.rederive")


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


def _bilinear(a, b, best_t):
    """A·B → (t masked to +inf where no valid hit beats ``best_t``, u_num,
    v_num, det with 1 where invalid) per slot; a (..., T, 10), b
    (..., 10, 4S), best_t (..., T)."""
    s = b.shape[-1] // 4
    out = torch.matmul(a, b)
    det = out[..., 0 * s:1 * s]
    t_num = out[..., 1 * s:2 * s]
    u_num = out[..., 2 * s:3 * s]
    v_num = out[..., 3 * s:4 * s]
    valid = ((det >= EPS2) & (u_num >= 0.0) & (u_num <= det)
             & (v_num >= 0.0) & (u_num + v_num <= det))
    # true division, the WGSL's rounding (render.ts:406-408)
    det_safe = torch.where(valid, det, torch.ones_like(det))
    t = t_num / det_safe
    valid = valid & (t > MIN_DIST) & (t < best_t.unsqueeze(-1))
    return torch.where(valid, t, torch.full_like(t, _INF)), u_num, v_num, det_safe


def _pick(x, slot):
    return torch.gather(x, -1, slot.unsqueeze(-1)).squeeze(-1)


def intersect_cluster_block(a, b, best_t):
    """Dense ray-block × cluster Möller–Trumbore on the bilinear form
    (JAX ``intersect_cluster_block``): a (..., T, 10), b (..., 10, 4S),
    best_t (..., T) → (t, u, v, slot) of the best slot per ray; slot -1
    and t = best_t where none beats best_t."""
    t_masked, u_num, v_num, det_safe = _bilinear(a, b, best_t)
    slot = torch.argmin(t_masked, dim=-1)
    t_best = _pick(t_masked, slot)
    u_best = _pick(u_num / det_safe, slot)
    v_best = _pick(v_num / det_safe, slot)
    hit = t_best < best_t
    return (torch.where(hit, t_best, best_t), u_best, v_best,
            torch.where(hit, slot, torch.full_like(slot, -1)))


def intersect_cluster_block_top2(a, b, best_t):
    """The slots of each ray's two nearest bilinear-valid triangles, -1
    when absent (JAX ``intersect_cluster_block_top2``): candidate
    selection only; :func:`exact_face_eval` adjudicates them."""
    t_masked, _, _, _ = _bilinear(a, b, best_t)
    slot1 = torch.argmin(t_masked, dim=-1)
    t1 = _pick(t_masked, slot1)
    iota = torch.arange(t_masked.shape[-1], device=a.device)
    t_masked2 = torch.where(iota == slot1.unsqueeze(-1),
                            torch.full_like(t_masked, _INF), t_masked)
    slot2 = torch.argmin(t_masked2, dim=-1)
    t2 = _pick(t_masked2, slot2)
    none = torch.full_like(slot1, -1)
    return (torch.where(t1 < _INF, slot1, none),
            torch.where(t2 < _INF, slot2, none))


def boxes_near(o, inv_d, boxes, t_max):
    """Slab test of every ray against every box (JAX ``_boxes_near``):
    o, inv_d (T, 3), boxes (C, 6), t_max (T,) → (T, C) entry distance
    clamped at 0, +inf on a miss."""
    bmin = boxes[None, :, 0:3]
    bmax = boxes[None, :, 3:6]
    t0 = (bmin - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bmax - o[:, None, :]) * inv_d[:, None, :]
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (near < far) & (near < t_max[:, None]) & (far > MIN_DIST)
    return torch.where(hit, torch.clamp(near, min=0.0),
                       torch.full_like(near, _INF))


def trace_closest_clustered(o, d, t_max, tables, active=None,
                            tile: int = 1024, any_hit: bool = False) -> Hit:
    """Closest hit per ray over coherent tiles of ``tile`` rays (JAX
    ``trace_closest_clustered``) → Hit; misses and inactive rays keep
    their t_max (0 for inactive ones) and face -1. With ``any_hit`` a
    tile stops once every ray of it has some valid hit: the face is then
    a hit, not necessarily the closest.

    Every round reads from the device whether some tile has work left."""
    ct = tables.clusters
    r0 = o.shape[0]
    dev = o.device
    if active is None:
        active = torch.ones((r0,), dtype=torch.bool, device=dev)
    pad = (-r0) % tile
    if pad:  # inactive rays to a whole number of tiles
        o = torch.cat([o, o.new_ones((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros((pad,))])
        active = torch.cat([active, active.new_zeros((pad,))])
    r = o.shape[0]
    n_tiles = r // tile
    s = ct.face_id.shape[1]
    t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    a_mat = ray_matrix(o, d).reshape(n_tiles, tile, 10)
    near_tc = tile_nears_fused(o, safe_inv_dir(d), t_max, ct.box, tile)
    fid_flat = ct.face_id.reshape(-1)
    rows = torch.arange(n_tiles, device=dev)

    best_t = t_max.to(torch.float32).clone()
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    best_slot = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_cid = torch.zeros((r,), dtype=torch.int64, device=dev)

    def tile_bound():
        """A tile's bound on useful entry distances: its rays' largest best
        t (closest hit), or largest t_max among rays with no hit yet."""
        if any_hit:
            pending = torch.where(best_slot >= 0, torch.zeros_like(t_max),
                                  t_max)
            return pending.view(n_tiles, tile).amax(1)
        return best_t.view(n_tiles, tile).amax(1)

    def tri_of(cid_r, slot):
        f = torch.where(slot >= 0, cid_r * s + slot.clamp(min=0),
                        torch.zeros_like(slot))
        return tables.tri[fid_flat[f].clamp(min=0).long()]

    while True:
        bound = tile_bound()
        if not bool((near_tc.amin(1) < bound).any()):
            break
        cid = near_tc.argmin(1)
        tile_act = near_tc[rows, cid] < bound
        slot1, slot2 = intersect_cluster_block_top2(
            a_mat, ct.mat_b[cid], best_t.view(n_tiles, tile))
        cid_r = cid.repeat_interleave(tile)
        slot1, slot2 = slot1.reshape(r), slot2.reshape(r)
        v1, t1, u1, w1 = exact_face_eval(o, d, tri_of(cid_r, slot1),
                                         slot1 >= 0, best_t)
        v2, t2, u2, w2 = exact_face_eval(o, d, tri_of(cid_r, slot2),
                                         slot2 >= 0, best_t)
        pick2 = v2 & (~v1 | (t2 < t1))
        improved = (v1 | v2) & tile_act.repeat_interleave(tile)
        best_t = torch.where(improved, torch.where(pick2, t2, t1), best_t)
        best_u = torch.where(improved, torch.where(pick2, u2, u1), best_u)
        best_v = torch.where(improved, torch.where(pick2, w2, w1), best_v)
        best_slot = torch.where(improved, torch.where(pick2, slot2, slot1),
                                best_slot)
        best_cid = torch.where(improved, cid_r, best_cid)
        # processed, also for tiles with no work: the bound only falls
        near_tc[rows, cid] = _INF

    face = torch.where(
        best_slot >= 0, fid_flat[best_cid * s + best_slot.clamp(min=0)],
        torch.full_like(fid_flat[:1], -1),
    ).to(torch.int32)
    return Hit(t=best_t[:r0], u=best_u[:r0], v=best_v[:r0], face=face[:r0])


def trace_any_clustered(o, d, t_max, tables, active=None,
                        tile: int = 1024) -> torch.Tensor:
    """Shadow-ray query (JAX ``trace_any_clustered``) → (R,) bool, True
    where some triangle blocks the ray with 0 < t < t_max."""
    return trace_closest_clustered(o, d, t_max, tables, active, tile,
                                   any_hit=True).face >= 0
