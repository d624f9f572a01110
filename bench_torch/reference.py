"""The plain reference: one progressive frame of the path tracer in
plain PyTorch, written from the semantics of the WebGPU reference
renderer (render.ts, rng.ts) as the port documents them, and sharing no
code with the port.

It takes a scene description from a generator of ``scenes/`` and the
frame's inputs (seed, view, settings), and returns each sample's colour
and the frame's ray count, as the port's ``render_frame`` accumulates
them. Its traversal is its own: faces sorted along a Morton curve into
groups of ``GROUP`` with padded boxes, every ray slab-tested against
every group box, and every face of a met group tested with the
sequential Moller-Trumbore of render.ts:359-409. The closest hit is the
least t, ties to the lower face index.

``dtype`` sets the precision of every float computed: float32 is the
reference; a lower one (bfloat16) is the precision control, which the
comparison has to reject. The RNG is integer arithmetic in every
precision; its floats are rounded to ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = 3.14159265358979323846264
TWO_PI = 6.28318530717958647692528
INV_PI = 0.31830988618379067153776
EPSILON = 0.001
EPS2 = float(np.float32(EPSILON * EPSILON))
UINT_MAX_F = 4294967295.0
MASK = 0xFFFFFFFF
GROUP = 64  # faces per group of the reference's own traversal
RAY_CHUNK = 8192  # rays slab-tested against the blocks at once
BLOCK = 64  # consecutive groups under one block box
BLOCK_CHUNK = 1 << 17  # (ray, block) pairs slab-tested at once
PAIR_CHUNK = 16384  # (ray, group) pairs whose faces are tested at once
ROWS_PIXELS = 1 << 20  # pixels of the rows rendered at once

# RenderSettings defaults of the reference store (store.ts:46-102) that
# the reference reads; a traffic or configuration file overrides them
DEFAULTS = dict(
    width=640, height=480, sample_count=1, bounces_depth=4,
    samples_per_point=1, fov=math.pi * 2 / 3, fov_orientation="horizontal",
    focus_distance=4.0, circle_of_confusion=0.0, panini_distance=1.0,
    vertical_compression=0.0, projection_type="panini",
    lens_shape="circle", shading_type="phong", env_nee_depth=0,
    next_event_estimation=False, environment="procedural",
    env_importance_sampling=False, jitter_strength=0.0,
)


# --- scene -----------------------------------------------------------

class Scene:
    """The scene description's faces as device tables of ``dtype``, and
    the reference's own groups of faces."""

    def __init__(self, desc, device, dtype=torch.float32):
        models, mat_color, mat_emission = desc
        faces = {k: np.concatenate([m[k] for _, m in models])
                 for k in models[0][1]}
        counts = [len(m["p0"]) for _, m in models]
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        partner = np.concatenate([
            np.where(m["partner"] >= 0, m["partner"] + off, -1)
            for (_, m), off in zip(models, offsets)]).astype(np.int64)

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), device=device,
                                   dtype=dt)

        self.device, self.dtype = torch.device(device), dtype
        self.tri = t(np.concatenate(
            [faces["p0"], faces["e1"], faces["e2"]], 1))
        self.shade = t(np.concatenate(
            [faces["normal"], faces["n0"], faces["n1"], faces["n2"]], 1))
        self.material = t(faces["material_idx"], torch.int64)
        self.partner = t(partner, torch.int64)
        self.mat_color = t(mat_color)
        self.mat_emission = t(mat_emission)
        self.light_offset, self.light_count = int(offsets[0]), counts[0]
        self._group(faces)

    def _group(self, faces):
        """Faces in Morton order of their centroids, cut into groups of
        GROUP; each group's box is padded so that rounding never leaves a
        face it holds outside it."""
        v0 = faces["p0"].astype(np.float64)
        v1, v2 = v0 + faces["e1"], v0 + faces["e2"]
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        c = (lo + hi) / 2
        q = ((c - c.min(0)) / max(np.ptp(c, 0).max(), 1e-30) * 1023)
        q = q.astype(np.int64)
        code = np.zeros(len(q), np.int64)
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
        order = np.argsort(code, kind="stable")
        n = len(order)
        pad = (-n) % GROUP
        ids = np.concatenate([order, np.full(pad, -1)]).reshape(-1, GROUP)
        ok = ids >= 0
        glo = np.where(ok[..., None], lo[np.maximum(ids, 0)], np.inf).min(1)
        ghi = np.where(ok[..., None], hi[np.maximum(ids, 0)], -np.inf).max(1)
        margin = 1e-4 * (np.abs(glo) + np.abs(ghi) + 1.0)
        box = np.concatenate([glo - margin, ghi + margin], 1)
        # boxes in float32 whatever the precision: they only select faces
        self.box = torch.as_tensor(box, dtype=torch.float32,
                                   device=self.device)
        self.group_faces = torch.as_tensor(ids, device=self.device)
        self.block_box, self.box_padded = blocks_of(self.box)


def blocks_of(box):
    """Blocks of BLOCK consecutive boxes under the union of theirs, and
    the boxes padded to whole blocks. A ray that meets a box meets its
    block's (float subtraction and product keep their order), so testing
    the boxes of the blocks a ray meets finds every box it meets."""
    pad = (-box.shape[0]) % BLOCK
    lo = torch.cat([box[:, 0:3], box.new_full((pad, 3), float("inf"))])
    hi = torch.cat([box[:, 3:6], box.new_full((pad, 3), float("-inf"))])
    block = torch.cat([lo.reshape(-1, BLOCK, 3).amin(1),
                       hi.reshape(-1, BLOCK, 3).amax(1)], 1)
    return block, torch.cat([box, box.new_zeros((pad, 6))])


def meets(o, inv, t_max, box):
    """Whether each ray's [0, t_max] meets each box: ``box`` is (boxes,
    6) for every ray, or (rays, boxes, 6), one row of boxes a ray. A box
    whose low corner lies above its high one on some axis is empty, and
    no ray meets it."""
    if box.dim() == 2:
        box = box[None]
    lo, hi = box[..., 0:3], box[..., 3:6]
    t0 = (lo - o[:, None]) * inv[:, None]
    t1 = (hi - o[:, None]) * inv[:, None]
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return ((near <= far) & (near <= t_max[:, None]) & (far >= 0.0)
            & (lo <= hi).all(-1))


def box_pairs(o, d, t_max, active, box, blocks):
    """(ray, box) pairs of active rays whose [0, t_max] meets the box:
    the blocks a ray meets (``blocks_of(box)``), then their boxes."""
    block_box, padded = blocks
    inv = 1.0 / torch.where(d.abs() < 1e-12,
                            torch.where(d >= 0, 1e-12, -1e-12), d)
    o32, inv32, tm32 = o.float(), inv.float(), t_max.float()
    kids = torch.arange(BLOCK, device=o.device)
    live = active.nonzero()[:, 0]
    rays = [live[:0]]
    found = [live[:0]]
    for a in range(0, live.numel(), RAY_CHUNK):
        ids = live[a:a + RAY_CHUNK]
        r, b = meets(o32[ids], inv32[ids], tm32[ids],
                     block_box).nonzero(as_tuple=True)
        for p in range(0, r.numel(), BLOCK_CHUNK):
            rr, bb = ids[r[p:p + BLOCK_CHUNK]], b[p:p + BLOCK_CHUNK]
            g = bb[:, None] * BLOCK + kids
            met = meets(o32[rr], inv32[rr], tm32[rr], padded[g]) & (
                g < box.shape[0])
            pr, k = met.nonzero(as_tuple=True)
            rays.append(rr[pr])
            found.append(g[pr, k])
    return torch.cat(rays), torch.cat(found)


# --- strict arithmetic -----------------------------------------------

def dot3(a, b):
    """(a0*b0 + a1*b1) + a2*b2, each product rounded."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v, eps=1e-20):
    n = torch.clamp(torch.sqrt(dot3(v, v)), min=eps).unsqueeze(-1)
    return v / n


def f64_round(fn, x):
    """fn evaluated in float64 and rounded to x's dtype: sin, cos and
    tan correctly rounded (to within double rounding)."""
    return fn(x.double()).to(x.dtype)


def fma(a, b, c, dtype):
    """a*b + c with one rounding to ``dtype``."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(np.float32(x))
    return (f64(a) * f64(b) + f64(c)).to(dtype)


# --- RNG (shaders/rng.ts) ----------------------------------------------

def random_1u(state):
    old = (state + (747796405 + 2891336453)) & MASK
    word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & MASK
    new = (word >> 22) ^ word
    return new, new


def random_1(state, dtype):
    u, state = random_1u(state)
    return (u.to(torch.float32) / UINT_MAX_F).to(dtype), state


def random_2(state, dtype):
    x, state = random_1(state, dtype)
    y, state = random_1(state, dtype)
    return torch.stack([x, y], -1), state


def sample_sphere(t):
    u = t[..., 0] * 2.0 - 1.0
    sin_theta = torch.sqrt(torch.clamp(1.0 - u * u, min=0.0))
    ang = TWO_PI * t[..., 1]
    return torch.stack([sin_theta * f64_round(torch.cos, ang), u,
                        sin_theta * f64_round(torch.sin, ang)], -1)


def cosine_hemisphere(t, n):
    """normalize(n + sample_sphere(t)), n as it is (rng.ts:88-100)."""
    return normalize(n + sample_sphere(t))


def sample_intriangle(t):
    u, v = t[..., 0], t[..., 1]
    flip = u + v > 1.0
    return torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)


# --- camera (render.ts:642-766) ----------------------------------------

def view_matrix(position, orientation):
    """gl-matrix fromRotationTranslation(orientation, -position)."""
    x, y, z, w = (float(a) for a in np.asarray(orientation, np.float64))
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    m = np.array([[1 - (yy + zz), xy - wz, xz + wy, 0],
                  [xy + wz, 1 - (xx + zz), yz - wx, 0],
                  [xz - wy, yz + wx, 1 - (xx + yy), 0],
                  [0, 0, 0, 1]], np.float64).astype(np.float32)
    m[:3, 3] = -np.asarray(position, np.float32)
    return m


def _f32_scalar(fn, *args):
    return float(fn(*[torch.tensor(a, dtype=torch.float32) for a in args]))


def camera_rays(pos, view, state, st, dtype):
    dev = pos.device
    w_f, h_f = float(st["width"]), float(st["height"])
    uv = 2.0 * pos - torch.tensor([w_f, h_f], dtype=dtype, device=dev)
    if st["fov_orientation"] == "vertical":
        uv = uv / h_f
    elif st["fov_orientation"] == "horizontal":
        uv = uv / w_f
    else:
        uv = uv / _f32_scalar(torch.sqrt, w_f * w_f + h_f * h_f)
    fov, proj = st["fov"], st["projection_type"]
    if proj == "panini":
        pd = st["panini_distance"]
        hv = uv * (fov / 2.0)
        hv_pan = hv * _f32_scalar(
            lambda h, p: torch.atan2(torch.sin(h), torch.cos(h) + p),
            fov / 2.0, pd)
        sx = f64_round(torch.sin, hv_pan[..., 0])
        cx = f64_round(torch.cos, hv_pan[..., 0])
        w = sx * pd
        m = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0)) + pd * cx
        x = sx * m
        z = cx * m - pd
        pd_vc = float(np.float32(pd * (1.0 - st["vertical_compression"])))
        y = f64_round(torch.tan, hv_pan[..., 1]) * (z + pd_vc)
        d = normalize(torch.stack([x, y, -z], -1))
    elif proj == "perspective":
        z = _f32_scalar(lambda f: -1.0 / torch.tan(f), fov / 2.0)
        d = normalize(torch.stack(
            [uv[..., 0], uv[..., 1], torch.full_like(uv[..., 0], z)], -1))
    else:
        raise NotImplementedError(f"projection {proj!r}")
    t2, state = random_2(state, dtype)  # the lens sample, always drawn
    if st["lens_shape"] == "circle":
        ang = t2[..., 0] * TWO_PI
        lens = torch.stack([f64_round(torch.cos, ang),
                            f64_round(torch.sin, ang)], -1)
        lens = lens * torch.sqrt(t2[..., 1]).unsqueeze(-1)
    else:
        lens = 2.0 * t2 - 1.0
    o = torch.cat([lens * st["circle_of_confusion"],
                   torch.zeros_like(lens[..., :1])], -1)
    fd = torch.tensor(st["focus_distance"], dtype=dtype, device=dev)
    focus = -d * (fd / d[..., 2:3])
    d = normalize(focus - o)

    def mat_vec(mat, v, w):
        cols = []
        for j in range(mat.shape[0]):
            acc = v[..., 0] * mat[j, 0]
            acc = acc + v[..., 1] * mat[j, 1]
            acc = acc + v[..., 2] * mat[j, 2]
            if w is not None:
                acc = acc + w * mat[j, 3]
            cols.append(acc)
        return torch.stack(cols, -1)

    oh = mat_vec(view, o, torch.ones_like(o[..., 0]))
    d = normalize(torch.cat([d[..., :2], d[..., 2:3] * oh[..., 3:4]], -1))
    return oh[..., :3], mat_vec(view[:3, :3], d, None), state


# --- trace -------------------------------------------------------------

def _face_eval(o, d, tri):
    """Moller-Trumbore with backface culling (render.ts:359-409):
    (neither culled nor outside, t)."""
    p0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    h = cross(d, e2)
    det = dot3(e1, h)
    s = o - p0
    u = dot3(s, h)
    q = cross(s, e1)
    v = dot3(d, q)
    t_num = dot3(e2, q)
    ok = (det >= EPS2) & (u >= 0.0) & (u <= det) & (v >= 0.0) & (
        u + v <= det)
    t = t_num / torch.where(ok, det, torch.ones_like(det))
    return ok, t


NO_HIT = torch.iinfo(torch.int64).max


def trace(scene, o, d, t_max, active, excl, any_hit=False):
    """Closest hit → (t, u, v, face), t_max and face -1 on a miss; with
    ``any_hit``, whether some face lies in (0, t_max). Inactive rays
    trace nothing. ``excl`` is the face each ray leaves through its
    two-sided duplicate (-1: none). The closest hit is the least
    (t, face) pair: t's float32 bits above the face index in one int64."""
    r = o.shape[0]
    dev = o.device
    t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    rr, gg = box_pairs(o, d, t_max, active, scene.box,
                       (scene.block_box, scene.box_padded))
    best = torch.full((r,), NO_HIT, dtype=torch.int64, device=dev)
    blocked = torch.zeros((r,), dtype=torch.bool, device=dev)
    for a in range(0, rr.shape[0], PAIR_CHUNK):
        ri, gi = rr[a:a + PAIR_CHUNK], gg[a:a + PAIR_CHUNK]
        faces = scene.group_faces[gi]  # (P, G)
        present = (faces >= 0) & (faces != excl[ri, None])
        ok, t = _face_eval(o[ri, None], d[ri, None],
                           scene.tri[faces.clamp(min=0)])
        valid = present & ok & (t > 0.0) & (t < t_max[ri, None])
        if any_hit:
            blocked[ri[valid.any(1)]] = True
            continue
        bits = t.float().view(torch.int32).to(torch.int64)
        key = torch.where(valid, (bits << 32) | faces,
                          torch.full_like(faces, NO_HIT))
        best.scatter_reduce_(0, ri, key.amin(1), "amin")
    if any_hit:
        return blocked
    hit = best != NO_HIT
    face = torch.where(hit, best & MASK, torch.full_like(best, -1))
    tri = scene.tri[face.clamp(min=0)]
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    h = cross(d, e2)
    det = dot3(e1, h)
    s = o - p0
    det = torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    q = cross(s, e1)
    zero = torch.zeros_like(t_max)
    return (torch.where(hit, dot3(e2, q) / det, t_max),
            torch.where(hit, dot3(s, h) / det, zero),
            torch.where(hit, dot3(d, q) / det, zero), face)


# --- shading -------------------------------------------------------------

def offset_ray(p, n):
    """render.ts:905-917 as written, both inverted selects included: a
    component that is exactly 0 with an offset of the other sign becomes
    a NaN origin (the integer step is taken on float32 bits)."""
    p32, n32 = p.float(), n.float()
    of_i = (256.0 * n32).to(torch.int32)
    p_i = p32.contiguous().view(torch.int32)
    p_int = (p_i + torch.where(p32 < 0.0, of_i, -of_i)).view(torch.float32)
    p_float = p + (1.0 / 65536.0) * n
    return torch.where(p.abs() < 1.0 / 32.0, p_int.to(p.dtype), p_float)


def face_point(tri, u, v):
    return (tri[..., 0:3] + tri[..., 3:6] * u.unsqueeze(-1)) + tri[
        ..., 6:9] * v.unsqueeze(-1)


def face_normal(shade, u, v, shading):
    if shading == "phong":
        w = (1.0 - u - v).unsqueeze(-1)
        return (shade[..., 3:6] * w + shade[..., 6:9] * u.unsqueeze(-1)) + \
            shade[..., 9:12] * v.unsqueeze(-1)
    return shade[..., 0:3]


def procedural_sky(d, dtype):
    """The port's clear-sky gradient and sun disc, with its contracted
    lerp, dot product and final add."""
    def vec(vals):
        return torch.tensor(vals, dtype=torch.float32, device=d.device)
    d = d.float()
    y = d[..., 1]
    tt = torch.clamp(y, 0.0, 1.0).unsqueeze(-1)
    sky = fma(vec([0.85, 0.80, 0.75]), 1.0 - tt,
              vec([0.25, 0.45, 0.85]) * tt, torch.float32)
    base = torch.where(y.unsqueeze(-1) < 0.0, vec([0.22, 0.2, 0.18]), sky)
    s = 0.5773503
    cosang = fma(d[..., 2], s, fma(d[..., 1], s, d[..., 0] * s,
                                   torch.float32), torch.float32)
    inv_ramp = float(np.float32(1.0) / np.float32(0.0005))
    sun = torch.clamp((cosang.unsqueeze(-1) - 0.9995) * inv_ramp, 0.0, 1.0)
    return fma(sun * 50.0, vec([1.0, 0.95, 0.9]), base, dtype)


def equirect_uv(d):
    u = (torch.atan2(d[..., 2], d[..., 0]) * INV_PI + 1.0) * 0.5
    v = 1.0 - torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * INV_PI
    return u, v


def texel(shape, d):
    h, w = shape
    u, v = equirect_uv(d)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return y, x


class Environment:
    """The environment of the frame: the procedural sky, or an (H, W, 3)
    equirect map, with its luminance sampling tables for env-IS (a
    marginal CDF over rows and a CDF per row of luminance x sin(theta),
    in float64, rounded to ``dtype``)."""

    def __init__(self, kind, img=None, importance=False,
                 dtype=torch.float32):
        self.kind, self.dtype = kind, dtype
        self.img = None if img is None else img.to(dtype)
        if not importance:
            return
        img32 = img.float()
        h, w = img.shape[0], img.shape[1]
        lum = (0.2126 * img32[..., 0] + 0.7152 * img32[..., 1]
               + 0.0722 * img32[..., 2]).double().clamp(min=1e-12)
        theta = math.pi * (1.0 - (torch.arange(
            h, dtype=torch.float64, device=img.device) + 0.5) / h)
        weighted = lum * torch.sin(theta).clamp(min=1e-6)[:, None]
        row_sum = weighted.sum(1)
        total = row_sum.sum()
        self.row_cdf = (torch.cumsum(row_sum, 0) / total).float()
        cond = (torch.cumsum(weighted, 1) / row_sum[:, None]).float()
        # each row's CDF offset by twice its row index: one sorted array
        rows2 = 2.0 * torch.arange(h, dtype=torch.float64,
                                   device=img.device)[:, None]
        self.cond_keyed = (cond.double() + rows2).reshape(-1)
        self.lum = lum.float().to(dtype)
        self.total = total.float().to(dtype)
        self.shape = (h, w)

    def radiance(self, d):
        if self.kind == "equirect":
            y, x = texel(self.img.shape[:2], d)
            return self.img[y, x]
        if self.kind == "procedural":
            return procedural_sky(d, self.dtype)
        if self.kind in ("white", "black"):
            v = 1.0 if self.kind == "white" else 0.0
            return torch.full(d.shape[:-1] + (3,), v, dtype=self.dtype,
                              device=d.device)
        raise NotImplementedError(f"environment {self.kind!r}")

    def _pdf(self, y, x):
        h, w = self.shape
        return self.lum[y, x] / self.total * float(h * w) / (
            2.0 * PI * PI)

    def sample(self, state):
        h, w = self.shape
        t2, state = random_2(state, self.dtype)
        u1, u2 = t2[..., 0].float(), t2[..., 1].float()
        row = torch.searchsorted(self.row_cdf, u1.contiguous(),
                                 side="left").clamp(max=h - 1)
        key = 2.0 * row.double() + u2.double()
        col = (torch.searchsorted(self.cond_keyed, key, side="left")
               - row * w).clamp(0, w - 1)
        vq = ((row.float() + 0.5) / h).to(self.dtype)
        uq = ((col.float() + 0.5) / w).to(self.dtype)
        theta = PI * (1.0 - vq)
        phi = uq * 2.0 * PI - PI
        sin_t = torch.sin(theta)
        d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                         sin_t * torch.sin(phi)], -1)
        return d, self.img[row, col], self._pdf(row, col), state

    def pdf(self, d):
        return self._pdf(*texel(self.shape, d))


def bsdf_pdf(d, n):
    return torch.clamp(dot3(d, normalize(n)), min=0.0) * INV_PI


def balance(a, b):
    return a / torch.clamp(a + b, min=1e-20)


# --- integrators -------------------------------------------------------

def direct_light(scene, point, normal, state, st, active, excl, dtype):
    """Light samples of model 0 with a shadow ray each (render.ts:849-869,
    1143-1157) → (colour, state)."""
    r = point.shape[0]
    color = torch.zeros((r, 3), dtype=dtype, device=point.device)
    for _ in range(st["samples_per_point"]):
        u1, state = random_1u(state)
        face = scene.light_offset + u1 % scene.light_count
        t2, state = random_2(state, dtype)
        u, v = sample_intriangle(t2)
        tri, shade = scene.tri[face], scene.shade[face]
        lp = offset_ray(face_point(tri, u, v), shade[..., 0:3])
        cr = cross(tri[..., 3:6], tri[..., 6:9])
        inv_pdf = torch.sqrt(dot3(cr, cr)) / 2.0 * float(scene.light_count)
        ds = lp - point
        d_sq = dot3(ds, ds)
        one = torch.ones((), dtype=dtype, device=point.device)
        dirn = ds * (one / torch.sqrt(torch.clamp(d_sq, min=1e-20))
                     ).unsqueeze(-1)
        t_max = torch.sqrt(torch.clamp(d_sq, min=0.0))
        shadowed = trace(scene, point, dirn, t_max, active, excl,
                         any_hit=True)
        vis = torch.where(shadowed, 0.0, 1.0).to(dtype)
        cosine = torch.clamp(dot3(dirn, normal), min=0.0)
        emission = scene.mat_emission[scene.material[face]]
        contrib = vis * cosine * inv_pdf / torch.clamp(d_sq, min=1e-20)
        color = color + emission * contrib.unsqueeze(-1)
    return color / float(st["samples_per_point"]), state


def path_trace(scene, env, o, d, t_max0, state, st, dtype):
    """pixelColor (render.ts:1167-1212), all lanes a segment at a time,
    with light NEE and env-IS under MIS → (colour, state, rays)."""
    r, dev = o.shape[0], o.device
    env_is = st["env_importance_sampling"]

    def full(v, *shape, dt=dtype):
        return torch.full(shape or (r,), v, dtype=dt, device=dev)

    color = full(0.0, r, 3)
    throughput = full(1.0, r, 3)
    alive = full(True, dt=torch.bool)
    rays = 0
    prev_bsdf_pdf = full(0.0)
    env_dir, env_w = full(0.0, r, 3), full(0.0, r, 3)
    env_mis_pdf = full(-1.0)
    excl = full(-1, dt=torch.int64)
    for seg in range(max(st["bounces_depth"] - 1, 0)):
        rays += int(alive.sum())
        t_max = t_max0 if seg == 0 else full(torch.finfo(dtype).max)
        _, hu, hv, face = trace(scene, o, d, t_max, alive, excl)
        miss = alive & (face < 0)
        env_dir = torch.where(miss.unsqueeze(-1), d, env_dir)
        env_w = torch.where(miss.unsqueeze(-1), throughput, env_w)
        if env_is and seg > 0:
            env_mis_pdf = torch.where(miss, prev_bsdf_pdf, env_mis_pdf)
        h = alive & (face >= 0)
        h3 = h.unsqueeze(-1)
        f = face.clamp(min=0)
        mat = scene.material[f]
        color = torch.where(h3, color + scene.mat_emission[mat] * throughput,
                            color)
        throughput = torch.where(h3, throughput * scene.mat_color[mat],
                                 throughput)
        tri, shade = scene.tri[f], scene.shade[f]
        n = face_normal(shade, hu, hv, st["shading_type"])
        new_o = offset_ray(face_point(tri, hu, hv), shade[..., 0:3])
        excl = torch.where(h, scene.partner[f], full(-1, dt=torch.int64))
        if st["next_event_estimation"]:
            nee, state = direct_light(scene, new_o, n, state, st, h, excl,
                                      dtype)
            color = torch.where(h3, color + nee * throughput, color)
            rays += int(h.sum()) * st["samples_per_point"]
        run_env = env_is and (st["env_nee_depth"] == 0
                              or seg < st["env_nee_depth"])
        if run_env:
            ed, erad, epdf, s_env = env.sample(state)
            state = torch.where(h, s_env, state)
            nn = normalize(n)
            facing = dot3(ed, nn) > 0.0
            blocked = trace(scene, new_o, ed, full(torch.finfo(dtype).max), h & facing,
                            excl, any_hit=True)
            vis = h & facing & ~blocked
            w_env = balance(epdf, bsdf_pdf(ed, n))
            contrib = throughput * erad * (
                torch.clamp(dot3(ed, nn), min=0.0) * INV_PI * w_env
                / torch.clamp(epdf, min=1e-20)).unsqueeze(-1)
            color = torch.where(vis.unsqueeze(-1), color + contrib, color)
            rays += int((h & facing).sum())
        t2, s2 = random_2(state, dtype)
        state = torch.where(h, s2, state)
        new_d = cosine_hemisphere(t2, n)
        if env_is:
            pv = bsdf_pdf(new_d, n) if run_env else full(-1.0)
            prev_bsdf_pdf = torch.where(h, pv, prev_bsdf_pdf)
        p = torch.amax(throughput, dim=-1)
        r1, s3 = random_1(state, dtype)
        state = torch.where(h, s3, state)
        survive = r1 <= p
        throughput = torch.where(
            (h & survive).unsqueeze(-1),
            throughput / torch.clamp(p, min=1e-20).unsqueeze(-1),
            throughput)
        alive = h & survive
        o = torch.where(alive.unsqueeze(-1), new_o, o)
        d = torch.where(alive.unsqueeze(-1), new_d, d)
    env_rad = env.radiance(env_dir)
    if env_is:
        w_bsdf = balance(torch.clamp(env_mis_pdf, min=0.0),
                         env.pdf(env_dir))
        env_rad = env_rad * torch.where(env_mis_pdf >= 0.0, w_bsdf,
                                        1.0).unsqueeze(-1)
    return color + env_rad * env_w, state, rays


def trace_direct(scene, env, o, d, t_max0, state, st, dtype):
    """The direct-lighting integrator (bounces_depth <= 1): the primary
    hit's emission and light NEE, the environment on a miss."""
    r, dev = o.shape[0], o.device
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    none = torch.full((r,), -1, dtype=torch.int64, device=dev)
    _, hu, hv, face = trace(scene, o, d, t_max0, active, none)
    found = face >= 0
    f3 = found.unsqueeze(-1)
    color = torch.where(f3, 0.0, env.radiance(d))
    f = face.clamp(min=0)
    mat = scene.material[f]
    tri, shade = scene.tri[f], scene.shade[f]
    n = face_normal(shade, hu, hv, st["shading_type"])
    point = offset_ray(face_point(tri, hu, hv), shade[..., 0:3])
    excl = torch.where(found, scene.partner[f], none)
    nee, state = direct_light(scene, point, n, state, st, found, excl,
                              dtype)
    color = torch.where(f3, scene.mat_emission[mat]
                        + scene.mat_color[mat] * nee, color)
    return color, state, r * (1 + st["samples_per_point"])


def render_samples(scene, env, st, view, seed, jitter=(0.0, 0.0),
                   dtype=torch.float32, rows=None):
    """One frame (render.ts:1434-1509) → ([colour of each sample] as
    (R, 3) float32, rays). ``rows`` (row0, row1) renders a slab of the
    image rows alone, with the pixel indices, and so the RNG streams, of
    the whole frame."""
    dev = scene.device
    w = st["width"]
    r0, r1 = rows or (0, st["height"])
    ys, xs = torch.meshgrid(
        torch.arange(r0, r1, dtype=torch.int64, device=dev),
        torch.arange(w, dtype=torch.int64, device=dev), indexing="ij")
    idx = (xs + ys * w).reshape(-1)
    base = torch.stack([xs, ys], -1).reshape(-1, 2).to(dtype) + torch.tensor(
        np.asarray(jitter, np.float32), dtype=dtype, device=dev)
    state = (idx + (int(seed) & MASK)) & MASK
    view = torch.as_tensor(view, dtype=dtype, device=dev)
    integrate = trace_direct if st["bounces_depth"] <= 1 else path_trace
    colors, rays = [], 0
    pos = base
    for k in range(1 + st["sample_count"]):
        if k:
            t2, state = random_2(state, dtype)
            pos = base + (2.0 * t2 - 1.0) * 0.5
        o, d, state = camera_rays(pos, view, state, st, dtype)
        t_max = torch.full((o.shape[0],), torch.finfo(dtype).max, dtype=dtype,
                           device=dev)
        c, state, n = integrate(scene, env, o, d, t_max, state, st, dtype)
        colors.append(c.float())
        rays += n
    return colors, rays


def render_frame(scene, env, st, view, seed, jitter=(0.0, 0.0),
                 dtype=torch.float32):
    """``render_samples`` over the whole frame, ROWS_PIXELS at a time so
    that the temporaries fit: the same colours and rays."""
    step = max(1, ROWS_PIXELS // st["width"])
    parts, rays = [], 0
    for r0 in range(0, st["height"], step):
        c, n = render_samples(scene, env, st, view, seed, jitter, dtype,
                              rows=(r0, min(r0 + step, st["height"])))
        parts.append(c)
        rays += n
    return [torch.cat([p[k] for p in parts])
            for k in range(len(parts[0]))], rays
