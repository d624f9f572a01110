"""PyTorch port: every tile orders itself in the kernel (``kernel_near``,
the port's default), on two-level tables too.

The twins of K3 / K3p ordering their supers themselves
(``trace_near_{closest,any,pairs}_two_level_tiles``) run here on the CPU and
must equal K3's, K3 any-hit's and K3p's over the order sorted outside, bit
for bit, and the JAX package's faces (the XLA clustered trace and the
Pallas two-level kernel under the interpreter, as
tests/test_torch_two_level.py runs them). The CUDA kernels are held against
these twins on the card (tests/test_torch_cuda.py).

The kernels' first half cannot run here, so a numpy model of it documents
the network that ``csrc/cluster_trace.cu`` implements, step for step (boxes
on the lanes with the minima taken on the floats' bits, the rays staged
by sign octant, the slab test without per-axis min / max from the octant and
each box's sorted axes, ballot compaction, 64-bit keys, the bitonic network
over the next power of two with its 64-key segments in "registers"), and is
held to ``_near_order``: ``tile_nears_fused`` and the stable sort. A second
model holds the slot scan that a warp's lanes share in the closest-hit
walks to the scan of one thread."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    rederive_uv as j_rederive_uv,
)
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu.ops.cluster_trace import trace_closest_clustered
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir
from webgpu_raytracing_tpu_torch.renderer import Renderer as TRenderer

torch.set_num_threads(1)

F32_MAX_BITS = 0x7F7FFFFF


def _cluster_scene(scene_mod, tm):
    """tests/test_two_level.py scene."""
    return scene_mod.scene_from_facesets(
        [
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


def _mini(scene_mod, tm):
    """tests/test_parity_ops.py golden scene (it has a light, for NEE)."""
    return scene_mod.scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


# cluster_size, group_size: G = 8 with a padded last super, and G = 16
LAYOUTS = {"g8": dict(cluster_size=4, group_size=8),
           "g16": dict(cluster_size=8, group_size=16)}


@pytest.fixture(scope="module")
def tables():
    return {k: _cluster_scene(tscene, ttm).tables("cpu", **kw)
            for k, kw in LAYOUTS.items()}


def _mixed_rays(n_codes, n=3072, seed=5):
    """Rays from a numpy seed: random ones with NaN origins, finite and
    unbounded t_max and exclusion codes; a tile of rays along the axes; a
    whole inactive tile; a tile that looks away from the scene and enters
    no super; a tail that pads the last tile."""
    rng = np.random.default_rng(seed)
    n += 70
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    axes = np.eye(3, dtype=np.float32)
    d[128:256] = np.concatenate([axes, -axes])[rng.integers(0, 6, 128)]
    o[128:160] = np.float32([0.0, 0.0, 2.0])  # down the sphere's axis
    active = rng.uniform(size=n) > 0.1
    active[256:384] = False
    o[384:512] = np.float32([0.0, 50.0, 0.0]) + o[384:512]
    d[384:512] = np.abs(d[384:512]) * np.float32([1, 1, 1])  # up and away
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    excl = rng.integers(-1, n_codes, n).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (o, d, tmax, active, excl))


def _prep(tt, **kw):
    o, d, tmax, active, excl = _mixed_rays(tt.clusters.face_id.numel())
    return cc.prepare_tiles(o, d, tmax, tt, active, excl, **kw)


def _bits_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


# --- (a) the new twins against K3, K3 any-hit and K3p over the outside order


KINDS = {
    "closest": (cc.trace_closest_args, cc.trace_near_closest_two_level_tiles,
                cc.trace_closest_two_level_tiles, False),
    "any": (cc.trace_any_args, cc.trace_near_any_two_level_tiles,
            cc.trace_any_two_level_tiles, False),
    "pairs": (cc.trace_pairs_args, cc.trace_near_pairs_two_level_tiles,
              cc.trace_pairs_two_level_tiles, True),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_near_two_level_twin_equals_outside_order(tables, kind, layout):
    """(t, code), the any-hit codes and the five pairs outputs of the
    entries that order their supers themselves equal those of K3, K3
    any-hit and K3p over the order sorted outside, exactly; their dict
    carries the super boxes and no entry distances and no order; their
    work counts add one slab test per ray and super and no table step."""
    select, near_wrapper, wrapper, pairs = KINDS[kind]
    tt = tables[layout]
    ct = tt.clusters
    assert cc.is_two_level(ct) and ct.group == LAYOUTS[layout]["group_size"]
    outside = _prep(tt, pairs=pairs)
    near = _prep(tt, pairs=pairs, near="kernel")
    assert outside.variant == "two_level" and near.variant == "near_two_level"
    assert select(outside)[0] is wrapper and select(near)[0] is near_wrapper
    assert "snear" not in near and "order" not in near
    assert near["super_box"].shape == (ct.box.shape[0] // ct.group, 6)
    assert near["group"] == ct.group and "pipelined" not in near
    s_out, s_near = {}, {}
    want = select(outside)[1](**outside, stats=s_out)
    got = select(near)[1](**near, stats=s_near)
    _bits_equal(got, want)
    _bits_equal(near_wrapper(**near), wrapper(**outside))
    code = got if kind == "any" else got[1]
    assert (code >= 0).sum() > 300
    live = outside["t_max"] > 0
    assert (code[~live] < 0).all()
    assert (code[384:512] < 0).all()  # the tile that enters no super
    assert near_wrapper.launches == 0  # CPU: the twin
    r, c2 = near["t_max"].shape[0], near["super_box"].shape[0]
    w_out = cc.walk_stats(s_out, ct.face_id, kind == "any", pairs)
    w_near = cc.walk_stats(s_near, ct.face_id, kind == "any", pairs)
    assert s_near["near_box_tests"] == r * c2 and s_near["table_steps"] == 0
    assert w_near["box_tests"] == w_out["box_tests"] + r * c2
    assert w_near["slot_tests"] == w_out["slot_tests"]
    assert w_near["bytes"] == (w_out["bytes"] - 8 * s_out["table_steps"]
                               + 24 * c2)


def test_last_super_is_padded_and_pads_are_never_walked(tables):
    """The g8 layout's last super has pad children (inverted-empty boxes,
    no faces): they keep F32_MAX in the child order and no code names
    them."""
    ct = tables["g8"].clusters
    full = ct.face_id[:, 0] >= 0
    assert not bool(full[-1]) and bool(full[-ct.group])
    near = _prep(tables["g8"], near="kernel")
    _, code = cc.trace_near_closest_two_level_tiles(**near)
    hit_clusters = torch.unique(code[code >= 0] // ct.face_id.shape[1])
    assert bool(full[hit_clusters.long()].all())


# --- (b) against the JAX package ------------------------------------------


def _rays(seed, n, z_band):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    if z_band:
        o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def jax_tables():
    kw = LAYOUTS["g16"]
    return (_cluster_scene(jscene, jtm).tables(**kw),
            _cluster_scene(tscene, ttm).tables("cpu", **kw))


@pytest.mark.parametrize("name", ["band_384", "masked_256"])
def test_near_two_level_matches_jax(jax_tables, name):
    """Through the dispatcher with ``kernel_near`` on two-level tables:
    face ids identical to the XLA clustered trace (exact f32) and to the
    Pallas two-level kernel under the interpreter; the Hit after
    ``rederive_uv`` bit-equal to JAX's."""
    jt2, tt2 = jax_tables
    if name == "band_384":
        (o, d), active = _rays(7, 384, True), None
    else:
        o, d = _rays(43, 256, True)
        rng = np.random.default_rng(44)
        o[rng.uniform(size=256) < 0.1, rng.integers(0, 3)] = np.nan
        active = rng.uniform(size=256) > 0.3
    tmax = np.full((o.shape[0],), F32_MAX, np.float32)
    t_act = None if active is None else torch.from_numpy(active)
    got = cc.trace_closest_clustered_cuda(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax),
        tt2, t_act, kernel_near=True)
    gf = got.face.numpy()
    ja = None if active is None else jnp.asarray(active)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    clustered = trace_closest_clustered(*jargs, jt2, ja, tile=128)
    pallas = trace_closest_clustered_pallas(
        *jargs, jt2, ja, tile=128, interpret=True, exact_pairs=False)
    for ref in (clustered, pallas):
        np.testing.assert_array_equal(gf, np.asarray(ref.face))
    assert (gf >= 0).sum() > 50
    if active is not None:
        assert (gf[~active] < 0).all()
    jr = j_rederive_uv(jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(got.t.numpy()), jnp.asarray(gf), jt2)
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(jr, k)), err_msg=k)


# --- (c) frames -------------------------------------------------------------


FRAME = dict(width=16, height=16, bounces_depth=3, sample_count=1,
             environment="procedural")


@pytest.mark.parametrize("kw", [
    dict(), dict(next_event_estimation=True),
    dict(exact_pairs=True, exact_pairs_bounce=True),
    dict(sort_bounce_rays=True, next_event_estimation=True),
], ids=["default", "nee", "exact", "sorted_nee"])
def test_two_level_frames_equal_the_outside_order(kw):
    """Two frames on two-level tables with ``kernel_near`` (the default)
    equal the ``kernel_near=False`` frames: RMSE 0, bit for bit."""
    def run(near):
        st = TSettings(**FRAME, **kw).replace(kernel_near=near)
        r = TRenderer(_mini(tscene, ttm), st, base_seed=13, device="cpu")
        r.tables = _mini(tscene, ttm).tables("cpu", cluster_size=16,
                                             group_size=4)
        assert cc.is_two_level(r.tables.clusters)
        r.step()
        r.step()
        return r.buffers.image.numpy()

    assert TSettings().kernel_near is True
    got, want = run(True), run(False)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert float(np.sqrt(np.mean((got - want)[~nan] ** 2))) == 0.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[..., 3] == 4.0).all()


def test_default_frame_routes_through_the_in_kernel_order(monkeypatch):
    """A default frame calls ``tile_nears_fused`` only inside the twins of
    the kernels that order their own tiles (on the card: never), on both
    kinds of tables."""
    seen = []
    real = cc.prepare_tiles

    def spy(*a, **k):
        args = real(*a, **k)
        seen.append(args.variant)
        assert "snear" not in args
        return args

    monkeypatch.setattr(cc, "prepare_tiles", spy)
    for group, variant in ((0, "near"), (4, "near_two_level")):
        seen.clear()
        r = TRenderer(_mini(tscene, ttm),
                      TSettings(**FRAME, next_event_estimation=True),
                      base_seed=3, device="cpu")
        r.tables = _mini(tscene, ttm).tables("cpu", cluster_size=16,
                                             group_size=group)
        r.step()
        assert seen and set(seen) == {variant}


# --- (d) what raises, and what the dict holds -----------------------------


def test_prepare_tiles_two_level_near_limits(tables):
    tt = tables["g8"]
    o, d, tmax, active, excl = _mixed_rays(tt.clusters.face_id.numel(), n=256)
    rays = (o, d, tmax, tt)
    r = o.shape[0]
    # K5 and K2pl stay single-level, with or without the in-kernel order
    for kw in (dict(sched_rounds=4), dict(pipelined=True),
               dict(near="kernel", pipelined=True),
               dict(near="kernel", sched_rounds=4)):
        with pytest.raises(ValueError):
            cc.prepare_tiles(*rays, **kw)
    # the drain hooks stay single-level
    ts = torch.zeros(r)
    code = torch.full((r,), -1, dtype=torch.int32)
    for kw in (dict(t_start=ts), dict(start_code=code), dict(cap=2),
               dict(return_stop=True)):
        for near in ("outside", "kernel"):
            with pytest.raises(ValueError):
                cc.prepare_tiles(*rays, near=near, **kw)
        with pytest.raises(ValueError):
            cc.trace_closest_clustered_cuda(o, d, tmax, tt, kernel_near=True,
                                            **kw)
    with pytest.raises(ValueError):
        cc.trace_any_clustered_cuda(o, d, tmax, tt, kernel_near=True,
                                    t_start=ts)
    # more supers than a block orders: the kernel's real limit
    ct = tt.clusters
    many = cc.NEAR_MAX_CLUSTERS + 1
    import dataclasses
    big = dataclasses.replace(tt, clusters=dataclasses.replace(
        ct, super_box=ct.super_box[:1].repeat(many, 1),
        child_box_t=ct.child_box_t[:1].repeat(many, 1, 1),
        box=ct.box[:1].repeat(many * ct.group, 1),
        face_id=ct.face_id[:1].repeat(many * ct.group, 1),
        mat_b=ct.mat_b[:1].expand(many * ct.group, -1, -1)))
    with pytest.raises(ValueError, match=str(cc.NEAR_MAX_CLUSTERS)):
        cc.prepare_tiles(o, d, tmax, big, near="kernel")
    # the launchers: CPU tensors never reach a kernel; the tile is bounded
    near = cc.prepare_tiles(*rays, near="kernel")
    with pytest.raises(ValueError):
        cc._launch_near_two_level(**near)
    with pytest.raises(ValueError, match="multiple of 32"):
        cc._check_walk(256, near["inv_d"][:256], near["t_max"][:256],
                       near["excl"][:256], None, None, near["box"],
                       near["face_id"], 256, near["group"], 9,
                       super_box=near["super_box"])
    assert cc.near_order_bytes(643, 128, True) == 8 * 1024 + 4096 + 12288
    assert cc.near_order_bytes(227, 128, False) == 8 * 256 + 6144
    assert cc.near_order_bytes(3, 32, True) == 8 * 64 + 1024 + 3072


# --- (e) the first half, modelled -----------------------------------------


def _sorted_box(box):
    """``sorted_box``: each axis sorted, NaN kept."""
    lo, hi = box[:, 0:3], box[:, 3:6]
    return np.minimum(lo, hi), np.maximum(lo, hi)


def _stage_rays(inv_d):
    """``stage_rays``: the tile's rays grouped by the sign octant of inv_d
    (NaN and -0 count as "up"), a counting sort that keeps the thread order
    inside an octant → (the ray in each place, the octant of each place)."""
    oct_ = ((inv_d[:, 0] < 0).astype(np.int64)
            | ((inv_d[:, 1] < 0).astype(np.int64) << 1)
            | ((inv_d[:, 2] < 0).astype(np.int64) << 2))
    place = np.argsort(oct_, kind="stable")
    return place, oct_[place]


def _model_minima(o, inv_d, tmax, ts, box, r0=0, r1=None):
    """The pass of one tile over the rays in places [r0, r1) of the stage:
    thread ``tid`` owns boxes tid, tid + T, ...; the rays come octant by
    octant, the near and far products are picked by the octant from the
    sorted box, combined with NaN-propagating max / min, and the entry's
    bits go into an integer minimum → (N,) uint32."""
    lo, hi = _sorted_box(box)
    m = np.full(box.shape[0], F32_MAX_BITS, np.uint32)
    place, octs = _stage_rays(inv_d)
    r1 = len(place) if r1 is None else r1
    with np.errstate(all="ignore"):
        for at in range(r0, r1):
            i = place[at]
            neg = np.array([octs[at] & 1, octs[at] & 2, octs[at] & 4], bool)
            near_c = np.where(neg[None, :], hi, lo)
            far_c = np.where(neg[None, :], lo, hi)
            n3 = (near_c - o[i][None, :]) * inv_d[i][None, :]
            f3 = (far_c - o[i][None, :]) * inv_d[i][None, :]
            near = np.maximum(np.maximum(n3[:, 0], n3[:, 1]), n3[:, 2])
            far = np.minimum(np.minimum(f3[:, 0], f3[:, 1]), f3[:, 2])
            # max(near, 0) with -0 made +0, on the bits (``entry_of``)
            entry = np.maximum(near.view(np.int32), 0).view(np.float32)
            ok = (entry < far) & (near < tmax[i]) & (entry >= ts[i])
            bits = np.where(ok, entry.view(np.uint32), F32_MAX_BITS)
            m = np.minimum(m, bits.astype(np.uint32))
    return m


def _tail64(a, b, k, base):
    """``bitonic_tail64``: step k on one 64-key segment, two keys a lane."""
    lane = np.arange(32)
    up_a = ((base + lane) & k) == 0
    up_b = ((base + 32 + lane) & k) == 0
    j = k >> 1
    if j >= 32:
        swap = (a > b) == up_a
        a, b = np.where(swap, b, a), np.where(swap, a, b)
        j = 16
    while j >= 1:
        oa, ob = a[lane ^ j], b[lane ^ j]
        low = (lane & j) == 0
        a = np.where(low == up_a, np.minimum(a, oa), np.maximum(a, oa))
        b = np.where(low == up_b, np.minimum(b, ob), np.maximum(b, ob))
        j >>= 1
    return a, b


def _block_sort(key):
    """``block_sort``: the bitonic network over P = len(key) keys."""
    p = key.shape[0]
    key = key.copy()

    def tails(ks):
        for base in range(0, p, 64):
            a, b = key[base:base + 32].copy(), key[base + 32:base + 64].copy()
            for k in ks:
                a, b = _tail64(a, b, k, base)
            key[base:base + 32], key[base + 32:base + 64] = a, b

    tails((2, 4, 8, 16, 32, 64))
    k = 128
    while k <= p:
        j = k >> 1
        while j >= 64:
            t = np.arange(p >> 1)
            i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            x, y = key[i], key[i + j]
            swap = (x > y) == ((i & k) == 0)
            key[i] = np.where(swap, y, x)
            key[i + j] = np.where(swap, x, y)
            j >>= 1
        tails((k,))
        k <<= 1
    return key


BOX_ROWS = 4  # kNearRows: the rows of boxes a thread holds at a time


def _model_order(o, inv_d, tmax, ts, box, tile, rng):
    """``tile_order`` for one tile → (n, sorted keys[:n]): the rows of boxes
    in the fewest groups of at most four, as even as they go; after each
    group every warp appends its entered boxes by ballot (the warps in an
    arbitrary order: one atomicAdd each); a last row that is at most half
    full is split over the threads instead, T // tail threads a box, each on
    its part of the places of the ray stage, the parts' minima merged before
    the ballot; pad to the next power of two >= 64; sort."""
    n_boxes = box.shape[0]
    m = _model_minima(o, inv_d, tmax, ts, box)
    keys = []
    tail = n_boxes % tile if n_boxes % tile <= tile // 2 else 0
    whole = n_boxes - tail
    if tail:
        parts = tile // tail
        per = -(-tile // parts)
        part_min = np.stack([
            _model_minima(o, inv_d, tmax, ts, box[whole:], p * per,
                          min(tile, (p + 1) * per))
            for p in range(parts)])
        assert parts * per >= tile
        np.testing.assert_array_equal(part_min.min(axis=0), m[whole:])
    rows = -(-whole // tile)
    groups = -(-rows // BOX_ROWS)
    row = 0
    for g in range(groups):
        kb = -(-(rows - row) // (groups - g))
        assert 1 <= kb <= BOX_ROWS
        for warp in rng.permutation(tile // 32):
            for b in range(kb):
                for lane in range(32):
                    c = (row + b) * tile + warp * 32 + lane
                    if c < whole and m[c] != F32_MAX_BITS:
                        keys.append((int(m[c]) << 32) | c)
        row += kb
    assert row == rows
    for c in range(whole, n_boxes):
        if m[c] != F32_MAX_BITS:
            keys.append((int(m[c]) << 32) | c)
    n = len(keys)
    p = 64
    while p < n:
        p <<= 1
    key = np.array(keys + [2**64 - 1] * (p - n), dtype=np.uint64)
    return n, _block_sort(key)[:n]


def _boxes(rng, n):
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    h = rng.uniform(0.05, 1.5, (n, 3)).astype(np.float32)
    box = np.concatenate([c - h, c + h], axis=1)
    box[::7] = box[1]  # equal boxes: ties on the distance
    big = np.float32(F32_MAX)
    box[3::11] = np.float32([big] * 3 + [-big] * 3)  # inverted-empty pads
    return box


ORDER_CASES = {
    "n5": dict(n=5), "n64": dict(n=64), "n65": dict(n=65),
    "n130_t32": dict(n=130, tile=32), "n643": dict(n=643),
    "n1030_t64": dict(n=1030, tile=64),
    "t_start": dict(n=300, t_start="rand"),
    "t_start_nan": dict(n=200, t_start="nan"),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_first_half_model_equals_near_order(case):
    """The model's distances and order equal ``_near_order`` (the plain
    twin's ``tile_nears_fused`` + stable sort) bit for bit: with ties
    (equal boxes), origins inside boxes (entry -0 / +0), rays along the
    axes with infinite, huge and zero reciprocals, NaN origins, inactive
    rays, inverted-empty boxes, N not a power of two and not a multiple of
    the tile, and ``t_start`` masks (NaN too)."""
    spec = ORDER_CASES[case]
    n, tile = spec["n"], spec.get("tile", 128)
    rng = np.random.default_rng(n)
    box = _boxes(rng, n)
    r = 2 * tile
    o = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[:24] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)[
        rng.integers(0, 6, 24)]
    o[0:6] = box[1, 0:3]  # on a box's corner planes: products of 0
    o[30:34] = np.nan
    inv_d = safe_inv_dir(torch.from_numpy(d)).numpy()
    inv_d[6:12][d[6:12] == 0] = np.inf   # a caller's own reciprocals
    inv_d[12:18][d[12:18] == 0] = -np.inf
    inv_d[18:21][d[18:21] == 0] = 0.0
    inv_d[21:24][d[21:24] == 0] = -0.0
    tmax = np.where(rng.uniform(size=r) < 0.5, F32_MAX,
                    rng.uniform(0.0, 6.0, r)).astype(np.float32)
    tmax[40:50] = 0.0  # inactive lanes
    ts = None
    if spec.get("t_start") == "rand":
        ts = rng.uniform(0, 3, r).astype(np.float32)
        ts[::5] = 0.0
    elif spec.get("t_start") == "nan":
        ts = rng.uniform(0, 1, r).astype(np.float32)
        ts[::3] = np.nan
    snear, order = cc._near_order(
        torch.from_numpy(o), torch.from_numpy(inv_d), torch.from_numpy(tmax),
        torch.from_numpy(box), tile, None,
        None if ts is None else torch.from_numpy(ts))
    snear = (snear + 0.0).numpy().view(np.uint32)  # -0 → +0, as the kernel
    order = order.numpy()
    ts_model = np.zeros(r, np.float32) if ts is None else ts
    entered_any = 0
    for t in range(r // tile):
        sl = slice(t * tile, (t + 1) * tile)
        count, key = _model_order(o[sl], inv_d[sl], tmax[sl], ts_model[sl],
                                  box, tile, rng)
        want_n = int((snear[t] != F32_MAX_BITS).sum())
        assert count == want_n
        np.testing.assert_array_equal((key >> np.uint64(32)).astype(np.uint32),
                                      snear[t, :count])
        np.testing.assert_array_equal(
            (key & np.uint64(0xFFFFFFFF)).astype(np.int32), order[t, :count])
        entered_any += count
        if count > 1:  # ties are there, and resolved by the box index
            dist = snear[t, :count]
            tied = dist[1:] == dist[:-1]
            assert (order[t, :count][1:][tied]
                    > order[t, :count][:-1][tied]).all()
    assert entered_any > (0 if spec.get("t_start") == "nan" else n // 4)


@pytest.mark.parametrize("p", [64, 128, 256, 1024, 4096])
def test_block_sort_model_sorts(p):
    """The network itself, at every size a tile can need: distinct keys
    and the ~0 pads come out ascending."""
    rng = np.random.default_rng(p)
    key = rng.integers(0, 2**63, p, dtype=np.uint64)
    key[rng.uniform(size=p) < 0.2] = np.uint64(2**64 - 1)
    np.testing.assert_array_equal(_block_sort(key), np.sort(key))


# --- (f) the shared slot scan of the closest-hit walks, modelled ------------


def _take(t, code, best, best_code):
    """K1's rule: a candidate replaces the best on a smaller t, or on an
    equal t with a smaller code."""
    if t < best or (t == best and code < best_code):
        return t, code
    return best, best_code


def _scan_sequential(t, code, valid, best, best_code):
    """One thread over the slots in order (``Exact::scan``)."""
    for s in range(len(t)):
        if valid[s]:
            best, best_code = _take(t[s], code[s], best, best_code)
    return best, best_code


def _scan_shared(t, code, valid, best, best_code):
    """``coop_test``: lane l takes the slots l, l + 32, ... from the owner's
    own (best, code); a butterfly over the 32 lanes takes the
    lexicographic minimum, and every lane ends with the same pair."""
    lanes = []
    for lane in range(32):
        b, c = best, best_code
        for s in range(lane, len(t), 32):
            if valid[s]:
                b, c = _take(t[s], code[s], b, c)
        lanes.append((b, c))
    off = 16
    while off >= 1:
        lanes = [_take(*lanes[lane ^ off], *lanes[lane]) for lane in range(32)]
        off >>= 1
    assert len(set(lanes)) == 1
    return lanes[0]


@pytest.mark.parametrize("slots", [5, 32, 100, 128])
@pytest.mark.parametrize("start", ["miss", "carried_low", "carried_high"])
def test_shared_slot_scan_model_equals_sequential(slots, start):
    """The warp-shared scan of the closest-hit walks returns the sequential
    scan's (t, code): with equal t on several slots (the lower code wins),
    a best carried in at a t some slot equals (the carried code wins only
    when it is lower), and clusters with no valid slot."""
    rng = np.random.default_rng(slots)
    for trial in range(40):
        t = rng.choice(np.float32([0.5, 1.0, 1.0, 2.0, 3.5]), slots)
        code = 7 * slots + np.arange(slots)
        valid = rng.uniform(size=slots) < (0.0 if trial == 0 else 0.3)
        best = np.float32(1.0 if trial % 2 else 3.0e38)
        best_code = {"miss": -1, "carried_low": 3,
                     "carried_high": 10**6}[start]
        assert (_scan_shared(t, code, valid, best, best_code)
                == _scan_sequential(t, code, valid, best, best_code))
