"""PyTorch port on an NVIDIA GPU: the CUDA kernel against its plain-torch
twin, and a whole frame against the JAX package's golden. Needs a CUDA
device (``cuda`` marker; skips without one).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX.)"""

import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from webgpu_raytracing_tpu_torch.camera import Camera
from webgpu_raytracing_tpu_torch.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.models.test_models import (
    ground_plane,
    unit_cube_model,
    uv_sphere,
)
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import rng as trng
from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays
from webgpu_raytracing_tpu_torch.renderer import Renderer

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mini_scene_2f.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_kernel_matches_twin_on_card(cuda):
    """Random rays with inactive lanes, finite t_max, NaN origins and
    exclusion codes: kernel and twin give the same codes and t bits."""
    scene = scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )
    tables = scene.tables(cuda)
    n = 5000
    rng = np.random.default_rng(18)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = rng.integers(-1, tables.clusters.face_id.numel(), n)

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    args = cc.prepare_tiles(
        t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32)
    )
    before = cc.trace_closest_tiles.launches
    t_k, c_k = cc.trace_closest_tiles(**args)
    torch.cuda.synchronize()
    assert cc.trace_closest_tiles.launches == before + 1
    t_w, c_w = cc.trace_closest_tiles.twin(**args)
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_w.cpu().numpy())
    np.testing.assert_array_equal(
        t_k.cpu().numpy().view(np.int32), t_w.cpu().numpy().view(np.int32)
    )
    assert (c_k >= 0).sum() > 100

    # the any-hit entry on the same shadow-like set
    before = cc.trace_any_tiles.launches
    a_k = cc.trace_any_tiles(**args)
    torch.cuda.synchronize()
    assert cc.trace_any_tiles.launches == before + 1
    a_w = cc.trace_any_tiles.twin(**args)
    np.testing.assert_array_equal(a_k.cpu().numpy(), a_w.cpu().numpy())
    assert 100 < int((a_k >= 0).sum()) < n - 100


def _mixed_rays(n, seed, rng_face_count):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = rng.integers(-1, rng_face_count, n)
    return o, d, tmax, active, excl


@pytest.mark.parametrize("which", ["g4", "g64"])
def test_two_level_kernels_match_twins_on_card(cuda, which):
    """K3, both entries, against its twins on random rays with inactive
    lanes, finite t_max, NaN origins and exclusion codes: the same codes
    and t bits; and the same faces and flags as K1 over all cluster
    boxes of the same tables. ``g4``: the small scene with S = 16, G = 4;
    ``g64``: a 4,588-face stress scene with S = 2, where the automatic
    rule picks G = 64."""
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    if which == "g4":
        tables = scene_from_facesets(
            [
                ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
                ("plane", ground_plane(-1.5, 8.0)),
                ("cube", unit_cube_model()),
            ],
            np.ones((1, 3), np.float32) * 0.8,
            np.zeros((1, 3), np.float32),
        ).tables(cuda, cluster_size=16, group_size=4)
    else:
        tables = stress_scene(5000).tables(cuda, cluster_size=2)
    ct = tables.clusters
    assert cc.is_two_level(ct) and ct.group == (4 if which == "g4" else 64)
    o, d, tmax, active, excl = _mixed_rays(5000, 31, ct.face_id.numel())
    if which == "g64":  # look down at the sphere grid
        o = o * 4.0 + np.array([0.0, 12.0, 0.0], np.float32)
        d[:, 1] = -np.abs(d[:, 1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    ins = (t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32))
    a2 = cc.prepare_tiles(*ins)
    a1 = cc.prepare_tiles(*ins, two_level=False)
    assert a2["group"] == ct.group
    before = (cc.trace_closest_two_level_tiles.launches,
              cc.trace_any_two_level_tiles.launches)
    t_k, c_k = cc.trace_closest_two_level_tiles(**a2)
    a_k = cc.trace_any_two_level_tiles(**a2)
    torch.cuda.synchronize()
    assert (cc.trace_closest_two_level_tiles.launches,
            cc.trace_any_two_level_tiles.launches) == (before[0] + 1,
                                                       before[1] + 1)
    t_w, c_w = cc.trace_closest_two_level_tiles.twin(**a2)
    a_w = cc.trace_any_two_level_tiles.twin(**a2)
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_w.cpu().numpy())
    np.testing.assert_array_equal(
        t_k.cpu().numpy().view(np.int32), t_w.cpu().numpy().view(np.int32)
    )
    np.testing.assert_array_equal(a_k.cpu().numpy(), a_w.cpu().numpy())
    assert (c_k >= 0).sum() > 100
    assert 100 < int((a_k >= 0).sum()) < o.shape[0] - 100
    # K1 on the same tables: the same faces and flags
    t_1, c_1 = cc.trace_closest_tiles(**a1)
    np.testing.assert_array_equal(c_1.cpu().numpy(), c_k.cpu().numpy())
    np.testing.assert_array_equal(
        (cc.trace_any_tiles(**a1) >= 0).cpu().numpy(),
        (a_k >= 0).cpu().numpy(),
    )
    # K3 ordering its supers itself: its twins' and K3's outputs, bit for bit
    near = cc.prepare_tiles(*ins, near="kernel")
    assert near.variant == "near_two_level" and "snear" not in near
    for wrapper, ref in (
        (cc.trace_near_closest_two_level_tiles, (t_k, c_k)),
        (cc.trace_near_any_two_level_tiles, a_k),
    ):
        before = wrapper.launches
        got = wrapper(**near)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _assert_same(got, wrapper.twin(**near))
        _assert_same(got, ref)


@pytest.mark.parametrize("which", ["single", "g4", "g64"])
def test_pairs_kernels_match_twins_on_card(cuda, which):
    """K2p (single-level) and K3p (two-level) against their twins on random
    rays with inactive lanes, finite t_max, NaN origins and exclusion
    codes: t1, the three codes and the flag agree bit for bit; after the
    exact adjudication, the faces equal K1's on the same rays."""
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    if which == "g64":
        tables = stress_scene(5000).tables(cuda, cluster_size=2)
    else:
        scene = scene_from_facesets(
            [
                ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
                ("plane", ground_plane(-1.5, 8.0)),
                ("cube", unit_cube_model()),
            ],
            np.ones((1, 3), np.float32) * 0.8,
            np.zeros((1, 3), np.float32),
        )
        kw = dict(cluster_size=16, group_size=4) if which == "g4" else {}
        tables = scene.tables(cuda, **kw)
    ct = tables.clusters
    assert cc.is_two_level(ct) == (which != "single")
    o, d, tmax, active, excl = _mixed_rays(5000, 37, ct.face_id.numel())
    if which == "g64":  # look down at the sphere grid
        o = o * 4.0 + np.array([0.0, 12.0, 0.0], np.float32)
        d[:, 1] = -np.abs(d[:, 1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    ins = (t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32))
    args = cc.prepare_tiles(*ins, pairs=True)
    wrapper, twin = cc.trace_pairs_args(args)
    assert wrapper is (cc.trace_pairs_tiles if which == "single"
                       else cc.trace_pairs_two_level_tiles)
    before = wrapper.launches
    got = wrapper(**args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = twin(**args)
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.int32),
                                  want[0].cpu().numpy().view(np.int32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert (got[1] >= 0).sum() > 100
    exact = cc.trace_closest_clustered_cuda(*ins, exact_pairs=True)
    plain = cc.trace_closest_clustered_cuda(*ins)
    np.testing.assert_array_equal(exact.face.cpu().numpy(),
                                  plain.face.cpu().numpy())
    # the entry that orders its own tiles (K2n; K3p over its supers)
    near = cc.prepare_tiles(*ins, pairs=True, near="kernel")
    near_wrapper = cc.trace_pairs_args(near)[0]
    assert near_wrapper is (cc.trace_near_pairs_tiles if which == "single"
                            else cc.trace_near_pairs_two_level_tiles)
    before = near_wrapper.launches
    got_near = near_wrapper(**near)
    torch.cuda.synchronize()
    assert near_wrapper.launches == before + 1
    _assert_same(got_near, near_wrapper.twin(**near))
    _assert_same(got_near, got)


def _small_scene():
    return scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


def _padded_clusters(tables, n_clusters):
    """The tables with empty clusters (inverted boxes, no faces, zero
    matrices) appended up to ``n_clusters``."""
    import dataclasses

    ct = tables.clusters
    extra = n_clusters - ct.box.shape[0]
    assert extra >= 0 and ct.super_box is None
    dev = ct.box.device
    big = torch.finfo(torch.float32).max
    empty = torch.tensor([big] * 3 + [-big] * 3, device=dev).repeat(extra, 1)
    return dataclasses.replace(tables, clusters=dataclasses.replace(
        ct,
        box=torch.cat([ct.box, empty]),
        face_id=torch.cat([ct.face_id, torch.full(
            (extra, ct.face_id.shape[1]), -1, dtype=torch.int32,
            device=dev)]),
        mat_b=torch.cat([ct.mat_b, torch.zeros(
            (extra,) + ct.mat_b.shape[1:], device=dev)]),
    ))


def _assert_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["s16", "s128", "s2"])
def test_sched_near_pipelined_kernels_match_twins_on_card(cuda, which):
    """K5 (rounds of 1, 2, 4 and 8 clusters), K2n and K2pl (closest-hit,
    any-hit and pairs; K2n also pipelined) against their twins and against
    K1 / K2p on the same rays, bit for bit: random rays with inactive
    lanes, finite t_max, NaN origins and exclusion codes. ``s16``: the
    small scene in clusters of 16; ``s128``: in clusters of 128 (K5's
    largest staging buffers); ``s2``: a 4,588-face stress scene in 2,294
    clusters of 2, seen from above."""
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    if which == "s2":
        tables = stress_scene(5000).tables(cuda, cluster_size=2, group_size=0)
    else:
        tables = _small_scene().tables(
            cuda, cluster_size=16 if which == "s16" else 128, group_size=0)
    ct = tables.clusters
    assert not cc.is_two_level(ct)
    o, d, tmax, active, excl = _mixed_rays(5000, 41, ct.face_id.numel())
    if which == "s2":
        o = o * 4.0 + np.array([0.0, 12.0, 0.0], np.float32)
        d[:, 1] = -np.abs(d[:, 1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    ins = (t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32))
    k1 = cc.prepare_tiles(*ins)
    ref_closest = cc.trace_closest_tiles(**k1)
    ref_any = cc.trace_any_tiles(**k1)
    k2p = cc.prepare_tiles(*ins, pairs=True)
    ref_pairs = cc.trace_pairs_tiles(**k2p)
    assert (ref_closest[1] >= 0).sum() > 100

    def check(selector, args, ref, wrapper):
        w, twin = selector(args)
        assert w is wrapper
        before = w.launches
        got = w(**args)
        torch.cuda.synchronize()
        assert w.launches == before + 1
        _assert_same(got, twin(**args))
        _assert_same(got, ref)

    for jblk in cc.SCHED_ROUNDS:
        check(cc.trace_closest_args, cc.prepare_tiles(*ins, sched_rounds=jblk),
              ref_closest, cc.trace_sched_tiles)
    pl = cc.prepare_tiles(*ins, pipelined=True)
    check(cc.trace_closest_args, pl, ref_closest,
          cc.trace_pipelined_closest_tiles)
    check(cc.trace_any_args, pl, ref_any, cc.trace_pipelined_any_tiles)
    check(cc.trace_pairs_args,
          cc.prepare_tiles(*ins, pairs=True, pipelined=True), ref_pairs,
          cc.trace_pipelined_pairs_tiles)
    for pipelined in (False, True):
        near = cc.prepare_tiles(*ins, near="kernel", pipelined=pipelined)
        assert "snear" not in near and "order" not in near
        check(cc.trace_closest_args, near, ref_closest,
              cc.trace_near_closest_tiles)
        check(cc.trace_any_args, near, ref_any, cc.trace_near_any_tiles)
        check(cc.trace_pairs_args,
              cc.prepare_tiles(*ins, pairs=True, near="kernel",
                               pipelined=pipelined),
              ref_pairs, cc.trace_near_pairs_tiles)


def _warp_search_legs(dev, which):
    """Frame 0's legs (chip_smoke.frame0_legs, as path_trace makes them)
    of a 20,000-face stress scene at 160x96: ``slice``, single-level
    tables, the primary, bounce, NEE and env-NEE shadow legs (a 32x64
    equirect of the procedural sky); ``config5``, two-level tables
    (clusters of 2, G = 64), the primary, bounce and NEE legs of the
    third of four slabs."""
    import chip_smoke as cs
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )

    scene = stress_scene(20_000)
    st = RenderSettings(width=160, height=96)
    if which == "slice":
        tables = scene.tables(dev, group_size=0)
        sky = build_env_distribution(
            cs.sky_equirect(torch, 32, 64, dev).cpu().numpy(), dev)
        return tables, st, cs.frame0_legs(torch, tables, st, 0, sky=sky)
    tables = scene.tables(dev, cluster_size=2)
    st = st.replace(frame_slabs=4)
    return tables, st, cs.frame0_legs(torch, tables, st, 0, row0=48,
                                      rows=24)


@pytest.mark.parametrize("which", ["slice", "config5"])
def test_warp_shared_searches_match_twins_on_card(cuda, which):
    """The any-hit and pairs entries whose warps share their slot scans
    (K2n; K3 and K3p with their own super order) against their twins and
    against the kernels over the order sorted outside (K1 / K2p; K3 /
    K3p), bit for bit (any-hit codes; t1, c1, c2, c3, amb), on every leg
    of :func:`_warp_search_legs`."""
    tables, st, legs = _warp_search_legs(cuda, which)
    assert cc.is_two_level(tables.clusters) == (which == "config5")
    found = {}
    for key, leg in legs.items():
        for kind, select in (("any", cc.trace_any_args),
                             ("pairs", cc.trace_pairs_args)):
            pairs = kind == "pairs"
            ref_args = cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                        pairs=pairs, **leg)
            ref = select(ref_args)[0](**ref_args)
            args = cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                    pairs=pairs, near="kernel", **leg)
            assert args.variant == ("near" if which == "slice"
                                    else "near_two_level")
            wrapper, twin = select(args)
            before = wrapper.launches
            got = wrapper(**args)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            _assert_same(got, twin(**args))
            _assert_same(got, ref)
            code = got[1] if pairs else got
            found[key, kind] = int((code >= 0).sum())
    assert found["bounce", "pairs"] > 100 and found["nee", "any"] > 100
    assert found["primary", "pairs"] > 1000


# the walks over an order sorted outside whose warps share their slot scans
# (and K2n's pipelined walk, which shares the staged form): prepare_tiles
# keywords, searches
OUTSIDE_WALKS = {
    "K1": (dict(), ("closest", "any", "pairs")),
    "K5x1": (dict(sched_rounds=1), ("closest",)),
    "K5x4": (dict(sched_rounds=4), ("closest",)),
    "K5x8": (dict(sched_rounds=8), ("closest",)),
    "K2pl": (dict(pipelined=True), ("closest", "any", "pairs")),
    "K2n_pipelined": (dict(near="kernel", pipelined=True),
                      ("closest", "any", "pairs")),
}
SEARCH_ARGS = {"closest": cc.trace_closest_args, "any": cc.trace_any_args,
               "pairs": cc.trace_pairs_args}


@pytest.mark.parametrize("walk", sorted(OUTSIDE_WALKS) + ["K1c"])
def test_outside_walks_share_scans_on_card(cuda, walk):
    """K1 (closest-hit, any-hit; pairs: K2p), K5 in rounds of 1, 4 and 8,
    K2pl's three searches and K2n's pipelined walk on the bounce and
    env-NEE shadow legs of :func:`_warp_search_legs` (slice), where fewer
    than kCoopSerial lanes of a warp want most clusters and the shared
    scans run: each against its twin and against K2n on the same rays,
    bit for bit. ``K1c``: K1 capped at 1 and 4 entries with its stop on
    the bounce leg, then the survivors drained by K1 with ``t_start`` and
    the carried ``start_code``: the twin's outputs and stops, and K2n's
    result once drained."""
    tables, st, legs = _warp_search_legs(cuda, "slice")
    tile = st.trace_tile

    def launch(args, select):
        wrapper, twin = select(args)
        before = wrapper.launches
        got = wrapper(**args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _assert_same(got, twin(**args))
        return got

    if walk == "K1c":
        leg = legs["bounce"]
        ref = cc.trace_near_closest_tiles(**cc.prepare_tiles(
            tables=tables, tile=tile, near="kernel", **leg))
        for cap in (1, 4):
            t, code, stop = launch(cc.prepare_tiles(
                tables=tables, tile=tile, cap=cap, return_stop=True, **leg),
                cc.trace_closest_args)
            surv = t.view(torch.int32) > stop
            assert 0 < int(surv.sum())
            t2, c2 = launch(cc.prepare_tiles(
                leg["o"], leg["d"], torch.where(surv, t, torch.zeros_like(t)),
                tables, None, leg["excl_code"], tile,
                t_start=stop.view(torch.float32), start_code=code),
                cc.trace_closest_args)
            _assert_same((torch.where(surv, t2, t),
                          torch.where(surv, c2, code)), ref)
        return
    kw, searches = OUTSIDE_WALKS[walk]
    for key in ("bounce", "env"):
        for kind in searches:
            pairs = kind == "pairs"
            near = cc.prepare_tiles(tables=tables, tile=tile, pairs=pairs,
                                    near="kernel", **legs[key])
            ref = SEARCH_ARGS[kind](near)[0](**near)
            args = cc.prepare_tiles(tables=tables, tile=tile, pairs=pairs,
                                    **legs[key], **kw)
            _assert_same(launch(args, SEARCH_ARGS[kind]), ref)
            if kind == "any":  # the twin's model: scans shared
                stats = {}
                SEARCH_ARGS[kind](args)[1](**args, stats=stats)
                assert stats["kernel_slot_tests"] > stats["slot_tests"]


def test_kernel_near_cluster_cap_on_card(cuda):
    """K2n at its cap of NEAR_MAX_CLUSTERS boxes (the scene's clusters
    and empty ones) equals K1 on the unpadded tables; one box more
    raises, in ``prepare_tiles`` and in the wrapper."""
    tables = _small_scene().tables(cuda, cluster_size=16, group_size=0)
    o, d, tmax, active, excl = _mixed_rays(
        3000, 43, tables.clusters.face_id.numel())

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    rays = (t(o), t(d), t(tmax))
    rest = (t(active), t(excl, torch.int32))
    ref = cc.trace_closest_tiles(**cc.prepare_tiles(*rays, tables, *rest))
    at_cap = _padded_clusters(tables, cc.NEAR_MAX_CLUSTERS)
    for pipelined in (False, True):
        got = cc.trace_near_closest_tiles(**cc.prepare_tiles(
            *rays, at_cap, *rest, near="kernel", pipelined=pipelined))
        torch.cuda.synchronize()
        _assert_same(got, ref)
    over = _padded_clusters(tables, cc.NEAR_MAX_CLUSTERS + 1)
    with pytest.raises(ValueError):
        cc.prepare_tiles(*rays, over, *rest, near="kernel")
    args = cc.prepare_tiles(*rays, over, *rest)
    del args["snear"], args["order"]
    with pytest.raises(ValueError):
        cc.trace_near_closest_tiles(**args)


def test_scheduling_settings_raise_on_two_level_tables_on_card(cuda):
    """K5 and K2pl stay single-level and raise; ``kernel_near`` is K3
    ordering its supers itself."""
    tables = _small_scene().tables(cuda, cluster_size=16, group_size=4)
    assert cc.is_two_level(tables.clusters)
    o = torch.zeros((128, 3), device=cuda)
    d = torch.ones((128, 3), device=cuda)
    tm = torch.full((128,), F32_MAX, device=cuda)
    for kw in (dict(sched_rounds=4), dict(pipelined=True),
               dict(kernel_near=True, pipelined=True)):
        with pytest.raises(ValueError):
            cc.trace_closest_clustered_cuda(o, d, tm, tables, **kw)
    for kw in (dict(pipelined=True), dict(kernel_near=True, pipelined=True)):
        with pytest.raises(ValueError):
            cc.trace_any_clustered_cuda(o, d, tm, tables, **kw)
    before = cc.trace_near_closest_two_level_tiles.launches
    near = cc.trace_closest_clustered_cuda(o, d, tm, tables, kernel_near=True)
    assert cc.trace_near_closest_two_level_tiles.launches == before + 1
    _assert_same(tuple(near),
                 tuple(cc.trace_closest_clustered_cuda(o, d, tm, tables)))


@pytest.mark.parametrize("n_boxes", [1, 63, 64, 65, 130, 192, 700, 1500])
def test_kernel_near_orders_any_number_of_boxes_on_card(cuda, n_boxes):
    """K2n's first half over box counts around its row, segment and tail
    boundaries (a row is 128 boxes, a sort segment 64 keys, a tail at most
    half a row): the small scene's clusters cut or padded with empty
    clusters to ``n_boxes``, against K1 over the order sorted outside."""
    import dataclasses

    tables = _small_scene().tables(cuda, cluster_size=2, group_size=0)
    ct = tables.clusters
    if n_boxes <= ct.box.shape[0]:
        tables = dataclasses.replace(tables, clusters=dataclasses.replace(
            ct, box=ct.box[:n_boxes].contiguous(),
            face_id=ct.face_id[:n_boxes].contiguous(),
            mat_b=ct.mat_b[:n_boxes].contiguous()))
    else:
        tables = _padded_clusters(tables, n_boxes)
    o, d, tmax, active, excl = _mixed_rays(
        2000, 47, n_boxes * ct.face_id.shape[1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    ins = (t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32))
    ref = cc.trace_closest_tiles(**cc.prepare_tiles(*ins))
    got = cc.trace_near_closest_tiles(**cc.prepare_tiles(*ins, near="kernel"))
    torch.cuda.synchronize()
    _assert_same(got, ref)


def test_scheduling_and_sorted_frames_on_card(cuda):
    """2-frame NEE renders of the mini scene in clusters of 16: each of
    trace_sched, kernel_near, pipeline_rounds and the ray sort launches
    its kernels and equals the default frame bit for bit."""
    st = RenderSettings(width=32, height=32, bounces_depth=4, sample_count=1,
                        environment="procedural", next_event_estimation=True,
                        sort_bounce_rays=False, kernel_near=False)
    names = ("trace_closest_tiles", "trace_any_tiles", "trace_sched_tiles",
             "trace_near_closest_tiles", "trace_near_any_tiles",
             "trace_pipelined_closest_tiles", "trace_pipelined_any_tiles")

    def run(settings):
        r = Renderer(_mini_scene(), settings, base_seed=77, device=cuda)
        r.tables = _mini_scene().tables(cuda, cluster_size=16, group_size=0)
        before = [getattr(cc, n).launches for n in names]
        r.step()
        r.step()
        torch.cuda.synchronize()
        return r.buffers.image, [
            getattr(cc, n).launches - b for n, b in zip(names, before)]

    want, launched = run(st)
    assert launched == [12, 12, 0, 0, 0, 0, 0]
    cases = {
        "trace_sched": (dict(trace_sched=4), [0, 12, 12, 0, 0, 0, 0]),
        "kernel_near": (dict(kernel_near=True), [0, 0, 0, 12, 12, 0, 0]),
        "pipeline_rounds": (dict(pipeline_rounds=True),
                            [0, 0, 0, 0, 0, 12, 12]),
        "sorted": (dict(sort_bounce_rays=True), [12, 12, 0, 0, 0, 0, 0]),
    }
    for name, (kw, expect) in cases.items():
        got, launched = run(st.replace(**kw))
        assert launched == expect, (name, launched)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


@pytest.mark.parametrize("which", ["s16", "s128", "s2"])
def test_binned_pass_and_drain_hooks_match_twins_on_card(cuda, which):
    """K4 and the hooked drain entries against their twins, bit for bit,
    on the rays of test_sched_near_pipelined_kernels_match_twins_on_card:
    K4 on the stream sorted by nearest cluster, from (t_max, -1) and from
    a carried (t, code); K1 capped at 1, 2 and 5 clusters with its stop;
    K1, K2pl and K2n (both walks) with ``t_start`` and ``start_code``; the
    any-hit entries of K1 and K2n with ``t_start``. Then the binned and
    multipass traces on the card against the plain K1 route."""
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops import ray_sort

    if which == "s2":
        tables = stress_scene(5000).tables(cuda, cluster_size=2, group_size=0)
    else:
        tables = _small_scene().tables(
            cuda, cluster_size=16 if which == "s16" else 128, group_size=0)
    ct = tables.clusters
    o, d, tmax, active, excl = _mixed_rays(5120, 47, ct.face_id.numel())
    if which == "s2":
        o = o * 4.0 + np.array([0.0, 12.0, 0.0], np.float32)
        d[:, 1] = -np.abs(d[:, 1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    o, d, tmax, active, excl = (t(o), t(d), t(tmax), t(active),
                                t(excl, torch.int32))
    tm = torch.where(active, tmax, torch.zeros_like(tmax))

    def check(wrapper, args):
        before = wrapper.launches
        got = wrapper(**args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _assert_same(got, wrapper.twin(**args))
        return got

    # K4 on the sorted stream, then again from what it carried out
    c = ct.box.shape[0]
    k1, k2 = ray_sort.nearest_cluster_keys2(o, d, tm, ct.box)
    cid_s, perm = ray_sort.sort_keys(ray_sort._cid_of(k1, c))
    sched, flag = ray_sort._block_schedules(cid_s, 5120 // 128, 128, c)
    assert int((sched[:, 1] >= 0).sum()) > 0, sched
    o_s, d_s, tm_s, ex_s = ray_sort.permute_rows(perm, (o, d, tm, excl))
    t1, c1 = check(cc.trace_binned_tiles,
                   cc.binned_args(o_s, d_s, tm_s, tables, sched, ex_s))
    assert int((c1 >= 0).sum()) > 10
    # the two entries in two passes, the second from what the first carried
    # (and an empty first entry): the one pass's result
    none = torch.full_like(sched[:, :1], -1)
    ta, ca = check(cc.trace_binned_tiles, cc.binned_args(
        o_s, d_s, tm_s, tables, torch.cat([none, sched[:, 1:]], 1), ex_s))
    assert int((ca >= 0).sum()) <= int((c1 >= 0).sum())
    _assert_same(check(cc.trace_binned_tiles, cc.binned_args(
        o_s, d_s, ta, tables, torch.cat([sched[:, :1], none], 1), ex_s,
        start_code=ca)), (t1, c1))

    # capped K1 and its stop: every ray the cap changed is a survivor
    rays = (o, d, tmax, tables, active, excl)
    full = cc.trace_closest_tiles(**cc.prepare_tiles(*rays))
    survivors = []
    for cap in (1, 2, 5):
        tc, cc_, stop = check(cc.trace_closest_tiles, cc.prepare_tiles(
            *rays, cap=cap, return_stop=True))
        surv = tc.view(torch.int32) > stop
        assert not bool(((cc_ != full[1]) & ~surv).any())
        survivors.append(int(surv.sum()))
    assert survivors[-1] <= survivors[0] < 5120 and survivors[0] > 0

    # t_start and start_code on every entry that takes them: the second
    # pass after a walk capped at 2 completes the uncapped result
    tc, cc_, stop = cc.trace_closest_tiles(**cc.prepare_tiles(
        *rays, cap=2, return_stop=True))
    surv = tc.view(torch.int32) > stop
    tm2 = torch.where(surv, tc, torch.zeros_like(tc))
    hooks = dict(t_start=stop.view(torch.float32), start_code=cc_)
    for wrapper, kw in (
        (cc.trace_closest_tiles, {}),
        (cc.trace_pipelined_closest_tiles, dict(pipelined=True)),
        (cc.trace_near_closest_tiles, dict(near="kernel")),
        (cc.trace_near_closest_tiles, dict(near="kernel", pipelined=True)),
    ):
        args = cc.prepare_tiles(o, d, tm2, tables, None, excl, **hooks, **kw)
        assert cc.trace_closest_args(args)[0] is wrapper
        t3, c3 = check(wrapper, args)
        _assert_same(torch.where(surv, c3, cc_), full[1])
        _assert_same(torch.where(surv, t3, tc), full[0])
    ref_any = cc.trace_any_tiles(**cc.prepare_tiles(*rays)) >= 0
    ts_any = torch.where(flag, (k2[perm] & ~ray_sort._key_masks(c)[0])
                         .view(torch.float32), torch.zeros_like(tm_s))
    for wrapper, kw in ((cc.trace_any_tiles, {}),
                        (cc.trace_near_any_tiles, dict(near="kernel"))):
        args = cc.prepare_tiles(o_s, d_s, tm_s, tables, None, ex_s,
                                t_start=ts_any, **kw)
        a3 = check(wrapper, args)
        _assert_same(((a3 >= 0) | (c1 >= 0))[torch.argsort(perm)], ref_any)

    # the whole traces on the card
    def drain(o_, d_, tm_, tb_, act_, excl_code=None, **h):
        return cc.trace_closest_clustered_cuda(
            o_, d_, tm_, tb_, act_, excl_code=excl_code, raw="code", **h)

    def drain_any(o_, d_, tm_, tb_, act_, excl_code=None, t_start=None):
        return cc.trace_any_clustered_cuda(
            o_, d_, tm_, tb_, act_, excl_code=excl_code, t_start=t_start)

    want = (full[0][:5120], cc.code_to_face(full[1][:5120], ct.face_id))
    before = cc.trace_binned_tiles.launches
    _assert_same(ray_sort.binned_trace(drain, *rays[:3], tables, active,
                                       extra=excl), want)
    assert cc.trace_binned_tiles.launches == before + 2
    _assert_same(ray_sort.sorted_trace_multipass(
        drain, *rays[:3], tables, active, extra=excl, cap=2), want)
    for mid in (False, True):
        _assert_same(ray_sort.binned_trace_any(
            drain_any, *rays[:3], tables, active, extra=excl, mid=mid),
            ref_any)


def _mini_scene():
    return scene_from_facesets(
        [
            ("light", uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4, lon=6)),
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def test_nee_launches_on_card(cuda):
    """A 2-frame NEE render (2 samples, 2 segments): 8 closest-hit and 8
    any-hit launches, of K2n by default and of K1 with ``kernel_near``
    off and of no other kernel; the two frames equal bit for bit, and the
    accumulation equals the CPU's (twins)."""
    st = RenderSettings(width=32, height=32, bounces_depth=3, sample_count=1,
                        environment="procedural", next_event_estimation=True)
    assert st.kernel_near is True
    wrappers = (cc.trace_near_closest_tiles, cc.trace_near_any_tiles,
                cc.trace_closest_tiles, cc.trace_any_tiles)
    images = []
    for near, expect in ((True, [8, 8, 0, 0]), (False, [0, 0, 8, 8])):
        before = [w.launches for w in wrappers]
        r = Renderer(_mini_scene(), st.replace(kernel_near=near),
                     base_seed=77, device=cuda)
        r.step()
        r.step()
        assert [w.launches - b for w, b in zip(wrappers, before)] == expect
        images.append(r.buffers.image)
    assert torch.equal(images[0].view(torch.int32),
                       images[1].view(torch.int32))
    c = Renderer(_mini_scene(), st, base_seed=77, device="cpu")
    c.step()
    c.step()
    got, want = images[0].cpu().numpy(), c.buffers.image.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert float(np.sqrt(np.mean((got[ok] - want[ok]) ** 2))) < 1e-5


def test_golden_mini_scene_on_card(cuda):
    scene = _mini_scene()
    st = RenderSettings(width=32, height=32, bounces_depth=3, sample_count=1,
                        environment="procedural")
    before = cc.trace_near_closest_tiles.launches
    r = Renderer(scene, st, base_seed=77, device=cuda)
    r.step()
    r.step()
    assert cc.trace_near_closest_tiles.launches == before + 2 * 2 * 2
    got = r.buffers.image.cpu().numpy()
    rmse = float(np.sqrt(np.mean((got - np.load(GOLDEN)["image"]) ** 2)))
    assert rmse < 1e-5, rmse


def test_two_level_frames_on_card(cuda):
    """A 2-frame NEE render on two-level tables of the mini scene (S = 16,
    G = 4) in 2 slabs: 16 two-level closest-hit and 16 two-level any-hit
    launches and no single-level one, of K3 ordering its supers itself by
    default and of K3 over the order sorted outside with ``kernel_near``
    off; the accumulation equals the CPU twins' and the single-level
    frame on the card."""
    st = RenderSettings(width=32, height=32, bounces_depth=3, sample_count=1,
                        environment="procedural", next_event_estimation=True,
                        frame_slabs=2)
    wrappers = (cc.trace_near_closest_tiles, cc.trace_near_any_tiles,
                cc.trace_near_closest_two_level_tiles,
                cc.trace_near_any_two_level_tiles,
                cc.trace_closest_two_level_tiles,
                cc.trace_any_two_level_tiles, cc.trace_closest_tiles,
                cc.trace_any_tiles)
    images = {}
    for dev, two_level, near in (("cuda", True, True), ("cpu", True, True),
                                 ("cuda", False, True),
                                 ("cuda", True, False)):
        r = Renderer(_mini_scene(), st.replace(kernel_near=near),
                     base_seed=77, device=dev)
        if two_level:
            r.tables = _mini_scene().tables(dev, cluster_size=16,
                                            group_size=4)
        before = [w.launches for w in wrappers]
        r.step()
        r.step()
        torch.cuda.synchronize()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        if dev == "cuda":
            expect = [0] * 8
            at = (2 if two_level else 0) if near else 4
            expect[at] = expect[at + 1] = 16
            assert launched == expect, launched
        images[dev, two_level, near] = r.buffers.image.cpu().numpy()
    want = images["cpu", True, True]
    np.testing.assert_array_equal(
        images["cuda", True, True].view(np.int32),
        images["cuda", True, False].view(np.int32))
    for key in (("cuda", True, True), ("cuda", False, True)):
        got = images[key]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert float(np.sqrt(np.mean((got[ok] - want[ok]) ** 2))) < 1e-5


def _key_boxes(rng, c, pads):
    """``c`` random boxes around the origin, flat ones among them, the
    last ``pads`` inverted-empty (min 3e38 > max -3e38), box 1 a copy of
    box 0 (near ties); one box: the cube [-2, 2]^3."""
    if c == 1:
        return np.array([[-2, -2, -2, 2, 2, 2]], np.float32)
    lo = rng.uniform(-3, 2, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 1.5, (c, 3)).astype(np.float32)
    hi[1::7, 1] = lo[1::7, 1]
    b = np.concatenate([lo, hi], 1)
    b[1] = b[0]
    b[c - pads:, :3] = np.float32(3.0e38)
    b[c - pads:, 3:] = np.float32(-3.0e38)
    return b


@pytest.mark.parametrize("t_start", [False, True], ids=["", "t_start"])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("which", ["clusters", "supers", "c700", "c1"])
def test_key_kernel_matches_twin_on_card(cuda, which, n, t_start):
    """The key kernel against its twin, every int32 key equal: the
    clusters and the supers of the small scene, 700 random boxes (more
    than one staging chunk, with pads and ties) and a single box; rays
    with dead lanes, NaN origins, zero and tiny direction components, and
    rays that start on a box face (a near of -0, which the key makes +0);
    ``t_start`` with zeros and NaN (a dead lane's stop)."""
    from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir

    rng = np.random.default_rng(61 + n)
    if which in ("clusters", "supers"):
        tables = _small_scene().tables(cuda, cluster_size=8, group_size=4)
        boxes = (tables.clusters.box if which == "clusters"
                 else tables.clusters.super_box)
    else:
        c = 700 if which == "c700" else 1
        boxes = torch.as_tensor(_key_boxes(rng, c, 4 if c > 1 else 0),
                                device=cuda)
    o, d, tmax, active, _ = _mixed_rays(6000, 62 + n, 10)
    if which in ("clusters", "supers"):
        o = o + np.array([0.0, 0.0, -3.0], np.float32)
    d[::11, 0] = 3e-13
    d[1::13, 1] = 0.0
    # rays that start on a box's max-x face going -x: a near of -0 there
    bx = boxes.cpu().numpy()
    idx = np.arange(3, o.shape[0], 7)
    b = bx[idx % bx.shape[0]]
    o[idx] = np.stack([b[:, 3], (b[:, 1] + b[:, 4]) / 2,
                       (b[:, 2] + b[:, 5]) / 2], 1)
    d[idx] = np.float32([-0.6, 0.0, 0.8])
    tm = np.where(active, tmax, 0.0).astype(np.float32)
    ts = rng.uniform(0.0, 6.0, o.shape[0]).astype(np.float32)
    ts[::5] = 0.0
    ts[::9] = np.int32(0x7FFFFFFF).view(np.float32)

    def t(a):
        return torch.as_tensor(a, device=cuda).contiguous()

    args = (t(o), safe_inv_dir(t(d)), t(tm), boxes.contiguous(), n)
    kw = dict(t_start=t(ts) if t_start else None)
    before = cc.top_keys_tiles.launches
    got = cc.top_keys_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert cc.top_keys_tiles.launches == before + 1
    want = cc.top_keys_tiles.twin(*args, **kw)
    _assert_same(tuple(got), tuple(want))
    kmask, miss_th = cc.key_masks(boxes.shape[0])
    assert bool(((want[0] & ~kmask) < miss_th).any())
    with pytest.raises(ValueError):
        cc.top_keys_tiles(*args[:4], 4, **kw)


@pytest.mark.parametrize("tile", [32, 100, 128, 256])
def test_binned_pass_staged_blocks_on_card(cuda, tile):
    """K4, which stages each block's clusters in shared memory, against the
    twin, bit for bit: 35 blocks of ``tile`` rays (a tile of no whole
    number of warps too), schedules with a run of equal ones, missing and
    equal entries and (-1, -1) blocks (their rays keep (t_max, the carried
    code)), exclusion codes and a carried (t, code)."""
    tables = _small_scene().tables(cuda, cluster_size=16, group_size=0)
    c = tables.clusters.box.shape[0]
    n_blocks = 35
    r = n_blocks * tile
    o, d, tmax, active, excl = _mixed_rays(r, 71, tables.clusters.face_id
                                           .numel())
    rng = np.random.default_rng(72)
    sched = rng.integers(0, c, (n_blocks, 2))
    sched[:, 1] = np.where(rng.uniform(size=n_blocks) < 0.3, -1,
                           sched[:, 1])
    sched[3:9] = sched[2]  # a run of blocks with the same schedule
    sched[10, 0] = -1  # only s1
    sched[11] = (5, 5)  # the same cluster twice
    sched[12:20] = -1  # blocks with nothing scheduled
    code0 = rng.integers(-1, tables.clusters.face_id.numel(), r)

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    tm = torch.where(t(active), t(tmax), torch.zeros_like(t(tmax)))
    base = cc.binned_args(t(o), t(d), tm, tables,
                          t(sched, torch.int32), t(excl, torch.int32),
                          tile=tile)
    for start in (None, t(code0, torch.int32)):
        args = dict(base) if start is None else dict(base, start_code=start)
        before = cc.trace_binned_tiles.launches
        got = cc.trace_binned_tiles(**args)
        torch.cuda.synchronize()
        assert cc.trace_binned_tiles.launches == before + 1
        _assert_same(got, cc.trace_binned_tiles.twin(**args))
        idle = torch.arange(r, device=cuda) // tile
        idle = (idle >= 12) & (idle < 20)
        assert torch.equal(got[0][idle], args["t_max"][idle])
        assert torch.equal(got[1][idle], torch.full_like(got[1][idle], -1)
                           if start is None else start[idle])
    assert int((got[1] >= 0).sum()) > 10


def test_sorted_binned_chained_frames_on_card(cuda):
    """2-frame NEE renders of the mini scene in clusters of 16 with the
    ray sort (plain, chained, ``binned_sort``, ``binned_any_sort``,
    ``multipass_cap``): each equals the default frame bit for bit and
    computes its keys with the key kernel, one launch per key (16, 8, 24,
    16, 24 in the two frames)."""
    st = RenderSettings(width=32, height=32, bounces_depth=4, sample_count=1,
                        environment="procedural", next_event_estimation=True)

    def run(settings):
        r = Renderer(_mini_scene(), settings, base_seed=77, device=cuda)
        r.tables = _mini_scene().tables(cuda, cluster_size=16, group_size=0)
        before = cc.top_keys_tiles.launches
        r.step()
        r.step()
        torch.cuda.synchronize()
        return r.buffers.image, cc.top_keys_tiles.launches - before

    want, launched = run(st)
    assert launched == 0
    srt = st.replace(sort_bounce_rays=True)
    cases = {
        "sorted": (srt, 16), "chained": (srt.replace(chained_sort=True), 8),
        "binned": (srt.replace(binned_sort=True), 24),
        "binned_any": (srt.replace(binned_any_sort=True), 16),
        "multipass": (srt.replace(multipass_cap=2, kernel_near=False), 24),
    }
    for name, (settings, keys) in cases.items():
        got, launched = run(settings)
        assert launched == keys, (name, launched)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


def test_sorted_sliced_frame_keys_outside_the_trace_launch_on_card(
        cuda, monkeypatch):
    """A 128x32 path frame of the mini scene over two-level tables in 8
    slabs, as the ``stress1m_4k.sorted`` cell cuts its frame: sorted legs
    of 512 rays, sliced to 384 / 256 rows. With the ray sort on it equals
    the unsorted frame bit for bit; the key kernel launches once a sorted
    leg (32, counted in ``top_keys_tiles.launches`` as before), never
    through ``cluster_cuda._run``, which launches the trace kernels."""
    from webgpu_raytracing_tpu_torch.utils import timing

    st = RenderSettings(width=128, height=32, bounces_depth=4,
                        sample_count=1, environment="procedural",
                        frame_slabs=8)
    entries = []
    run_ = cc._run

    def spy(entry, dev, args):
        entries.append(entry)
        return run_(entry, dev, args)

    monkeypatch.setattr(cc, "_run", spy)

    def frame(settings):
        r = Renderer(_mini_scene(), settings, base_seed=77, device=cuda)
        r.tables = _mini_scene().tables(cuda, cluster_size=16, group_size=4)
        before = cc.top_keys_tiles.launches
        with timing.tracing():
            r.step()
        torch.cuda.synchronize()
        return (r.buffers.image, cc.top_keys_tiles.launches - before,
                r.last_counts)

    want, launched, _ = frame(st)
    assert launched == 0
    got, launched, counts = frame(st.replace(sort_bounce_rays=True))
    assert launched == counts["trace.sort.legs"] == 32
    assert counts["trace.sort.traced"] < counts["trace.sort.rays"]
    assert entries and "wrt_top_keys" not in entries
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _camera_inputs(w, h, row0, rows, seed, moved, dev):
    """Jittered pixel positions of ``rows`` rows from ``row0`` of a w x h
    image, the view of the default or a moved and rotated camera, and the
    state words of ``seed`` (near 2^32, so they wrap)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(row0, row0 + rows), np.arange(w),
                         indexing="ij")
    pos = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    pos += rng.uniform(0.0, 1.0, pos.shape).astype(np.float32)
    cam = Camera()
    if moved:
        cam.rotate(np.array([0.3, -0.7], np.float32))
        cam.move(np.array([0.4, -0.2, 1.3], np.float32))
    idx = torch.from_numpy((xs + ys * w).reshape(-1))
    state = trng.seed_state(2**32 - 1 - int(rng.integers(0, 5 * w)), idx)
    return (torch.from_numpy(pos).to(dev),
            torch.from_numpy(cam.view_matrix()).to(dev), state.to(dev))


def _assert_rays_equal_cpu_twin(pos, view, state, st):
    """One launch; o, d and the state equal the CPU twin's bit for bit."""
    before = camera_rays.launches
    got = camera_rays(pos, view, state, st)
    torch.cuda.synchronize()
    assert camera_rays.launches == before + 1
    want = camera_rays.twin(pos.cpu(), view.cpu(), state.cpu(), st)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(
            g.cpu().numpy().view(np.int32),
            w.contiguous().numpy().view(np.int32))
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.parametrize("lens", [0, 1], ids=["circle", "square"])
@pytest.mark.parametrize("projection", [0, 1, 2, 3],
                         ids=["fisheye", "panini", "pinhole", "ortho"])
def test_camera_rays_kernel_matches_cpu_twin_on_card(cuda, projection, lens):
    """Every FoV orientation, circle of confusion 0 and 0.05, two focus
    distances, the default and a moved camera, on 37 x 23 = 851 rays (not
    a multiple of the block) with state words near 2^32."""
    for orientation in range(3):
        for coc in (0.0, 0.05):
            for focus in (4.0, 1.7):
                st = RenderSettings(
                    width=37, height=23, projection_type=projection,
                    lens_shape=lens, fov_orientation=orientation,
                    circle_of_confusion=coc, focus_distance=focus)
                for moved in (False, True):
                    _assert_rays_equal_cpu_twin(
                        *_camera_inputs(37, 23, 0, 23, orientation, moved,
                                        cuda), st)


@pytest.mark.parametrize("row0", [0, 1890], ids=["first", "last"])
def test_camera_rays_kernel_config5_slab_on_card(cuda, row0):
    """A config #5 slab (Panini, circle lens): 3840 x 270 = 1,036,800
    rays, the first slab's rows and the last's."""
    st = RenderSettings(width=3840, height=2160, frame_slabs=8)
    _assert_rays_equal_cpu_twin(
        *_camera_inputs(3840, 2160, row0, 270, 5, False, cuda), st)


def test_camera_rays_one_launch_and_checks_on_card(cuda):
    """One device operation a call, the kernel, by the profiler too; a
    frame launches it once per sample and slab;
    a wrong dtype, shape or a non-contiguous input raises."""
    from torch.profiler import ProfilerActivity, profile

    pos, view, state = _camera_inputs(64, 32, 0, 32, 3, True, cuda)
    for projection in range(4):
        for lens in range(2):
            st = RenderSettings(width=64, height=32,
                                projection_type=projection, lens_shape=lens)
            camera_rays(pos, view, state, st)
            torch.cuda.synchronize()
            before = camera_rays.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                camera_rays(pos, view, state, st)
                torch.cuda.synchronize()
            assert camera_rays.launches == before + 1
            ops = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            assert len(ops) == 1 and "camera_rays_kernel" in ops[0], ops

    r = Renderer(_mini_scene(), RenderSettings(width=32, height=32,
                                               frame_slabs=2),
                 base_seed=5, device=cuda)
    before = camera_rays.launches
    r.step()
    assert camera_rays.launches - before == 4  # 2 samples x 2 slabs

    st = RenderSettings(width=64, height=32)
    bad = [
        (pos.double(), view, state),
        (torch.empty(pos.shape[0], 4, device=cuda)[:, :2], view, state),
        (pos, view.double(), state),
        (pos, view.t(), state),
        (pos, view, state.int()),
        (pos, view, state[:-1]),
        (pos.reshape(32, 64, 2), view, state),
    ]
    for args in bad:
        with pytest.raises(ValueError, match="camera rays kernel"):
            camera_rays(*args, st)
    with pytest.raises(ValueError, match="camera rays kernel"):
        camera_rays(pos, view.cpu(), state, st)


# --- shading's two kernels (csrc/shade.cu) ---

def _shade_inputs(case, r, dev):
    """Random lanes and tables of tests/test_torch_shade.py's ``case`` on
    ``dev`` and on the CPU."""
    import types

    from test_torch_shade import CASES, _lanes, _tables

    from webgpu_raytracing_tpu_torch.ops.intersect import Hit

    gen = np.random.default_rng(100 + sorted(CASES).index(case))
    tables = _tables(gen, CASES[case][4])
    lanes = _lanes(gen, r, tables.tri.shape[0])

    def to(x):
        if x is None or isinstance(x, torch.Tensor):
            return x if x is None else x.to(dev)
        if isinstance(x, Hit):
            return Hit(*[to(v) for v in x])
        return types.SimpleNamespace(**{k: to(v)
                                        for k, v in vars(x).items()})

    return CASES[case], (tables, lanes), (to(tables), {k: to(v) for k, v
                                                       in lanes.items()})


def _same_bits(got, want, what):
    """Equal bit for bit on the CPU, NaN equal to NaN whatever its payload;
    None only with None."""
    if want is None:
        assert got is None, what
        return
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.float32:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), what
        got = got.masked_fill(nan, 0.0).view(torch.int32)
        want = want.masked_fill(nan, 0.0).view(torch.int32)
    assert torch.equal(got, want), (what, int((got != want).sum()))


@pytest.mark.parametrize("r", [3001, 1_036_803], ids=["3001", "slab"])
@pytest.mark.parametrize("case", ["flat", "phong", "phong_envis_run_env",
                                  "phong_envis_no_partner",
                                  "flat_envis_run_env_no_partner",
                                  "flat_envis_first_segment"])
def test_shade_kernels_match_cpu_twin_on_card(cuda, case, r):
    """``wrt_shade_hit`` then ``wrt_shade_bounce`` on random lanes (a third
    missed, a fifth dead, NaN origins, NaN throughput), one launch each,
    every output equal to the CPU twin's bit for bit; the inputs are left
    as they were."""
    from webgpu_raytracing_tpu_torch.ops import integrator as ti

    (shading, env_is, seg, run_env, _), (t_cpu, x_cpu), (t_dev, x_dev) = (
        _shade_inputs(case, r, cuda))
    env_mis = env_is and seg > 0

    def hit_args(t, x):
        return (x["hit"], x["alive"], x["d"], x["color"], x["throughput"],
                x["env_dir"], x["env_w"], x["env_mis_pdf"],
                x["prev_bsdf_pdf"], t, shading, env_mis)

    inputs = {k: v.clone() for k, v in x_dev.items() if k != "hit"}
    before = ti.shade_hit.launches
    got = ti.shade_hit(*hit_args(t_dev, x_dev))
    assert ti.shade_hit.launches == before + 1
    want = ti.shade_hit.twin(*hit_args(t_cpu, x_cpu))
    for name, g, w in zip(ti.HitShading._fields, got, want):
        _same_bits(g, w, name)

    before = ti.shade_bounce.launches
    got_b = ti.shade_bounce(x_dev["state"], got.h, got.n, got.new_o,
                            got.throughput, x_dev["o"], x_dev["d"],
                            x_dev["prev_bsdf_pdf"], env_is, run_env)
    assert ti.shade_bounce.launches == before + 1
    want_b = ti.shade_bounce.twin(x_cpu["state"], want.h, want.n,
                                  want.new_o, want.throughput, x_cpu["o"],
                                  x_cpu["d"], x_cpu["prev_bsdf_pdf"], env_is,
                                  run_env)
    for name, g, w in zip(ti.Bounce._fields, got_b, want_b):
        _same_bits(g, w, name)
    torch.cuda.synchronize()
    for k, v in inputs.items():
        assert torch.equal(v.view(torch.uint8), x_dev[k].view(torch.uint8)), k


def _shade_frame_settings(mode):
    base = dict(width=48, height=32, sample_count=1, bounces_depth=4,
                environment="black")
    return RenderSettings(**{**base, **{
        "path": {},
        "nee": dict(next_event_estimation=True),
        "envis": dict(environment="equirect", env_importance_sampling=True),
        "chained": dict(next_event_estimation=True, sort_bounce_rays=True,
                        chained_sort=True),
    }[mode]})


@pytest.mark.parametrize("mode", ["path", "nee", "envis", "chained"])
def test_path_trace_shading_kernels_on_card(cuda, mode, monkeypatch):
    """Two frames on the card: each of the frame's shading launches gives
    the CPU twin's outputs bit for bit on the same inputs; 2 launches a
    segment (``shade.kernel_launches`` with tracing on: 2 x 3 segments x
    2 samples); the eager twins are never entered on CUDA tensors; the
    accumulation equals the CPU frame's (NaN masks equal, RMSE < 1e-5)."""
    from test_torch_shade import _scene

    from webgpu_raytracing_tpu_torch.ops import integrator as ti
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )
    from webgpu_raytracing_tpu_torch.ops.intersect import Hit
    from webgpu_raytracing_tpu_torch.utils import timing

    st = _shade_frame_settings(mode)
    img = (np.random.default_rng(4).random((16, 32, 3)) * 0.5).astype(
        np.float32)
    img[4, 10] = 200.0
    calls = {"shade_hit": 0, "shade_bounce": 0}
    twin_devices = []

    def checked(name):
        kernel = getattr(ti, name)
        twin = kernel.twin

        def spy_twin(*args):
            twin_devices.append(args[2].device.type)
            return twin(*args)

        def call(*args):
            out = kernel(*args)
            cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args]
            if name == "shade_hit":
                cpu[0] = Hit(*[v.cpu() for v in args[0]])
                cpu[9] = args[9].to("cpu")
            want = twin(*cpu)
            for f, g, w in zip(type(out)._fields, out, want):
                _same_bits(g, w, f"{name}.{f}")
            calls[name] += 1
            return out

        # the dispatcher counts its launch on the module's name, now this
        call.twin, call.launches = spy_twin, 0
        monkeypatch.setattr(kernel, "twin", spy_twin)
        return call

    images = {}
    for dev in ("cpu", "cuda"):
        env = build_env_distribution(img, dev) if st.env_importance_sampling \
            else None
        r = Renderer(_scene(-1.5), st, env_data=env, base_seed=31, device=dev)
        if dev == "cuda":
            monkeypatch.setattr(ti, "shade_hit", checked("shade_hit"))
            monkeypatch.setattr(ti, "shade_bounce", checked("shade_bounce"))
        with timing.tracing():
            r.step()
            counts = r.last_counts
            r.step()
        torch.cuda.synchronize()
        images[dev] = r.buffers.image.cpu().numpy()
        if dev == "cuda":
            assert counts.get("shade.kernel_launches") == 2 * 3 * 2, counts
    assert calls == {"shade_hit": 12, "shade_bounce": 12}, calls
    assert "cuda" not in twin_devices
    got, want = images["cuda"], images["cpu"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    rmse = float(np.sqrt(np.mean((got[ok] - want[ok]) ** 2)))
    equal = float(np.mean(got.view(np.int32) == want.view(np.int32)))
    print(f"{mode}: card vs CPU frame RMSE {rmse:.3g}, {equal:.4f} of the "
          "values equal bit for bit")
    assert rmse < 1e-5, rmse


class Ops(TorchDispatchMode):
    """Records the name of every PyTorch operation run inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_shade_kernels_one_device_op_each_on_card(cuda):
    """A call on CUDA tensors dispatches no PyTorch operation but the
    allocation of its outputs, so its one launch is the kernel; a wrong
    dtype raises before any launch."""
    from webgpu_raytracing_tpu_torch.ops import integrator as ti

    (shading, env_is, seg, run_env, _), _, (t, x) = _shade_inputs(
        "phong_envis_run_env", 5000, cuda)
    args = (x["hit"], x["alive"], x["d"], x["color"], x["throughput"],
            x["env_dir"], x["env_w"], x["env_mis_pdf"], x["prev_bsdf_pdf"],
            t, shading, True)
    launches = ti.shade_hit.launches, ti.shade_bounce.launches
    with Ops() as ops:
        sh = ti.shade_hit(*args)
        ti.shade_bounce(x["state"], sh.h, sh.n, sh.new_o, sh.throughput,
                        x["o"], x["d"], x["prev_bsdf_pdf"], True, True)
    torch.cuda.synchronize()
    assert (ti.shade_hit.launches, ti.shade_bounce.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert ops.names and set(ops.names) == {"empty"}, ops.names
    bad = list(args)
    bad[1] = x["alive"].to(torch.uint8)
    with pytest.raises(ValueError, match="shading kernel: alive"):
        ti.shade_hit(*bad)
    assert ti.shade_hit.launches == launches[0] + 1


# --- rederive (csrc/rederive.cu) ---

def _rederive_legs(which, dev):
    """(o, d, t, face, tables) of each leg of ``which``: ``config5``, the
    primary and first-bounce legs of a config #5 slab (the last of 8,
    3840 x 270 = 1,036,800 rays) with their faces from K3; ``k2n_1080p``,
    frame 0's first-bounce leg of the 1080p slice with its faces from K2n;
    ``edge``, tests/test_torch_rederive.py's edge-case batch."""
    import types

    if which == "edge":
        from test_torch_rederive import edge_batch

        o, d, t, face, tables = edge_batch()
        return [(o.to(dev), d.to(dev), t.to(dev), face.to(dev),
                 types.SimpleNamespace(tri=tables.tri.to(dev)))]
    import chip_smoke as cs
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    if which == "config5":
        tables = stress_scene(1_000_000).tables(dev)
        st = RenderSettings(width=3840, height=2160, frame_slabs=8)
        legs = cs.frame0_legs(torch, tables, st, 0, row0=1890, rows=270)
        names = ("primary", "bounce")
    else:
        tables = stress_scene(44_556).tables(dev)
        st = RenderSettings(width=1920, height=1080)
        legs = cs.frame0_legs(torch, tables, st, 0)
        names = ("bounce",)
    assert cc.is_two_level(tables.clusters) == (which == "config5")
    out = []
    for name in names:
        leg = legs[name]
        t, face = cc.trace_closest_clustered_cuda(
            tables=tables, tile=st.trace_tile, kernel_near=True, raw=True,
            **leg)
        out.append((leg["o"], leg["d"], t, face, tables))
    return out


@pytest.mark.parametrize("which", ["config5", "k2n_1080p", "edge"])
def test_rederive_kernel_matches_twin_on_card(cuda, which):
    """One launch a call, and nothing dispatched but the (3, R) output's
    allocation and its rows' views; t, u and v equal the twin's on CPU
    copies bit for bit, NaN equal to NaN whatever its payload (the card's
    NaN is not the CPU's); the face passes through."""
    import types

    from webgpu_raytracing_tpu_torch.ops.cluster_trace import rederive_uv

    for o, d, t, face, tables in _rederive_legs(which, cuda):
        before = rederive_uv.launches
        with Ops() as ops:
            got = rederive_uv(o, d, t, face, tables)
        torch.cuda.synchronize()
        assert rederive_uv.launches == before + 1
        assert ops.names == ["empty", "unbind"], ops.names
        assert got.face is face
        want = rederive_uv.twin(o.cpu(), d.cpu(), t.cpu(), face.cpu(),
                                types.SimpleNamespace(tri=tables.tri.cpu()))
        for name in "tuv":
            _same_bits(getattr(got, name), getattr(want, name), name)
        hits = int((face >= 0).sum())
        assert hits > (10 if which == "edge" else 100_000), hits


# --- the lights (csrc/light.cu) ---

@pytest.mark.parametrize("r", [3001, 1_036_803], ids=["3001", "slab"])
@pytest.mark.parametrize("case", ["flat_one_face_spp1", "phong_one_face_spp2",
                                  "flat_many_faces_spp2",
                                  "phong_many_faces_spp1"])
def test_light_kernels_match_cpu_twin_on_card(cuda, case, r):
    """``wrt_light_sample`` then ``wrt_light_add`` on
    tests/test_torch_light.py's random lanes, sample by sample: one launch
    each and nothing dispatched but their outputs' allocations; every
    output equal to the CPU twin's bit for bit, NaN equal to NaN."""
    import types

    from test_torch_light import CASES, light_lanes, light_tables

    from webgpu_raytracing_tpu_torch.ops import integrator as ti

    shading, faces, spp = CASES[case]
    gen = np.random.default_rng(140 + sorted(CASES).index(case))
    tables = light_tables(gen, faces)
    point, normal, state, shadowed = light_lanes(gen, r, tables, shading)
    t_dev = types.SimpleNamespace(**{
        k: v.to(cuda) for k, v in vars(tables).items()
        if isinstance(v, torch.Tensor)})
    p_dev, n_dev, s_dev, sh_dev = (x.to(cuda) for x in (point, normal, state,
                                                         shadowed))
    color, color_dev = None, None
    for k in range(spp):
        last = k == spp - 1
        before = ti.light_sample.launches, ti.light_add.launches
        with Ops() as ops:
            ray = ti.light_sample(p_dev, s_dev, t_dev)
            c_dev = ti.light_add(sh_dev, ray.d, n_dev, ray.carry, color_dev,
                                 t_dev, spp, last)
        torch.cuda.synchronize()
        assert (ti.light_sample.launches, ti.light_add.launches) == (
            before[0] + 1, before[1] + 1)
        assert set(ops.names) == {"empty"}, ops.names
        want = ti.light_sample.twin(point, state, tables)
        for name, g, w in zip(ti.LightRay._fields, ray, want):
            _same_bits(g, w, name)
        want_c = ti.light_add.twin(shadowed, want.d, normal, want.carry,
                                   color, tables, spp, last)
        _same_bits(c_dev, want_c, f"color of sample {k}")
        state, s_dev, color, color_dev = want.state, ray.state, want_c, c_dev
