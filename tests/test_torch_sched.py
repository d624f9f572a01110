"""PyTorch port: the tile-scheduling kernels K5 (``trace_sched``), K2n
(``kernel_near``) and K2pl (``pipeline_rounds``) against the port's own
K1 / K2p and against the JAX package.

The kernels' plain-torch twins run here (CPU tensors); the CUDA kernels
are held against the twins on the card in tests/test_torch_cuda.py. All
three return what K1 (pairs: K2p) returns on the same rays, bit for bit:
K5 only tests extra clusters whose candidates lose the (t, code) merge,
K2pl fetches a round early but tests what K1 tests, and K2n walks exactly
the order of the stable sort. Against the
Pallas kernels under the interpreter (``sched_rounds``, ``kernel_near``,
``pipeline_rounds``) the tolerances are those of tests/test_torch_trace.py:
hit masks equal, faces equal on at least 99.5% of hits (bf16 knife
edges), and t, u, v bit-equal where faces agree."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    rederive_uv as j_rederive_uv,
)
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu.ops.traverse import trace_closest as j_threaded
from webgpu_raytracing_tpu.renderer import Renderer as JRenderer
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.models.scene import tables_from_numpy
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.renderer import Renderer as TRenderer

torch.set_num_threads(1)

TABLE_FIELDS = (
    "node_box", "node_meta", "tri", "shade_normal", "face_material",
    "model_face_offset", "model_face_count", "mat_color", "mat_emission",
)


def _scene(mod, tm):
    return mod.scene_from_facesets(
        [
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


@pytest.fixture(scope="module")
def scenes():
    """tests/test_cluster.py scene: JAX tables and the same arrays as
    port tables (clusters of 128)."""
    jt = _scene(jscene, jtm).tables()
    arrays = {k: np.asarray(getattr(jt, k)) for k in TABLE_FIELDS}
    for k in ("box", "mat_b", "face_id", "partner_code"):
        arrays["clusters." + k] = np.asarray(getattr(jt.clusters, k))
    return jt, tables_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def fine_tables():
    """The same scene in the port's single-level clusters of 8: enough
    clusters for whole rounds of 8."""
    tt = _scene(tscene, ttm).tables("cpu", cluster_size=8, group_size=0)
    assert tt.clusters.box.shape[0] > 30 and not cc.is_two_level(tt.clusters)
    return tt


def _mixed_rays(n, seed, n_codes):
    """Rays with NaN origins, finite and unbounded t_max, inactive lanes
    (a whole tile of them, and the padded tail when n is not a multiple
    of 128) and exclusion codes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    active[256:384] = False
    excl = rng.integers(-1, n_codes, n).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (o, d, tmax, active, excl))


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def _ins(tt, n=1000, seed=3):
    o, d, tmax, active, excl = _mixed_rays(n, seed,
                                           tt.clusters.face_id.numel())
    return (o, d, tmax, tt, active, excl)


def _counted(args, selector, any_hit=False, pairs=False):
    """(outputs, work) of the twin that ``selector`` picks for ``args``."""
    stats = {}
    out = selector(args)[1](**args, stats=stats)
    return out, cc.walk_stats(stats, args["face_id"], any_hit, pairs)


@pytest.mark.parametrize("tables_kind", ["s128", "s8"])
@pytest.mark.parametrize("jblk", [1, 2, 4, 8])
def test_sched_twin_equals_k1_twin(scenes, fine_tables, tables_kind, jblk):
    """K5's twin returns K1's (t, code) bit for bit for every round size,
    also where the rounds run past the end of the order (6 clusters of
    128 in rounds of 8); it tests at least K1's slots, and exactly K1's
    with rounds of 1."""
    tt = scenes[1] if tables_kind == "s128" else fine_tables
    ins = _ins(tt)
    want, work1 = _counted(cc.prepare_tiles(*ins), cc.trace_closest_args)
    args = cc.prepare_tiles(*ins, sched_rounds=jblk)
    assert cc.trace_closest_args(args)[0] is cc.trace_sched_tiles
    got, work = _counted(args, cc.trace_closest_args)
    _same(got, want)
    _same(cc.trace_sched_tiles(**args), want)
    assert (want[1] >= 0).sum() > 100
    assert work["slot_tests"] >= work1["slot_tests"]
    assert work["box_tests"] >= work1["box_tests"]
    if jblk == 1:
        assert work == work1
    elif tables_kind == "s8":
        assert work["slot_tests"] > work1["slot_tests"]
    # through the dispatcher: t, u, v re-derived from the same faces
    hit = cc.trace_closest_clustered_cuda(*ins, sched_rounds=jblk)
    ref = cc.trace_closest_clustered_cuda(*ins)
    _same(tuple(hit), tuple(ref))


@pytest.mark.parametrize("tables_kind", ["s128", "s8"])
def test_near_twin_equals_k1_twin(scenes, fine_tables, tables_kind):
    """K2n's twins (closest-hit, any-hit codes, the five pairs outputs)
    equal K1's / K2p's bit for bit, with a whole inactive tile and a
    padded tail; its dict carries no entry distances and no order; its
    work adds one slab test per ray and box."""
    tt = scenes[1] if tables_kind == "s128" else fine_tables
    ins = _ins(tt, seed=4)
    k1 = cc.prepare_tiles(*ins)
    near = cc.prepare_tiles(*ins, near="kernel")
    assert "snear" not in near and "order" not in near
    for selector, wrapper, any_hit in (
        (cc.trace_closest_args, cc.trace_near_closest_tiles, False),
        (cc.trace_any_args, cc.trace_near_any_tiles, True),
    ):
        assert selector(near)[0] is wrapper
        want, work1 = _counted(k1, selector, any_hit)
        got, work = _counted(near, selector, any_hit)
        _same(got, want)
        _same(wrapper(**near), want)
        n_rays, n_boxes = near["o"].shape[0], tt.clusters.box.shape[0]
        assert work["box_tests"] == work1["box_tests"] + n_rays * n_boxes
        assert work["slot_tests"] == work1["slot_tests"]
    any_codes = cc.trace_near_any_tiles(**near)
    assert 50 < int((any_codes >= 0).sum()) < 900
    pairs = cc.prepare_tiles(*ins, pairs=True)
    near_p = cc.prepare_tiles(*ins, pairs=True, near="kernel")
    assert cc.trace_pairs_args(near_p)[0] is cc.trace_near_pairs_tiles
    _same(cc.trace_near_pairs_tiles(**near_p), cc.trace_pairs_tiles(**pairs))
    # all rays inactive: every distance is F32_MAX and nothing is walked
    o, d, tmax, _, active, excl = ins
    dead = cc.prepare_tiles(o, d, tmax, tt, torch.zeros_like(active), excl,
                            near="kernel")
    t, code = cc.trace_near_closest_tiles(**dead)
    assert (code == -1).all() and (t == 0.0).all()


@pytest.mark.parametrize("near", ["outside", "kernel"])
@pytest.mark.parametrize("tables_kind", ["s128", "s8"])
def test_pipelined_twin_equals_k1_twin(scenes, fine_tables, tables_kind,
                                       near):
    """K2pl's twins, over either source of the order, equal K1's / K2p's
    bit for bit: closest-hit, any-hit codes and the five pairs outputs (a
    round fetched on a vote one round early must not change which slot
    wins nor which candidates are carried). They test K1's slots and
    fetch at least the rounds they test."""
    tt = scenes[1] if tables_kind == "s128" else fine_tables
    ins = _ins(tt, seed=5)
    k1 = cc.prepare_tiles(*ins)
    pl = cc.prepare_tiles(*ins, near=near, pipelined=True)
    wrappers = {
        "outside": (cc.trace_pipelined_closest_tiles,
                    cc.trace_pipelined_any_tiles,
                    cc.trace_pipelined_pairs_tiles),
        "kernel": (cc.trace_near_closest_tiles, cc.trace_near_any_tiles,
                   cc.trace_near_pairs_tiles),
    }[near]
    for selector, wrapper, any_hit in (
        (cc.trace_closest_args, wrappers[0], False),
        (cc.trace_any_args, wrappers[1], True),
    ):
        assert selector(pl)[0] is wrapper
        want, work1 = _counted(k1, selector, any_hit)
        got, work = _counted(pl, selector, any_hit)
        _same(got, want)
        _same(wrapper(**pl), want)
        assert work["slot_tests"] == work1["slot_tests"]
    stats = {}
    cc.trace_pipelined_closest_tiles.twin(
        **cc.prepare_tiles(*ins, pipelined=True), stats=stats)
    run = {}
    cc.trace_closest_tiles.twin(**k1, stats=run)
    assert stats["staged_rounds"] >= run["table_steps"] - 8 > 0
    pairs = cc.prepare_tiles(*ins, pairs=True)
    pl_p = cc.prepare_tiles(*ins, pairs=True, near=near, pipelined=True)
    assert cc.trace_pairs_args(pl_p)[0] is wrappers[2]
    want, work1 = _counted(pairs, cc.trace_pairs_args, pairs=True)
    got, work = _counted(pl_p, cc.trace_pairs_args, pairs=True)
    _same(got, want)
    _same(wrappers[2](**pl_p), want)
    assert work["slot_tests"] >= work1["slot_tests"]
    assert (want[1] >= 0).sum() > 100


def _rays(rng, n):
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _check(jt, o, d, got, ref, min_agree=0.995):
    """Hit masks equal; faces agree on >= min_agree of hits; where they
    agree the port's t/u/v equal JAX's rederive_uv of the same face."""
    gf = got.face.numpy()
    rf = np.asarray(ref.face)
    np.testing.assert_array_equal(gf >= 0, rf >= 0)
    hits = rf >= 0
    agree = (gf == rf) & hits
    assert hits.sum() > 50
    assert agree.sum() >= min_agree * hits.sum(), agree.mean()
    jr = j_rederive_uv(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(got.t.numpy()),
        jnp.asarray(gf), jt,
    )
    for name in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy()[agree],
            np.asarray(getattr(jr, name))[agree],
            err_msg=name,
        )


def _port(tt, o, d, tmax, excl=None, **kw):
    return cc.trace_closest_clustered_cuda(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax), tt,
        None, None if excl is None else torch.from_numpy(excl), **kw,
    )


@pytest.mark.parametrize("jblk", [1, 2, 4, 8])
def test_sched_matches_pallas_sched(scenes, jblk):
    """The ray set of tests/test_cluster.py's schedule-fed kernel test
    (1000 rays, padded tail) through ``sched_rounds=jblk`` of both
    packages; with rounds of 4 also with exclusion codes."""
    jt, tt = scenes
    n = 1000
    o, d = _rays(np.random.default_rng(20 + jblk), n)
    tmax = np.full((n,), F32_MAX, np.float32)
    ref = trace_closest_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128,
        interpret=True, exact_pairs=False, sched_rounds=jblk,
        tiles_per_step=2,
    )
    _check(jt, o, d, _port(tt, o, d, tmax, sched_rounds=jblk), ref)
    if jblk == 4:
        excl = np.maximum(np.asarray(ref.face), 0).astype(np.int32)
        ref_x = trace_closest_clustered_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128,
            interpret=True, exact_pairs=False, excl_code=jnp.asarray(excl),
            sched_rounds=4, tiles_per_step=4,
        )
        _check(jt, o, d, _port(tt, o, d, tmax, excl, sched_rounds=4), ref_x)


def test_near_matches_pallas_kernel_near_and_oracle(scenes):
    """``kernel_near`` of both packages, and the threaded BVH oracle."""
    jt, tt = scenes
    n = 256
    o, d = _rays(np.random.default_rng(31), n)
    tmax = np.full((n,), F32_MAX, np.float32)
    got = _port(tt, o, d, tmax, kernel_near=True)
    ref = trace_closest_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128,
        interpret=True, exact_pairs=False, kernel_near=True,
    )
    _check(jt, o, d, got, ref)
    _check(jt, o, d, got,
           j_threaded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt))


@pytest.mark.parametrize("kernel_near", [False, True])
def test_pipelined_matches_pallas_pipelined(scenes, kernel_near):
    jt, tt = scenes
    n = 384
    o, d = _rays(np.random.default_rng(32), n)
    tmax = np.full((n,), F32_MAX, np.float32)
    ref = trace_closest_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128,
        interpret=True, exact_pairs=False, pipeline_rounds=True,
        tiles_per_step=1, lockstep=False, kernel_near=kernel_near,
    )
    _check(jt, o, d,
           _port(tt, o, d, tmax, pipelined=True, kernel_near=kernel_near),
           ref)


def test_dispatcher_routes_as_jax_does(scenes, monkeypatch):
    """``kernel_near`` goes before ``trace_sched``, which is closest-hit
    and not pairs only and does not read ``pipeline_rounds``."""
    _, tt = scenes
    ins = _ins(tt, n=256)
    seen = []
    real = cc.prepare_tiles

    def spy(*a, **kw):
        args = real(*a, **kw)
        seen.append((cc.trace_pairs_args if "a" in args
                     else cc.trace_closest_args)(args)[0])
        return args

    monkeypatch.setattr(cc, "prepare_tiles", spy)
    cases = [
        (dict(sched_rounds=4), cc.trace_sched_tiles),
        (dict(sched_rounds=4, pipelined=True), cc.trace_sched_tiles),
        (dict(sched_rounds=4, kernel_near=True), cc.trace_near_closest_tiles),
        (dict(sched_rounds=4, exact_pairs=True), cc.trace_pairs_tiles),
        (dict(sched_rounds=4, exact_pairs=True, pipelined=True),
         cc.trace_pipelined_pairs_tiles),
        (dict(kernel_near=True, exact_pairs=True), cc.trace_near_pairs_tiles),
        (dict(pipelined=True), cc.trace_pipelined_closest_tiles),
        (dict(), cc.trace_closest_tiles),
    ]
    want = cc.trace_closest_clustered_cuda(*ins)
    for kw, wrapper in cases:
        got = cc.trace_closest_clustered_cuda(*ins, **kw)
        assert seen[-1] is wrapper, kw
        np.testing.assert_array_equal(got.face.numpy(), want.face.numpy())


def _padded_clusters(tables, n_clusters):
    ct = tables.clusters
    extra = n_clusters - ct.box.shape[0]
    big = torch.finfo(torch.float32).max
    empty = torch.tensor([big] * 3 + [-big] * 3).repeat(extra, 1)
    return dataclasses.replace(tables, clusters=dataclasses.replace(
        ct,
        box=torch.cat([ct.box, empty]),
        face_id=torch.cat([ct.face_id, torch.full(
            (extra, ct.face_id.shape[1]), -1, dtype=torch.int32)]),
        mat_b=torch.cat([ct.mat_b,
                         torch.zeros((extra,) + ct.mat_b.shape[1:])]),
    ))


def test_what_the_kernels_do_not_take_raises(scenes, fine_tables):
    _, tt = scenes
    o, d, tmax, _, active, excl = _ins(tt, n=256)
    rays = (o, d, tmax)
    for kw in (dict(sched_rounds=3), dict(sched_rounds=16),
               dict(sched_rounds=4, near="kernel"),
               dict(sched_rounds=4, pipelined=True),
               dict(sched_rounds=4, pairs=True), dict(near="inside")):
        with pytest.raises(ValueError):
            cc.prepare_tiles(*rays, tt, **kw)
    with pytest.raises(ValueError):
        cc.trace_closest_clustered_cuda(*rays, tt, sched_rounds=3)
    # two-level tables: nothing gives way to K3 quietly
    two = _scene(tscene, ttm).tables("cpu", cluster_size=16, group_size=4)
    assert cc.is_two_level(two.clusters)
    for kw in (dict(sched_rounds=4), dict(pipelined=True),
               dict(kernel_near=True, pipelined=True)):
        with pytest.raises(ValueError):
            cc.trace_closest_clustered_cuda(*rays, two, **kw)
    for kw in (dict(pipelined=True), dict(kernel_near=True, pipelined=True)):
        with pytest.raises(ValueError):
            cc.trace_any_clustered_cuda(*rays, two, **kw)
    # kernel_near alone is K3 ordering its supers itself: the same faces
    _same(tuple(cc.trace_closest_clustered_cuda(*rays, two,
                                                kernel_near=True)),
          tuple(cc.trace_closest_clustered_cuda(*rays, two)))
    assert cc.prepare_tiles(*rays, two, near="kernel").variant == (
        "near_two_level")
    # K2n's cap on the number of boxes
    at_cap = _padded_clusters(fine_tables, cc.NEAR_MAX_CLUSTERS)
    near = cc.prepare_tiles(*rays, at_cap, near="kernel")
    _same(cc.trace_near_closest_tiles(**near),
          cc.trace_closest_tiles(**cc.prepare_tiles(*rays, fine_tables)))
    with pytest.raises(ValueError):
        cc.prepare_tiles(*rays, _padded_clusters(at_cap,
                                                 cc.NEAR_MAX_CLUSTERS + 1),
                         near="kernel")
    # the dict names its kernel; K2pl's wrappers take no ``pipelined``
    # (it is what they are), K2n's do, and K5 has no any-hit entry
    pl = cc.prepare_tiles(*rays, tt, pipelined=True)
    assert pl.variant == "pipelined" and "pipelined" not in pl
    with pytest.raises(TypeError):
        cc.trace_pipelined_closest_tiles(**pl, pipelined=False)
    assert cc.prepare_tiles(*rays, tt).variant == "single"
    assert cc.prepare_tiles(*rays, two).variant == "two_level"
    assert near.variant == "near" and near["pipelined"] is False
    sched = cc.prepare_tiles(*rays, tt, sched_rounds=2)
    assert sched.variant == "sched" and sched["jblk"] == 2
    with pytest.raises(ValueError):
        cc.trace_any_args(sched)


def test_launchers_refuse_other_devices_and_too_much_shared(scenes):
    """The new wrappers never hand a non-CUDA tensor to a kernel nor a
    non-CPU tensor to a twin; the launchers check the block's shared
    memory before any launch."""
    _, tt = scenes
    o, d, tmax, _, active, excl = _ins(tt, n=256)
    for kw, wrapper in (
        (dict(sched_rounds=4), cc.trace_sched_tiles),
        (dict(near="kernel"), cc.trace_near_closest_tiles),
        (dict(pipelined=True), cc.trace_pipelined_closest_tiles),
    ):
        args = cc.prepare_tiles(o, d, tmax, tt, active, excl, **kw)
        meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
                for k, v in args.items()}
        with pytest.raises(ValueError):
            wrapper(**meta)
        assert wrapper.launches == 0
    args = cc.prepare_tiles(o, d, tmax, tt, active, excl, sched_rounds=4)
    with pytest.raises(ValueError):
        cc._launch_kernel(**args)  # CPU tensors
    assert cc.staged_bytes(128, 9, 8, False) == 8 * 128 * 10 * 4
    assert cc.staged_bytes(128, 19, 1, True) == 2 * 128 * 20 * 4
    with pytest.raises(ValueError):
        cc._check_walk(256, args["inv_d"], args["t_max"], args["excl"],
                       args["snear"], args["order"], args["box"],
                       torch.zeros((args["box"].shape[0], 1024),
                                   dtype=torch.int32), 128, 0, 9, 8, False)


# --- frames ---------------------------------------------------------------


def _mini(mod, tm):
    return mod.scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def _frame(settings, cluster_size=16, group_size=0, steps=2):
    r = TRenderer(_mini(tscene, ttm), settings, base_seed=11, device="cpu")
    r.tables = _mini(tscene, ttm).tables("cpu", cluster_size=cluster_size,
                                         group_size=group_size)
    for _ in range(steps):
        r.step()
    return r.buffers.image.numpy()


BASE = dict(width=24, height=20, bounces_depth=4, sample_count=1,
            environment="procedural", sort_bounce_rays=False)
FRAME_CASES = {
    "sort": dict(sort_bounce_rays=True),
    "sort_no_slice": dict(sort_bounce_rays=True, live_slice=False),
    "sched4": dict(trace_sched=4),
    "sched8": dict(trace_sched=8),
    "near": dict(kernel_near=True),
    "pipelined": dict(pipeline_rounds=True),
    "near_pipelined": dict(kernel_near=True, pipeline_rounds=True),
    "sort_sched_near": dict(sort_bounce_rays=True, trace_sched=2,
                            kernel_near=True),
}


@pytest.fixture(scope="module")
def base_frames():
    return {nee: _frame(TSettings(next_event_estimation=nee, **BASE))
            for nee in (False, True)}


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frames_bit_identical_to_default(base_frames, case, nee):
    """Each tile-scheduling setting and the ray sort (with NEE also the
    sorted, sliced shadow legs) give the default frame bit for bit, on
    the mini scene in 16-face clusters."""
    st = TSettings(next_event_estimation=nee, **BASE)
    got = _frame(st.replace(**FRAME_CASES[case]))
    np.testing.assert_array_equal(got.view(np.int32),
                                  base_frames[nee].view(np.int32))


@pytest.mark.parametrize("kw", [
    dict(exact_pairs=True, exact_pairs_bounce=True, sort_bounce_rays=True),
    dict(exact_pairs=True, exact_pairs_bounce=True, kernel_near=True,
         pipeline_rounds=True, trace_sched=4),
], ids=["sorted", "near_pipelined"])
def test_exact_frames_bit_identical_to_default(base_frames, kw):
    got = _frame(TSettings(**BASE).replace(**kw))
    np.testing.assert_array_equal(got.view(np.int32),
                                  base_frames[False].view(np.int32))


def test_sorted_frame_matches_jax_clustered_defaults():
    """The port's sorted frame against the jitted JAX renderer with JAX's
    defaults (``sort_bounce_rays`` and ``live_slice`` on): equal sample
    counts, RMSE <= 1e-2, >= 99% of pixels equal to 1e-5 relative (jitted
    XLA contracts FMAs; tests/test_torch_render.py)."""
    kw = dict(width=32, height=24, bounces_depth=4, sample_count=1,
              environment="procedural")
    js = JSettings(traversal="clustered", **kw)
    assert js.sort_bounce_rays and js.live_slice
    jr = JRenderer(_mini(jscene, jtm), js, base_seed=2024)
    jr.step()
    jr.step()
    tr = TRenderer(_mini(tscene, ttm),
                   TSettings(sort_bounce_rays=True, live_slice=True, **kw),
                   base_seed=2024, device="cpu")
    tr.step()
    tr.step()
    want, got = np.asarray(jr.buffers.image), tr.buffers.image.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    close = float(np.mean(np.all(
        np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), 0.1), axis=-1
    )))
    assert rmse <= 1e-2, rmse
    assert close >= 0.99, close
    assert tr.last_rays == jr.last_rays


@pytest.mark.parametrize("kw", [
    dict(trace_sched=3), dict(trace_sched=16), dict(trace_sched=-1),
], ids=lambda kw: str(kw["trace_sched"]))
def test_bad_trace_sched_raises(kw):
    with pytest.raises(ValueError):
        TRenderer(_mini(tscene, ttm), TSettings(width=8, height=8, **kw),
                  base_seed=0, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(trace_sched=4), dict(kernel_near=True), dict(pipeline_rounds=True),
], ids=lambda kw: next(iter(kw)))
def test_scheduling_settings_raise_on_two_level_tables(kw):
    """``trace_sched`` and ``pipeline_rounds`` are single-level kernels and
    raise, under either ``kernel_near``; ``kernel_near`` itself is K3
    ordering its supers in the kernel, and renders the frame of the
    outside order bit for bit."""
    def run(**more):
        st = TSettings(width=8, height=8, bounces_depth=3, **{**kw, **more})
        r = TRenderer(_mini(tscene, ttm), st, base_seed=0, device="cpu")
        r.tables = _mini(tscene, ttm).tables("cpu", cluster_size=16,
                                             group_size=4)
        r.step()
        return r.buffers.image.numpy()

    if "kernel_near" in kw:
        np.testing.assert_array_equal(
            run().view(np.int32), run(kernel_near=False).view(np.int32))
        return
    for near in (True, False):
        with pytest.raises(ValueError):
            run(kernel_near=near)
