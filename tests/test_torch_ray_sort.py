"""PyTorch port: the ray sort (ops/ray_sort.py) against the JAX package and
against the unsorted trace.

The coherence key and the permutation must equal the JAX package's
exactly (int32 for int32): both are integer results of the same f32 slab
arithmetic. The sorted trace is a pure reordering, so every result must
equal the unsorted trace bit for bit, through the full-width branch, the
sliced branch (``live_slice``) and the overflow case that falls back to
the full width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops import ray_sort as jrs
from webgpu_raytracing_tpu.ops.cluster_trace import (
    trace_closest_clustered as j_clustered,
)
from webgpu_raytracing_tpu_torch.config import RenderSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort

torch.set_num_threads(1)


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
def tables():
    """The port's tables of the tests/test_cluster.py scene in clusters
    of 8, single-level and two-level (supers of 4)."""
    sc = _scene(tscene, ttm)
    return (sc.tables("cpu", cluster_size=8, group_size=0),
            sc.tables("cpu", cluster_size=8, group_size=4))


def _rays(n, seed, dead=0.2, away=0.2):
    """Live rays, dead lanes (t_max = 0), rays that enter no box (aimed
    away from above the scene: keyless), NaN origins and zero direction
    components."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    # aimed at the sphere and the cube, so that most live rays enter boxes
    aim = rng.uniform((-1.2, -1.2, -5.0), (1.2, 1.2, 1.0), (n, 3))
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = rng.uniform(size=n)
    keyless = kind < away
    o[keyless] = o[keyless] + np.array([0, 30, 0], np.float32)
    d[keyless, 1] = np.abs(d[keyless, 1]) + 0.1
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = ~((kind >= away) & (kind < away + dead))
    o[rng.uniform(size=n) < 0.02, 0] = np.nan
    d[::17, 2] = 0.0
    return o, d, tmax, active


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("level", ["single", "two_level"])
@pytest.mark.parametrize("chunk", [65536, 512])
def test_key_and_permutation_equal_jax(tables, level, chunk):
    tt = tables[level == "two_level"]
    boxes = tt.clusters.sort_box
    assert boxes is (tt.clusters.super_box if level == "two_level"
                     else tt.clusters.box)
    n = 1500
    o, d, tmax, active = _rays(n, 7)
    tm = np.where(active, tmax, 0.0).astype(np.float32)
    got = ray_sort.nearest_cluster_key(*_t(o, d, tm), boxes, chunk=chunk)
    want = np.asarray(jrs.nearest_cluster_key(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
        jnp.asarray(boxes.numpy()), chunk=chunk))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    c = boxes.shape[0]
    miss = want >= c * (c + 1)
    # dead lanes outside every box and NaN origins have no key (a dead
    # lane inside a box still "enters" it at a negative distance)
    assert miss[np.isnan(o).any(1)].all() and miss[~active].mean() > 0.5
    assert 0.2 < miss.mean() < 0.8 and len(np.unique(want)) > 10
    perm = torch.sort(got, stable=True)[1].numpy()
    _, jperm = jax.lax.sort(
        (jnp.asarray(want), jnp.arange(n, dtype=jnp.int32)), num_keys=1,
        is_stable=True)
    np.testing.assert_array_equal(perm, np.asarray(jperm))


def test_permute_rows():
    perm = torch.tensor([2, 0, 1])
    a, b = torch.arange(3.0), torch.arange(6).reshape(3, 2)
    out = ray_sort.permute_rows(perm, {"a": a, "t": (b, None)})
    assert out["a"].tolist() == [2.0, 0.0, 1.0] and out["t"][1] is None
    assert out["t"][0].tolist() == [[4, 5], [0, 1], [2, 3]]
    want = jrs.permute_rows(jnp.asarray(perm.numpy()),
                            {"a": jnp.asarray(a.numpy())})
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(want["a"]))


def _closest_fn(tile=128):
    def fn(o, d, tm, tb, act, ex=None):
        return cc.trace_closest_clustered_cuda(o, d, tm, tb, act,
                                               excl_code=ex, tile=tile,
                                               raw=True)
    return fn


def _miss_tail(tm_tail):
    return tm_tail, torch.full_like(tm_tail, -1, dtype=torch.int32)


def _profiled(fn):
    """(what ``fn`` returns, one record per sorted leg it ran: ray count,
    traced width, branch, and the live count where it was read)."""
    recs, live = [], [None]
    count, unsort = ray_sort.live_count, ray_sort.unsort

    def spy_count(*a):
        live[0] = count(*a)
        return live[0]

    def spy_unsort(perm, leaves, rest=None):
        r, w = perm.shape[0], leaves[0].shape[0]
        assert (rest is None) == (w == r)
        recs.append(dict(rays=r, width=w, live=live[0],
                         branch="sliced" if w < r else "full"))
        live[0] = None
        return unsort(perm, leaves, rest)

    ray_sort.live_count, ray_sort.unsort = spy_count, spy_unsort
    try:
        return fn(), recs
    finally:
        ray_sort.live_count, ray_sort.unsort = count, unsort


def _same(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("level", ["single", "two_level"])
@pytest.mark.parametrize("case", ["full", "sliced", "overflow"])
def test_sorted_trace_equals_unsorted(tables, level, case):
    """(t, face) of the sorted trace, with exclusion codes as ``extra``,
    equal the unsorted trace bit for bit: without a slice; on the sliced
    branch (1536 rays, about 65 % dead or keyless, slice 0.5); and when
    the live rays overflow the slice and the full width is traced."""
    tt = tables[level == "two_level"]
    n = 1536
    if case == "overflow":
        o, d, tmax, active = _rays(n, 8, dead=0.05, away=0.05)
    else:
        o, d, tmax, active = _rays(n, 8, dead=0.3, away=0.3)
    excl = np.random.default_rng(9).integers(
        -1, tt.clusters.face_id.numel(), n).astype(np.int32)
    o, d, tmax, active, excl = _t(o, d, tmax, active, excl)
    want = cc.trace_closest_clustered_cuda(o, d, tmax, tt, active, excl,
                                           raw=True)
    ls = None if case == "full" else 0.5
    got, prof = _profiled(lambda: ray_sort.sorted_trace(
        _closest_fn(), o, d, tmax, tt, active, extra=excl, live_slice=ls,
        tail=_miss_tail))
    _same(got, want)
    assert (want[1] >= 0).sum() > 50
    (rec,) = prof
    assert rec["rays"] == n
    if case == "full":
        assert rec["branch"] == "full" and rec["live"] is None
    elif case == "sliced":
        assert rec["branch"] == "sliced" and rec["width"] == 768
        assert 0 < rec["live"] <= 768
    else:
        assert rec["branch"] == "full" and rec["live"] > 768
        assert rec["width"] == n
    # the sliced result is the full branch's, bit for bit
    if case == "sliced":
        full = ray_sort.sorted_trace(_closest_fn(), o, d, tmax, tt, active,
                                     extra=excl)
        _same(got, full)


def test_sorted_trace_width_rule_and_no_extra(tables):
    """The traced width is ceil(r * f / 128) * 128 (JAX's rule), also for
    an r that is not a multiple of 128; a leg without ``extra`` and a
    single-tensor result (any-hit, with the clear tail) work alike."""
    tt = tables[0]
    n = 1100
    o, d, tmax, active = _t(*_rays(n, 10, dead=0.4, away=0.4))
    want = cc.trace_any_clustered_cuda(o, d, tmax, tt, active)

    def fn(o_, d_, tm_, tb_, act_):
        return cc.trace_any_clustered_cuda(o_, d_, tm_, tb_, act_)

    got, prof = _profiled(lambda: ray_sort.sorted_trace(
        fn, o, d, tmax, tt, active, live_slice=0.375,
        tail=lambda tm: torch.zeros_like(tm, dtype=torch.bool)))
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 20 < int(want.sum()) < n
    assert prof[0]["width"] == ((int(n * 0.375) + 127) // 128) * 128 == 512
    assert prof[0]["branch"] == "sliced"


def test_sorted_trace_matches_jax_sorted_trace(tables):
    """The JAX ``sorted_trace`` over the XLA clustered trace and the
    port's over the twins, both sliced: the same hit mask, the same faces
    on at least 99.5 % of the hits (the clustered trace re-adjudicates
    exactly, so knife edges are rare), t equal where faces agree."""
    sc = _scene(jscene, jtm)
    jt = sc.tables()
    tt = _scene(tscene, ttm).tables("cpu")
    n = 1280
    o, d, tmax, active = _rays(n, 12, dead=0.3, away=0.3)

    def jfn(o_, d_, tm_, tb_, act_):
        h = j_clustered(o_, d_, tm_, tb_, act_, tile=128)
        return h.t, h.face

    jt_, jf = jrs.sorted_trace(
        jfn, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt,
        jnp.asarray(active), live_slice=0.5,
        tail=lambda tm: (tm, jnp.full(tm.shape, -1, jnp.int32)))

    def tfn(o_, d_, tm_, tb_, act_):
        h = cc.trace_closest_clustered_cuda(o_, d_, tm_, tb_, act_)
        return h.t, h.face

    (t, f), prof = _profiled(lambda: ray_sort.sorted_trace(
        tfn, *_t(o, d, tmax), tt, _t(active)[0], live_slice=0.5,
        tail=_miss_tail))
    assert prof[0]["branch"] == "sliced"
    jf, jt_ = np.asarray(jf), np.asarray(jt_)
    np.testing.assert_array_equal(f.numpy() >= 0, jf >= 0)
    hits = jf >= 0
    agree = (f.numpy() == jf) & hits
    assert hits.sum() > 100 and agree.sum() >= 0.995 * hits.sum()
    np.testing.assert_array_equal(t.numpy()[agree], jt_[agree])
    np.testing.assert_array_equal(t.numpy()[~hits], jt_[~hits])


@pytest.mark.parametrize("seg", [1, 2])
@pytest.mark.parametrize("exact", [False, True], ids=["plain", "exact"])
def test_integrator_legs_sorted_equal_unsorted(tables, seg, exact):
    """``integrator.trace_closest`` and ``trace_any`` with ``sort`` (and
    the segment's slice) return the unsorted legs bit for bit: Hit t, u,
    v, face (exact: the adjudicated ones) and the blocked flags."""
    tt = tables[0]
    n = 1408
    o, d, tmax, active = _rays(n, 13 + seg, dead=0.35, away=0.35)
    tmax[:] = F32_MAX
    excl = np.random.default_rng(14).integers(
        -1, tt.clusters.face_id.numel(), n).astype(np.int32)
    o, d, tmax, active, excl = _t(o, d, tmax, active, excl)
    st = RenderSettings(exact_pairs=exact, exact_pairs_bounce=exact,
                        sort_bounce_rays=True, live_slice=True)
    want = integrator.trace_closest(o, d, tmax, tt, st, active, excl)
    got, prof = _profiled(lambda: integrator.trace_closest(
        o, d, tmax, tt, st, active, excl, sort=True, seg=seg))
    _same(tuple(got), tuple(want))
    assert (want.face >= 0).sum() > 50
    frac = 0.75 if seg == 1 else 0.5
    if exact:  # the exact leg is sorted but never sliced
        assert prof[0]["branch"] == "full" and prof[0]["live"] is None
    else:
        assert prof[0]["width"] == ((int(n * frac) + 127) // 128) * 128
    # sort_bounce_rays off: sort=True changes nothing and sorts nothing
    off, prof = _profiled(lambda: integrator.trace_closest(
        o, d, tmax, tt, st.replace(sort_bounce_rays=False), active, excl,
        sort=True, seg=seg))
    _same(tuple(off), tuple(want))
    assert prof == []
    if not exact:
        want_any = integrator.trace_any(o, d, tmax, tt, st, active, excl)
        got_any, prof = _profiled(lambda: integrator.trace_any(
            o, d, tmax, tt, st, active, excl, sort=True, seg=seg))
        assert torch.equal(got_any, want_any)
        frac = 0.375 if seg == 1 else 0.25
        assert prof[0]["width"] in (((int(n * frac) + 127) // 128) * 128, n)
