"""PyTorch port: the binned and multipass traces (ops/ray_sort.py
``binned_trace``, ``binned_trace_any``, ``sorted_trace_multipass``), K4's
twin and the drain hooks ``t_start``, ``start_code``, ``cap`` and
``return_stop`` (ops/cluster_cuda.py), against the JAX package and against
the port's own plain traces.

Everything here runs the kernels' plain-torch twins on CPU tensors; the
CUDA kernels are held against the twins on the card in
tests/test_torch_cuda.py. Integer results of the same f32 slab arithmetic
(the packed keys, the block schedules) must equal the JAX package's int32
for int32, and the masked tile distances value for value. The three traces
are regroupings of one search, so their faces and the t, u, v re-derived
from them must equal the port's sorted and unsorted traces bit for bit;
which branch ran (mid pass or not, sliced or full-width drain) is read
from the run and asserted. Against the Pallas kernels under the
interpreter the tolerances are those of tests/test_torch_trace.py and
tests/test_torch_anyhit.py: hit masks equal and faces equal on at least
99.5 % of hits (bf16 knife edges), blocked flags equal on at least 98 % of
live rays."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops import ray_sort as jrs
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_binned_pass as j_binned_pass,
)
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu.ops.cluster_trace import (
    tile_nears_fused as j_tile_nears,
)
from webgpu_raytracing_tpu_torch.config import RenderSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.models.scene import tables_from_numpy
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort
from webgpu_raytracing_tpu_torch.ops.cluster_trace import (
    rederive_uv,
    tile_nears_fused,
)
from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir
from webgpu_raytracing_tpu_torch.renderer import Renderer

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
    """tests/test_cluster.py's scene: the JAX tables and the same arrays
    as port tables (clusters of 128)."""
    jt = _scene(jscene, jtm).tables()
    arrays = {k: np.asarray(getattr(jt, k)) for k in TABLE_FIELDS}
    for k in ("box", "mat_b", "face_id", "partner_code"):
        arrays["clusters." + k] = np.asarray(getattr(jt.clusters, k))
    return jt, tables_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def fine():
    """The same scene in the port's single-level clusters of 8 (blocks of
    128 sorted rays then span many clusters, so schedules overflow) and in
    two-level tables over them (supers of 4)."""
    sc = _scene(tscene, ttm)
    return (sc.tables("cpu", cluster_size=8, group_size=0),
            sc.tables("cpu", cluster_size=8, group_size=4))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _mixed(n, seed, dead=0.2, away=0.2):
    """Live rays aimed at the scene, dead lanes, rays that enter no box,
    NaN origins, zero direction components, bounded and unbounded t_max
    → o, d, t_max with the dead lanes' zeroed."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    aim = rng.uniform((-1.2, -1.2, -5.0), (1.2, 1.2, 1.0), (n, 3))
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = rng.uniform(size=n)
    keyless = kind < away
    o[keyless] = o[keyless] + np.array([0, 30, 0], np.float32)
    d[keyless, 1] = np.abs(d[keyless, 1]) + 0.1
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    tmax[(kind >= away) & (kind < away + dead)] = 0.0
    o[rng.uniform(size=n) < 0.02, 0] = np.nan
    d[::17, 2] = 0.0
    return o, d, tmax


def _uniform(n, seed, n_codes):
    """tests/test_cluster.py's binned and multipass set: uniform origins,
    random directions, unbounded t_max, a tenth of the lanes dead, random
    exclusion codes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full((n,), F32_MAX, np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = rng.integers(-1, n_codes, size=n).astype(np.int32)
    return o, d, tmax, active, excl


def _aimed(n):
    """tests/test_cluster.py's aimed set: from a shell of radius 12 through
    the scene's interior, every ray crossing many clusters."""
    rng = np.random.default_rng(0)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 12).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.full((n,), F32_MAX, np.float32), None, None


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


# ---- the keys, the schedules and the masked tile distances vs JAX ----


@pytest.mark.parametrize("n_keys", [2, 3])
@pytest.mark.parametrize("chunk", [65536, 512])
def test_keys2_equal_jax(fine, n_keys, chunk):
    boxes = fine[0].clusters.box
    o, d, tm = _mixed(1500, 21)
    got = ray_sort.nearest_cluster_keys2(*_t(o, d, tm), boxes, chunk=chunk,
                                         n=n_keys)
    want = jrs.nearest_cluster_keys2(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
        jnp.asarray(boxes.numpy()), chunk=chunk, n=n_keys)
    assert len(got) == len(want) == n_keys
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c = boxes.shape[0]
    cid1 = ray_sort._cid_of(got[0], c).numpy()
    assert 0.2 < (cid1 == c).mean() < 0.8 and len(np.unique(cid1)) > 10
    # the combined key is the two decoded ids
    key = ray_sort.nearest_cluster_key(*_t(o, d, tm), boxes, chunk=chunk)
    np.testing.assert_array_equal(
        key.numpy(),
        cid1 * (c + 1) + ray_sort._cid_of(got[1], c).numpy())


@pytest.mark.parametrize("chunk", [65536, 512])
def test_key_with_t_start_equals_jax(fine, chunk):
    """``nearest_cluster_key(t_start=)``: entries below a ray's t_start are
    left out; 0 masks nothing and NaN everything."""
    boxes = fine[0].clusters.box
    n = 1500
    o, d, tm = _mixed(n, 22, dead=0.1, away=0.1)
    rng = np.random.default_rng(23)
    ts = rng.uniform(0.0, 6.0, n).astype(np.float32)
    ts[::5] = 0.0
    ts[3::11] = np.nan
    got = ray_sort.nearest_cluster_key(*_t(o, d, tm), boxes, chunk=chunk,
                                       t_start=_t(ts)[0])
    want = np.asarray(jrs.nearest_cluster_key(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
        jnp.asarray(boxes.numpy()), chunk=chunk, t_start=jnp.asarray(ts)))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = ray_sort.nearest_cluster_key(*_t(o, d, tm), boxes).numpy()
    c = boxes.shape[0]
    np.testing.assert_array_equal(want[ts == 0], plain[ts == 0])
    assert (want[np.isnan(ts)] == c * (c + 1) + c).all()
    assert (want != plain).mean() > 0.2


@pytest.mark.parametrize("ordered", [True, False])
def test_block_schedules_equal_jax(ordered):
    rng = np.random.default_rng(24)
    c, tile, n_blocks = 40, 128, 24
    cid = rng.integers(0, c + 1, tile * n_blocks).astype(np.int32)
    cid[-3 * tile:] = c  # blocks of dead lanes
    cid[:tile] = 7  # a block of one cluster
    if ordered:
        cid = np.sort(cid, kind="stable")
    sched, flag = ray_sort._block_schedules(_t(cid)[0], n_blocks, tile, c)
    jsched, jflag = jrs._block_schedules(jnp.asarray(cid), n_blocks, tile, c)
    assert sched.dtype == torch.int32 and flag.dtype == torch.bool
    np.testing.assert_array_equal(sched.numpy(), np.asarray(jsched))
    np.testing.assert_array_equal(flag.numpy(), np.asarray(jflag))
    assert (sched.numpy()[-1] == -1).all() and not flag.all()
    if not ordered:
        assert sched.numpy()[0].tolist() == [7, -1]


def test_tile_nears_t_start_equals_jax(scenes, fine):
    for tt in (scenes[1], fine[0]):
        boxes = tt.clusters.box
        n = 640
        o, d, tm = _mixed(n, 25, dead=0.1, away=0.1)
        rng = np.random.default_rng(26)
        ts = rng.uniform(0.0, 5.0, n).astype(np.float32)
        ts[::4] = 0.0
        ts[1::9] = np.nan
        inv = safe_inv_dir(torch.from_numpy(d))
        got = tile_nears_fused(torch.from_numpy(o), inv, torch.from_numpy(tm),
                               boxes, 128, max_elems=128 * 7,
                               t_start=torch.from_numpy(ts))
        want = np.asarray(j_tile_nears(
            jnp.asarray(o), jnp.asarray(inv.numpy()), jnp.asarray(tm),
            jnp.asarray(boxes.numpy()), 128, t_start=jnp.asarray(ts)))
        np.testing.assert_array_equal(got.numpy(), want)
        plain = tile_nears_fused(torch.from_numpy(o), inv,
                                 torch.from_numpy(tm), boxes, 128).numpy()
        assert (want >= plain).all() and (want > plain).mean() > 0.05


# ---- K4's twin ----


def _sorted_stream(tt, o, d, tm, excl):
    """The rays sorted by nearest cluster, and their block schedules, made
    by the port's functions → (o, d, t_max, excl, sched, flag, perm)."""
    boxes = tt.clusters.box
    c = boxes.shape[0]
    k1, _ = ray_sort.nearest_cluster_keys2(o, d, tm, boxes)
    cid_s, perm = ray_sort.sort_keys(ray_sort._cid_of(k1, c))
    sched, flag = ray_sort._block_schedules(cid_s, o.shape[0] // 128, 128, c)
    return (*ray_sort.permute_rows(perm, (o, d, tm, excl)), sched, flag, perm)


def test_binned_twin_matches_pallas_binned_pass(scenes):
    """K4's twin against ``trace_binned_pass(interpret=True)`` on the same
    sorted stream and schedules, with dead lanes and exclusion codes: hit
    masks equal, faces equal on at least 99.5 % of the hits. (The Pallas
    kernel tests a scheduled cluster with no box test and the twin only
    through K1's gate; a triangle lies inside its cluster's box, so the
    two differ on knife edges alone.)"""
    jt, tt = scenes
    n = 2048
    o, d, tmax, active, excl = _uniform(n, 27, tt.clusters.face_id.numel())
    tm = np.where(active, tmax, 0.0).astype(np.float32)
    o_s, d_s, tm_s, ex_s, sched, flag, _ = _sorted_stream(
        tt, *_t(o, d, tm, excl))
    assert (sched[:, 1] >= 0).sum() > 0 and (sched[:, 0] < 0).sum() > 0
    stats = {}
    t_twin, code = cc.trace_binned_tiles.twin(
        **cc.binned_args(o_s, d_s, tm_s, tt, sched, ex_s), stats=stats)
    t_got, face = cc.trace_binned_pass(o_s, d_s, tm_s, tt, sched, ex_s)
    _same(t_got, t_twin)
    _same(face, cc.code_to_face(code, tt.clusters.face_id))
    _, jface = j_binned_pass(
        jnp.asarray(o_s.numpy()), jnp.asarray(d_s.numpy()),
        jnp.asarray(tm_s.numpy()), jt, jnp.asarray(sched.numpy()),
        excl_code=jnp.asarray(ex_s.numpy()), interpret=True,
        blocks_per_step=8)
    jface, face = np.asarray(jface), face.numpy()
    np.testing.assert_array_equal(face >= 0, jface >= 0)
    hits = jface >= 0
    assert hits.sum() > 200
    assert ((face == jface) & hits).sum() >= 0.995 * hits.sum()
    # dead lanes keep (0, -1), misses their t_max
    dead = tm_s.numpy() == 0
    assert (face[dead] == -1).all() and (t_got.numpy()[dead] == 0).all()
    np.testing.assert_array_equal(t_got.numpy()[face < 0], tm_s.numpy()[face < 0])
    work = cc.walk_stats(stats, tt.clusters.face_id, any_hit=False)
    assert stats["table_steps"] == n // 128 and stats["rays"] == n
    assert 0 < work["box_tests"] <= 2 * n and work["slot_tests"] > 0


def test_binned_twin_carries_the_best_in(fine):
    """The two schedule entries run as two passes, the second from the
    (t, code) the first carried (``start_code``), give the one pass's
    result; a block whose first entry is -1 runs its second."""
    tt = fine[0]
    o, d, tmax, active, excl = _uniform(1536, 28, tt.clusters.face_id.numel())
    tm = np.where(active, tmax, 0.0).astype(np.float32)
    o_s, d_s, tm_s, ex_s, sched, flag, _ = _sorted_stream(
        tt, *_t(o, d, tm, excl))
    assert not flag.all()  # clusters of 8: blocks span more than two
    one = cc.trace_binned_pass(o_s, d_s, tm_s, tt, sched, ex_s, codes=True)
    none = torch.full_like(sched[:, :1], -1)
    ta, ca = cc.trace_binned_pass(
        o_s, d_s, tm_s, tt, torch.cat([none, sched[:, 1:]], 1), ex_s,
        codes=True)
    two = cc.trace_binned_pass(
        o_s, d_s, ta, tt, torch.cat([sched[:, :1], none], 1), ex_s,
        start_code=ca, codes=True)
    _same(two, one)
    assert 0 < (ca >= 0).sum() < (one[1] >= 0).sum()
    with pytest.raises(ValueError):
        cc.binned_args(o_s[:100], d_s[:100], tm_s[:100], tt, sched[:1])
    with pytest.raises(ValueError):
        cc.binned_args(o_s, d_s, tm_s, fine[1], sched)


# ---- the traces against the sorted and unsorted traces ----


def _drain(**fixed):
    def fn(o, d, tm, tb, act, excl_code=None, **hooks):
        fn.widths.append(o.shape[0])
        return cc.trace_closest_clustered_cuda(
            o, d, tm, tb, act, excl_code=excl_code, raw="code", **fixed,
            **hooks)

    fn.widths = []
    return fn


def _drain_any(**fixed):
    def fn(o, d, tm, tb, act, excl_code=None, t_start=None):
        fn.widths.append(o.shape[0])
        return cc.trace_any_clustered_cuda(
            o, d, tm, tb, act, excl_code=excl_code, t_start=t_start, **fixed)

    fn.widths = []
    return fn


def _spied(monkeypatch):
    """Records of a run: the survivor counts read and the K4 passes made."""
    rec = dict(counts=[], passes=0)
    count, k4 = ray_sort.survivor_count, ray_sort.trace_binned_pass

    def spy_count(surv):
        rec["counts"].append(count(surv))
        return rec["counts"][-1]

    def spy_k4(*a, **kw):
        rec["passes"] += 1
        return k4(*a, **kw)

    monkeypatch.setattr(ray_sort, "survivor_count", spy_count)
    monkeypatch.setattr(ray_sort, "trace_binned_pass", spy_k4)
    return rec


def _closest_refs(tt, o, d, tmax, active, excl):
    """(unsorted, sorted) Hits of the port's plain traces."""
    unsorted = cc.trace_closest_clustered_cuda(o, d, tmax, tt, active, excl)

    def tf(o_, d_, tm_, tb_, act_, ex_=None):
        return cc.trace_closest_clustered_cuda(o_, d_, tm_, tb_, act_,
                                               excl_code=ex_, raw=True)

    t, f = ray_sort.sorted_trace(tf, o, d, tmax, tt, active, extra=excl)
    return unsorted, rederive_uv(o, d, t, f, tt)


BINNED_CASES = {
    # rays, surv_frac → (the mid pass runs, the drain takes its slice)
    "uniform_3": ("uniform", 3, False, False),
    "aimed_4": ("aimed", 4, True, True),
    "aimed_1000": ("aimed", 1000, True, False),
    "mixed_3": ("mixed", 3, True, True),
    "mixed_1000": ("mixed", 1000, True, False),
    "sparse_3": ("sparse", 3, False, False),
}


@pytest.mark.parametrize("kind", ["s128", "s8"])
@pytest.mark.parametrize("case", sorted(BINNED_CASES))
def test_binned_trace_equals_sorted_and_unsorted(scenes, fine, monkeypatch,
                                                 kind, case):
    """``binned_trace`` = ``sorted_trace`` = the unsorted trace: faces and
    the re-derived t, u, v, bit for bit, on tests/test_cluster.py's
    uniform set (dead lanes, exclusion codes; 2000 rays, so the stream is
    padded) and aimed set, on a mixed set (bounded and unbounded t_max,
    NaN origins, zero direction components), and on a sparse set whose
    live rays mostly enter no box. A live ray that has missed so far
    survives whatever it has left (JAX's stop formula), so the uniform and
    sparse sets overflow the mid pass's half-width slice. The
    branches are read from the run: the survivor counts against the slice
    widths, the number of K4 passes, the width the drain ran at."""
    tt = scenes[1] if kind == "s128" else fine[0]
    rays, frac, mid_runs, sliced = BINNED_CASES[case]
    n = 2000
    if rays == "uniform":
        ins = _uniform(n, 29, tt.clusters.face_id.numel())
    elif rays == "aimed":
        ins = _aimed(n)
    elif rays == "mixed":
        ins = (*_mixed(n, 30, dead=0.2, away=0.1), None, None)
    else:
        o, d, tm = _mixed(n, 30, dead=0.05, away=0.75)
        tm[tm > 0] = F32_MAX
        ins = (o, d, tm, None, None)
    o, d, tmax, active, excl = (
        None if x is None else torch.from_numpy(x) for x in ins)
    unsorted, sorted_ = _closest_refs(tt, o, d, tmax, active, excl)
    _same(tuple(sorted_), tuple(unsorted))
    rec = _spied(monkeypatch)
    fn = _drain()
    t, face = ray_sort.binned_trace(fn, o, d, tmax, tt, active, extra=excl,
                                    surv_frac=frac)
    _same(tuple(rederive_uv(o, d, t, face, tt)), tuple(unsorted))
    assert (face >= 0).sum() > 50
    r = 2048
    w1, w2 = 1024, ray_sort._slice_width(r, frac, 128)
    assert (rec["counts"][0] <= w1) == mid_runs
    assert rec["passes"] == (2 if mid_runs else 1)
    assert (rec["counts"][1] <= w2) == sliced
    assert fn.widths == [w2 if sliced else r]
    assert w2 == (768 if frac == 3 else 512 if frac == 4 else 128)
    assert rec["counts"][1] <= rec["counts"][0]
    if kind == "s128" and mid_runs:  # the mid pass finishes some rays
        assert rec["counts"][1] < rec["counts"][0]


def test_binned_trace_with_other_drains(fine):
    """The drain of a binned leg may be K2n (``t_start`` and the carried
    code go into the kernel's ranking half and search) or K2pl; K5 takes no
    carried code and raises."""
    tt = fine[0]
    o, d, tmax, active, excl = _t(*_uniform(
        1024, 31, tt.clusters.face_id.numel()))
    want = cc.trace_closest_clustered_cuda(o, d, tmax, tt, active, excl,
                                           raw=True)
    for kw in (dict(kernel_near=True), dict(pipelined=True),
               dict(kernel_near=True, pipelined=True)):
        got = ray_sort.binned_trace(_drain(**kw), o, d, tmax, tt, active,
                                    extra=excl)
        _same(got, want)
    with pytest.raises(ValueError):
        ray_sort.binned_trace(_drain(sched_rounds=4), o, d, tmax, tt, active,
                              extra=excl)


@pytest.mark.parametrize("kind", ["s128", "s8"])
@pytest.mark.parametrize("rays", ["unbounded", "bounded", "mixed"])
def test_binned_any_blocked_set(scenes, fine, monkeypatch, kind, rays):
    """``binned_trace_any`` gives exactly the blocked set of the port's
    sorted and unsorted any-hit traces, for tests/test_cluster.py's
    (surv_frac, mid) cases on its unbounded (env-NEE-like) and bounded
    (light-NEE-like) sets and on the mixed set, whose survivors overflow
    the smallest slice; with clusters of 128 also the set of the JAX
    ``binned_trace_any`` over the Pallas kernels under the interpreter, on
    at least 98 % of the live rays (the knife-edge share that
    tests/test_torch_anyhit.py documents)."""
    jt, _ = scenes
    tt = scenes[1] if kind == "s128" else fine[0]
    n = 2000
    o, d, tmax, active, excl = _uniform(n, 32, tt.clusters.face_id.numel())
    if rays == "bounded":
        tmax = np.random.default_rng(33).uniform(0.5, 6.0, n).astype(
            np.float32)
    elif rays == "mixed":
        o, d, tmax = _mixed(n, 30, dead=0.2, away=0.1)
        active = tmax > 0
    to, td, ttm_, tact, tex = _t(o, d, tmax, active, excl)
    want = cc.trace_any_clustered_cuda(to, td, ttm_, tt, tact, tex)

    def fn(o_, d_, tm_, tb_, act_, ex_=None):
        return cc.trace_any_clustered_cuda(o_, d_, tm_, tb_, act_,
                                           excl_code=ex_)

    assert torch.equal(
        ray_sort.sorted_trace(fn, to, td, ttm_, tt, tact, extra=tex), want)
    assert 100 < int(want.sum()) < n - 100
    rec = _spied(monkeypatch)
    for frac, mid in ((4, False), (4, True), (1000, False)):
        rec["counts"].clear()
        rec["passes"] = 0
        drain = _drain_any()
        got = ray_sort.binned_trace_any(drain, to, td, ttm_, tt, tact,
                                        extra=tex, surv_frac=frac, mid=mid)
        assert got.dtype == torch.bool and torch.equal(got, want)
        assert rec["passes"] == (2 if mid else 1)
        w2 = ray_sort._slice_width(2048, frac, 128)
        assert drain.widths == [w2 if rec["counts"][-1] <= w2 else 2048]
        if frac == 1000 and rays == "mixed" and kind == "s8":
            assert drain.widths == [2048]  # the survivors overflow 128
        elif frac == 4:
            assert drain.widths == [512]
    if kind != "s128" or rays == "mixed":
        return
    jfn = functools.partial(
        trace_closest_clustered_pallas, interpret=True, tile=128,
        tiles_per_step=4, any_hit=True, exact_pairs=False, lockstep=True,
        derive_uv=False)
    jgot = np.asarray(jrs.binned_trace_any(
        jfn, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt,
        jnp.asarray(active), extra=jnp.asarray(excl), surv_frac=4,
        interpret=True))
    agree = (jgot == want.numpy())[active].mean()
    print(f"binned any-hit vs JAX: {agree:.5f} of {active.sum()} live rays")
    assert agree >= 0.98 and not jgot[~active].any()


MULTIPASS_CASES = [(1, 2, 8), (2, 3, 8), (4, 2, 8), (1, 2, 1000),
                   (4, 2, 2000)]


@pytest.mark.parametrize("kind", ["s128", "s8"])
def test_multipass_equals_sorted_and_unsorted(scenes, fine, monkeypatch,
                                              kind):
    """``sorted_trace_multipass`` for tests/test_cluster.py's five (cap,
    passes, surv_frac) cases on its uniform set, the aimed set that
    overflows the smallest slice, and a run of one tile: (t, face) equal
    the sorted and unsorted traces bit for bit. The second pass's width
    says which branch ran."""
    tt = scenes[1] if kind == "s128" else fine[0]
    n = 2000
    o, d, tmax, active, excl = _t(*_uniform(
        n, 34, tt.clusters.face_id.numel()))
    unsorted, sorted_ = _closest_refs(tt, o, d, tmax, active, excl)
    _same(tuple(sorted_), tuple(unsorted))
    want = (unsorted.t, unsorted.face)
    rec = _spied(monkeypatch)
    for cap, passes, frac in MULTIPASS_CASES:
        rec["counts"].clear()
        fn = _drain()
        t, f = ray_sort.sorted_trace_multipass(
            fn, o, d, tmax, tt, active, extra=excl, cap=cap, passes=passes,
            surv_frac=frac)
        _same(tuple(rederive_uv(o, d, t, f, tt))[:1] + (f,), want)
        if passes == 2:
            w2 = ray_sort._slice_width(n, frac, 128)
            sliced = rec["counts"][0] <= w2
            assert fn.widths == [n, w2 if sliced else n]
        else:
            assert fn.widths == [n] * passes and rec["counts"] == []
    ao, ad, atm = _t(*_aimed(n)[:3])
    a_want = cc.trace_closest_clustered_cuda(ao, ad, atm, tt, raw=True)
    rec["counts"].clear()
    fn = _drain()
    _same(ray_sort.sorted_trace_multipass(fn, ao, ad, atm, tt, cap=1,
                                          passes=2, surv_frac=1000), a_want)
    if kind == "s8":
        assert rec["counts"][0] > 128 and fn.widths == [n, n]
    m = 128  # one tile: the slice is the whole width
    s_want = cc.trace_closest_clustered_cuda(o[:m], d[:m], tmax[:m], tt,
                                             active[:m], excl[:m], raw=True)
    _same(ray_sort.sorted_trace_multipass(
        _drain(), o[:m], d[:m], tmax[:m], tt, active[:m], extra=excl[:m],
        cap=1, passes=2, surv_frac=8), s_want)


@pytest.mark.parametrize("kind", ["s128", "s8"])
def test_capped_stop_covers_all_changes(scenes, fine, kind):
    """Every ray whose capped result differs from the uncapped trace is a
    survivor (``bits(t) > stop``), unsorted so that the cap cuts real work;
    the second pass with that stop as ``t_start`` and the carried code
    completes it. A kernel that cannot cap runs uncapped and reports every
    tile as drained."""
    tt = scenes[1] if kind == "s128" else fine[0]
    n = 2000
    o, d, tmax, _, excl = _t(*_uniform(n, 35, tt.clusters.face_id.numel()))
    full = cc.trace_closest_clustered_cuda(o, d, tmax, tt, None, excl,
                                           raw="code")
    n_surv = []
    for cap in (1, 2):
        t, code, stop = cc.trace_closest_clustered_cuda(
            o, d, tmax, tt, None, excl, raw="code", cap=cap,
            return_stop=True)
        assert stop.dtype == torch.int32 and stop.shape == (n,)
        surv = t.view(torch.int32) > stop
        changed = code != full[1]
        assert changed.any() and not (changed & ~surv).any()
        assert surv.sum() < n
        n_surv.append(int(surv.sum()))
        t2, c2 = cc.trace_closest_clustered_cuda(
            o, d, torch.where(surv, t, torch.zeros_like(t)), tt, None, excl,
            raw="code", t_start=stop.view(torch.float32), start_code=code)
        _same((torch.where(surv, t2, t), torch.where(surv, c2, code)), full)
    assert n_surv[1] < n_surv[0]
    for kw in (dict(kernel_near=True), dict(pipelined=True),
               dict(sched_rounds=4)):
        t, code, stop = cc.trace_closest_clustered_cuda(
            o, d, tmax, tt, None, excl, raw="code", cap=1, return_stop=True,
            **kw)
        _same((t, code), full)
        assert (stop == cc.STOP_DRAINED).all()
    hit, stop = cc.trace_closest_clustered_cuda(
        o, d, tmax, tt, None, excl, cap=10**6, return_stop=True)
    assert (stop == cc.STOP_DRAINED).all()
    np.testing.assert_array_equal(
        hit.face.numpy(), cc.code_to_face(full[1], tt.clusters.face_id))


def test_hooks_raise_where_no_kernel_takes_them(fine):
    tt, tt2 = fine
    o, d, tmax, _, _ = _t(*_uniform(256, 36, 8))
    ts = torch.zeros(256)
    code = torch.full((256,), -1, dtype=torch.int32)
    for kw in (dict(t_start=ts), dict(start_code=code), dict(cap=2),
               dict(return_stop=True)):
        with pytest.raises(ValueError):  # two-level tables
            cc.trace_closest_clustered_cuda(o, d, tmax, tt2, **kw)
        with pytest.raises(ValueError):  # an exact-pairs leg
            cc.trace_closest_clustered_cuda(o, d, tmax, tt, exact_pairs=True,
                                            **kw)
    with pytest.raises(ValueError):
        cc.trace_any_clustered_cuda(o, d, tmax, tt2, t_start=ts)
    with pytest.raises(ValueError):  # K5 carries no code in
        cc.prepare_tiles(o, d, tmax, tt, sched_rounds=2, start_code=code)
    with pytest.raises(ValueError):  # only K1 caps
        cc.prepare_tiles(o, d, tmax, tt, pipelined=True, cap=2)
    args = cc.prepare_tiles(o, d, tmax, tt, cap=2, return_stop=True)
    with pytest.raises(ValueError):  # the any-hit entry takes no cap
        cc.trace_any_tiles(**args)


# ---- through the integrator and the renderer ----


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


def _frame(settings, group_size=0, calls=None, monkeypatch=None):
    """Two frames of the mini scene in clusters of 16 → the accumulation
    buffer; ``calls`` counts the traces the integrator routed to."""
    if calls is not None:
        for name in ("binned_trace", "binned_trace_any",
                     "sorted_trace_multipass", "sorted_trace"):
            def spy(*a, _real=getattr(integrator, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **kw)

            monkeypatch.setattr(integrator, name, spy)
    r = Renderer(_mini(tscene, ttm), settings, base_seed=11, device="cpu")
    r.tables = _mini(tscene, ttm).tables("cpu", cluster_size=16,
                                         group_size=group_size)
    r.step()
    r.step()
    return r.buffers.image.numpy()


BASE = dict(width=24, height=20, bounces_depth=4, sample_count=1,
            environment="procedural")
# settings → the traces a 2-frame run routes its 8 sorted closest-hit legs
# (and, with NEE, 8 sorted shadow legs) to
FRAME_CASES = {
    "binned": (dict(binned_sort=True),
               dict(binned_trace=8), dict(binned_trace=8, binned_trace_any=8)),
    "binned_any": (dict(binned_any_sort=True),
                   dict(sorted_trace=8),
                   dict(sorted_trace=8, binned_trace_any=8)),
    # only K1 can cap: the multipass trace needs the order from outside
    "multipass4": (dict(multipass_cap=4, kernel_near=False),
                   dict(sorted_trace_multipass=8),
                   dict(sorted_trace_multipass=8, sorted_trace=8)),
    "multipass1_3": (dict(multipass_cap=1, multipass_passes=3,
                          kernel_near=False),
                     dict(sorted_trace_multipass=8),
                     dict(sorted_trace_multipass=8, sorted_trace=8)),
    "binned_near": (dict(binned_sort=True, kernel_near=True),
                    dict(binned_trace=8),
                    dict(binned_trace=8, binned_trace_any=8)),
    "binned_pipelined_sched": (
        dict(binned_sort=True, pipeline_rounds=True, trace_sched=4),
        dict(binned_trace=8), dict(binned_trace=8, binned_trace_any=8)),
    # a kernel that cannot cap keeps the plain sorted trace
    "multipass_near": (dict(multipass_cap=4, kernel_near=True),
                       dict(sorted_trace=8), dict(sorted_trace=16)),
    "multipass_sched": (dict(multipass_cap=4, trace_sched=2,
                             kernel_near=False),
                        dict(sorted_trace=8), dict(sorted_trace=16)),
    # binned goes before multipass, as in the JAX package
    "binned_multipass": (dict(binned_sort=True, multipass_cap=2),
                         dict(binned_trace=8),
                         dict(binned_trace=8, binned_trace_any=8)),
}


@pytest.fixture(scope="module")
def base_frames():
    return {nee: _frame(RenderSettings(next_event_estimation=nee, **BASE))
            for nee in (False, True)}


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frames_bit_identical_to_default(base_frames, monkeypatch, case, nee):
    """With ``sort_bounce_rays`` and each of the four settings on, two
    frames of the mini scene equal the default (unsorted) frame, or the
    NEE frame, bit for bit, and the legs went where the JAX package's
    routing sends them."""
    kw, plain_calls, nee_calls = FRAME_CASES[case]
    st = RenderSettings(next_event_estimation=nee, sort_bounce_rays=True,
                        **BASE).replace(**kw)
    calls = {}
    got = _frame(st, calls=calls, monkeypatch=monkeypatch)
    np.testing.assert_array_equal(got.view(np.int32),
                                  base_frames[nee].view(np.int32))
    assert calls == (nee_calls if nee else plain_calls)


def test_settings_off_unless_sorted(base_frames, monkeypatch):
    """Without ``sort_bounce_rays`` the four settings route nothing."""
    calls = {}
    got = _frame(RenderSettings(binned_sort=True, binned_any_sort=True,
                                multipass_cap=4, next_event_estimation=True,
                                **BASE), calls=calls, monkeypatch=monkeypatch)
    assert calls == {}
    np.testing.assert_array_equal(got.view(np.int32),
                                  base_frames[True].view(np.int32))


def test_two_level_tables_fall_to_the_plain_sorted_trace(monkeypatch):
    """On two-level tables every sorted leg keeps the plain sorted trace,
    whatever the four settings say, and the frame is the two-level default
    frame."""
    st = RenderSettings(next_event_estimation=True, **BASE)
    want = _frame(st, group_size=4)
    calls = {}
    got = _frame(st.replace(sort_bounce_rays=True, binned_sort=True,
                            binned_any_sort=True, multipass_cap=4),
                 group_size=4, calls=calls, monkeypatch=monkeypatch)
    assert calls == dict(sorted_trace=16)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_exact_legs_keep_the_plain_sorted_trace(base_frames, monkeypatch):
    calls = {}
    got = _frame(RenderSettings(
        sort_bounce_rays=True, binned_sort=True, multipass_cap=4,
        exact_pairs=True, exact_pairs_bounce=True, **BASE),
        calls=calls, monkeypatch=monkeypatch)
    assert calls == dict(sorted_trace=8)
    np.testing.assert_array_equal(got.view(np.int32),
                                  base_frames[False].view(np.int32))


@pytest.mark.parametrize("kw", [
    dict(multipass_cap=-1), dict(multipass_cap=2, multipass_passes=1),
], ids=["cap", "passes"])
def test_bad_multipass_settings_raise(kw):
    with pytest.raises(ValueError):
        Renderer(_mini(tscene, ttm), RenderSettings(width=8, height=8, **kw),
                 base_seed=0, device="cpu")
