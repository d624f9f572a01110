"""PyTorch port: the ray sort's coherence key (``cluster_cuda.top_keys_tiles``
and the ``ray_sort`` functions that go through it).

A numpy model of the key kernel's algorithm (csrc/cluster_trace.cu
``top_keys_kernel``: the first n boxes' keys from the slab test, misses
included; then the boxes staged in chunks with their axes sorted, each ray
reading every axis's near and far corner by the sign of its inv_d and
inserting only the keys of the boxes it enters into its n registers) must
equal the twin ``_top_keys_torch`` bit for bit on adversarial
rays and boxes: dead lanes, rays that enter fewer than n boxes, direction
components under 1e-12, zero and NaN, NaN origins, inverted pad boxes,
near ties within the truncation, t_start (NaN included), C = 1, C < n and
C across several chunks. The port's ``_top_keys``, ``nearest_cluster_key``,
``nearest_cluster_keys2`` and ``nearest_cluster_key_fused`` equal the JAX
functions int32 for int32 on the same inputs. The wrapper's routes: a CPU
tensor runs the twin and launches nothing, route "kernel" raises on CPU
tensors, route "twin" runs the twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.ops import ray_sort as jrs
from webgpu_raytracing_tpu_torch.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort
from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir

torch.set_num_threads(1)

F32 = np.float32(F32_MAX)
I32_MAX = np.int32(0x7FFFFFFF)


def _slab(lo, hi, o, inv):
    """The kernel's `slab`: per axis the two products, NaN-propagating
    min / max, in the twin's axis order; lo, hi (3,), o, inv (R, 3)."""
    near = far = None
    for a in range(3):
        x = (lo[a] - o[:, a]) * inv[:, a]
        y = (hi[a] - o[:, a]) * inv[:, a]
        mn, mx = np.minimum(x, y), np.maximum(x, y)
        near = mn if near is None else np.maximum(near, mn)
        far = mx if far is None else np.minimum(far, mx)
    return near, far


def _entry(near):
    """`entry_of`: max(near, 0) on the float's bits, -0 made +0."""
    return np.maximum(near.view(np.int32), 0).view(np.float32)


def model_top_keys(o, inv, t_max, boxes, n, t_start=None, chunk=128):
    """The key kernel, step for step, over all rays at once → (n, R)."""
    r, c = o.shape[0], boxes.shape[0]
    kmask = np.int32(cc.key_masks(c)[0])
    k = np.full((n, r), I32_MAX, np.int32)

    def insert(x, mask):
        m = mask & (x < k[n - 1])
        for i in range(n - 1, 0, -1):
            upd = m & (x < k[i])
            k[i] = np.where(upd, np.where(x < k[i - 1], k[i - 1], x), k[i])
        k[0] = np.where(m & (x < k[0]), x, k[0])

    def key(e, cid):
        return (e.view(np.int32) & ~kmask) | np.int32(cid)

    head = min(n, c)
    for cid in range(head):  # every key, misses included
        near, far = _slab(boxes[cid, :3], boxes[cid, 3:], o, inv)
        hit = (near < far) & (near < t_max) & (far > 0)
        e = np.where(hit, _entry(near), F32)
        if t_start is not None:
            e = np.where(e >= t_start, e, F32)
        insert(key(e, cid), np.ones(r, bool))
    down = inv < 0  # NaN and -0 count as "up"
    for base in range(0, c, chunk):
        m = min(chunk, c - base)
        stage = boxes[base:base + m]
        # axes sorted: an inverted box tests as in `slab`
        lo = np.minimum(stage[:, :3], stage[:, 3:])
        hi = np.maximum(stage[:, :3], stage[:, 3:])
        for j in range(max(head - base, 0), m):
            t_n = (np.where(down, hi[j], lo[j]) - o) * inv
            t_f = (np.where(down, lo[j], hi[j]) - o) * inv
            near = np.maximum(np.maximum(t_n[:, 0], t_n[:, 1]), t_n[:, 2])
            far = np.minimum(np.minimum(t_f[:, 0], t_f[:, 1]), t_f[:, 2])
            hit = (near < np.minimum(far, t_max)) & (far > 0)
            e = _entry(near)
            if t_start is not None:
                hit &= e >= t_start
            insert(key(e, base + j), hit)
    return k


def _boxes(rng, c, pads=0, ties=0):
    """``c`` boxes around the origin: random ones, flat ones, ``pads``
    inverted-empty pad boxes (min 3e38 > max -3e38: the symmetric slab
    test enters them from any ray at entry 0) and ``ties`` copies of
    box 0 shifted by less than the key's truncation."""
    lo = rng.uniform(-3, 2, (c, 3)).astype(np.float32)
    size = 1.5 if c > 3 else 4.0  # a few boxes: large ones
    hi = lo + rng.uniform(0.05, size, (c, 3)).astype(np.float32)
    hi[1::7, 1] = lo[1::7, 1]  # flat boxes
    b = np.concatenate([lo, hi], 1)
    for i in range(1, min(ties + 1, c)):
        b[i] = b[0]
        b[i, 3:] += np.float32(1e-6 * i)  # same near, other far
    if pads:
        b[-pads:, :3] = np.float32(3.0e38)
        b[-pads:, 3:] = np.float32(-3.0e38)
    return b


def _rays(rng, r):
    """Rays aimed at the boxes, away from them, dead (t_max 0, some inside
    a box), with NaN origins, and direction components under 1e-12, zero,
    -0 and NaN."""
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    aim = rng.uniform(-2.5, 2.5, (r, 3)).astype(np.float32)
    d = (aim - o).astype(np.float32)
    kind = rng.uniform(size=r)
    away = kind < 0.2
    d[away] = -d[away]
    inside = (kind >= 0.2) & (kind < 0.3)
    o[inside] = aim[inside]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::11, 0] = np.float32(3e-13)
    d[1::13, 1] = np.float32(0.0)
    d[2::13, 2] = np.float32(-0.0)
    d[3::29, 1] = np.float32(-5e-13)
    d[4::97, 2] = np.nan
    o[5::89, 0] = np.nan
    t_max = np.where(rng.uniform(size=r) < 0.5, F32,
                     rng.uniform(0.2, 9.0, r)).astype(np.float32)
    t_max[(kind >= 0.2) & (kind < 0.4)] = 0.0  # dead lanes
    return o, d.astype(np.float32), t_max


def _on_faces(o, d, t_max, boxes):
    """Every 7th live ray starts on the max-x face of a box, inside it
    along y and z, going towards -x: that axis's products are -0 (the far
    face) and positive, so its near is -0, which the key must make +0."""
    idx = np.arange(0, o.shape[0], 7)
    idx = idx[t_max[idx] > 0]
    b = boxes[idx % boxes.shape[0]]
    o[idx] = np.stack([b[:, 3], (b[:, 1] + b[:, 4]) / 2,
                       (b[:, 2] + b[:, 5]) / 2], 1).astype(np.float32)
    d[idx] = np.float32([-0.6, 0.0, 0.8])


def _t_start(rng, r):
    """0, positive bounds, and NaN (the int32 maximum as a float: a dead
    lane's stop)."""
    ts = rng.uniform(0.0, 6.0, r).astype(np.float32)
    ts[rng.uniform(size=r) < 0.3] = 0.0
    ts[rng.uniform(size=r) < 0.1] = np.int32(0x7FFFFFFF).view(np.float32)
    return ts


CASES = {  # name: (boxes, pads, ties, model chunk)
    "c1": (1, 0, 0, 128),
    "c2": (2, 0, 0, 128),  # fewer boxes than n = 3
    "c3": (3, 1, 0, 2),
    "c40_chunks": (40, 1, 4, 7),  # several chunks, head split across
    "c300": (300, 1, 6, 128),  # the kernel's chunks
}


@pytest.mark.parametrize("t_start", [False, True], ids=["", "t_start"])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_model_equals_twin(case, n, t_start):
    c, pads, ties, chunk = CASES[case]
    rng = np.random.default_rng(1000 + c + 10 * n + t_start)
    boxes = _boxes(rng, c, pads, ties)
    o, d, t_max = _rays(rng, 1200)
    _on_faces(o, d, t_max, boxes)
    ts = _t_start(rng, o.shape[0]) if t_start else None
    inv = safe_inv_dir(torch.from_numpy(d)).numpy()
    want = cc._top_keys_torch(
        torch.from_numpy(o), torch.from_numpy(inv), torch.from_numpy(t_max),
        torch.from_numpy(boxes), n,
        t_start=None if ts is None else torch.from_numpy(ts), chunk=500)
    with np.errstate(over="ignore", invalid="ignore"):  # 1e30 x 3e38
        got = model_top_keys(o, inv, t_max, boxes, n, ts, chunk)
    for j in range(n):
        np.testing.assert_array_equal(got[j], want[j].numpy(), err_msg=str(j))
    kmask, miss_th = cc.key_masks(c)
    k = np.stack([w.numpy() for w in want])
    # the cases the kernel must get right are all present
    entered = (k & ~kmask) < miss_th
    assert entered[0].any() and not entered[0].all()
    if c < n:  # the int32 maximum where no box is left
        assert (k[c:] == I32_MAX).all()
    else:
        assert (~entered[n - 1] & entered[0]).any()  # fewer than n entered
        if ts is None:  # a dead lane inside a box enters it at 0
            assert ((t_max == 0) & entered[0]).any()
    if ties:  # near ties within the truncation: the lower id first
        tie = entered[1] & ((k[0] & ~kmask) == (k[1] & ~kmask))
        assert tie.any() and ((k[0] & kmask) < (k[1] & kmask))[tie].all()


@pytest.fixture(scope="module")
def tables():
    """The tests/test_torch_ray_sort.py scene in clusters of 8, single-level
    and two-level (supers of 4)."""
    sc = tscene.scene_from_facesets(
        [
            ("sphere", ttm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ttm.ground_plane(-1.5, 8.0)),
            ("cube", ttm.unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )
    return (sc.tables("cpu", cluster_size=8, group_size=0),
            sc.tables("cpu", cluster_size=8, group_size=4))


def _scene_rays(seed, n=1500):
    rng = np.random.default_rng(seed)
    o, d, t_max = _rays(rng, n)
    o = (o + np.array([0.0, 0.0, -3.0], np.float32)).astype(np.float32)
    return o, d, t_max


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("level", ["single", "two_level"])
def test_fused_key_equals_jax(tables, level):
    """The port's ``nearest_cluster_key_fused`` against JAX's (one variadic
    reduction) and JAX's ``nearest_cluster_key``, on the clusters and on
    the supers (with their inverted pad children's union)."""
    tt = tables[level == "two_level"]
    boxes = tt.clusters.sort_box
    o, d, t_max = _scene_rays(21)
    got = ray_sort.nearest_cluster_key_fused(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        boxes)
    jb = jnp.asarray(boxes.numpy())
    want = np.asarray(jrs.nearest_cluster_key_fused(*_j(o, d, t_max), jb))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jrs.nearest_cluster_key(*_j(o, d, t_max), jb)))
    c = boxes.shape[0]
    assert (want < c * (c + 1)).any() and (want >= c * (c + 1)).any()


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("level", ["single", "two_level"])
def test_keys_equal_jax(tables, level, n):
    """``_top_keys`` and ``nearest_cluster_keys2`` against JAX's raw keys,
    and ``nearest_cluster_key`` with and without ``t_start`` against JAX's,
    on the adversarial rays (chunks of 512 and the default)."""
    tt = tables[level == "two_level"]
    boxes = tt.clusters.sort_box
    o, d, t_max = _scene_rays(30 + n)
    ts = _t_start(np.random.default_rng(40 + n), o.shape[0])
    to, td, tm, tts = (torch.from_numpy(x) for x in (o, d, t_max, ts))
    jb = jnp.asarray(boxes.numpy())
    want = [np.asarray(k) for k in jrs.nearest_cluster_keys2(
        *_j(o, d, t_max), jb, chunk=512, n=n)]
    for got in (ray_sort._top_keys(to, td, tm, boxes, 512, n),
                ray_sort.nearest_cluster_keys2(to, td, tm, boxes, n=n)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    for t_start in (None, ts):
        got = ray_sort.nearest_cluster_key(
            to, td, tm, boxes, t_start=None if t_start is None else tts)
        jw = jrs.nearest_cluster_key(
            *_j(o, d, t_max), jb,
            t_start=None if t_start is None else jnp.asarray(t_start))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jw))


def test_routes_on_cpu(tables):
    """A CPU tensor runs the twin and launches nothing; route "kernel"
    raises on CPU tensors, through the wrapper, the ray_sort functions and
    the renderer's ``traversal="pallas"`` sorted leg; route "twin" runs the
    twin; anything else raises."""
    tt = tables[0]
    boxes = tt.clusters.box
    o, d, t_max = (torch.from_numpy(x) for x in _scene_rays(50, 256))
    inv = safe_inv_dir(d)
    before = cc.top_keys_tiles.launches
    want = cc.top_keys_tiles.twin(o, inv, t_max, boxes, 3)
    for route in ("auto", "twin"):
        got = cc.top_keys_tiles(o, inv, t_max, boxes, 3, route=route)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cc.top_keys_tiles.launches == before
    with pytest.raises(ValueError, match="route 'kernel'"):
        cc.top_keys_tiles(o, inv, t_max, boxes, 2, route="kernel")
    with pytest.raises(ValueError, match="route must be one of"):
        cc.top_keys_tiles(o, inv, t_max, boxes, 2, route="cuda")
    with pytest.raises(ValueError, match="route 'kernel'"):
        ray_sort.nearest_cluster_key(o, d, t_max, boxes, route="kernel")
    with pytest.raises(ValueError, match="route 'kernel'"):
        ray_sort.nearest_cluster_keys2(o, d, t_max, boxes, n=3,
                                       route="kernel")
    st = RenderSettings(sort_bounce_rays=True, traversal="pallas")
    with pytest.raises(ValueError):
        integrator.trace_closest(o, d, t_max, tt, st, sort=True, seg=1)
    twin = ray_sort.nearest_cluster_key(o, d, t_max, boxes, route="twin")
    assert torch.equal(twin, ray_sort.nearest_cluster_key(o, d, t_max, boxes))
    assert cc.top_keys_tiles.launches == before
