"""PyTorch port: the closest-hit cluster trace (K1) against the JAX
package.

The kernel's plain-torch twin runs here (CPU tensors); the CUDA kernel is
held against the twin on the card in tests/test_torch_cuda.py. References: the XLA
clustered trace (exact f32 re-adjudication), the Pallas kernel under the
interpreter (bf16 hi/lo matmul decisions, lockstep and serial bodies), and
the threaded BVH oracle. Tolerances as in tests/test_cluster.py: hit masks
equal, face ids equal on at least 99.5% of hits (float knife edges), and
where faces agree the re-derived t, u, v are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.models.scene import scene_from_facesets
from webgpu_raytracing_tpu.models.test_models import (
    ground_plane,
    unit_cube_model,
    uv_sphere,
)
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    rederive_uv as j_rederive_uv,
)
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu.ops.cluster_trace import (
    tile_nears_fused as j_tile_nears,
)
from webgpu_raytracing_tpu.ops.cluster_trace import trace_closest_clustered
from webgpu_raytracing_tpu.ops.integrator import (
    face_point_offset as j_face_point_offset,
)
from webgpu_raytracing_tpu.ops.intersect import safe_inv_dir as j_safe_inv
from webgpu_raytracing_tpu.ops.traverse import trace_closest as j_threaded
from webgpu_raytracing_tpu_torch.models.scene import tables_from_numpy
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops.cluster_trace import tile_nears_fused
from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir

torch.set_num_threads(1)

TABLE_FIELDS = (
    "node_box", "node_meta", "tri", "shade_normal", "face_material",
    "model_face_offset", "model_face_count", "mat_color", "mat_emission",
)


@pytest.fixture(scope="module")
def scenes():
    """tests/test_cluster.py scene: JAX tables and the same arrays as
    port tables."""
    scene = scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )
    jt = scene.tables()
    arrays = {k: np.asarray(getattr(jt, k)) for k in TABLE_FIELDS}
    for k in ("box", "mat_b", "face_id", "partner_code"):
        arrays["clusters." + k] = np.asarray(getattr(jt.clusters, k))
    return jt, tables_from_numpy(arrays, device="cpu")


def _rays(rng, n, z_band=False):
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    if z_band:
        o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(tt, o, d, tmax, active=None, excl=None):
    return cc.trace_closest_clustered_cuda(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax), tt,
        None if active is None else torch.from_numpy(active),
        None if excl is None else torch.from_numpy(excl),
    )


def _check(jt, o, d, got, ref, min_agree=0.995):
    """Hit masks equal; faces agree on >= min_agree of hits; where they
    agree the port's t/u/v equal JAX's rederive_uv of the same face."""
    gf = got.face.numpy()
    rf = np.asarray(ref.face)
    np.testing.assert_array_equal(gf >= 0, rf >= 0)
    hits = rf >= 0
    agree = (gf == rf) & hits
    if hits.any():
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
    return hits.sum(), agree.sum()


@pytest.mark.parametrize("n", [384, 1000])
def test_twin_matches_clustered(scenes, n):
    jt, tt = scenes
    o, d = _rays(np.random.default_rng(n), n, z_band=n == 384)
    tmax = np.full((n,), F32_MAX, np.float32)
    got = _port(tt, o, d, tmax)
    ref = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128
    )
    hits, _ = _check(jt, o, d, got, ref)
    assert hits > 50
    # misses keep their t_max
    miss = got.face.numpy() < 0
    np.testing.assert_array_equal(got.t.numpy()[miss], tmax[miss])


@pytest.mark.parametrize(
    "kw",
    [dict(lockstep=True, tiles_per_step=2), dict(lockstep=False)],
    ids=["lockstep", "serial"],
)
def test_twin_matches_pallas_interpret(scenes, kw):
    jt, tt = scenes
    n = 384
    o, d = _rays(np.random.default_rng(11), n, z_band=True)
    tmax = np.full((n,), F32_MAX, np.float32)
    got = _port(tt, o, d, tmax)
    ref = trace_closest_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128,
        interpret=True, exact_pairs=False, **kw,
    )
    _check(jt, o, d, got, ref)


def test_twin_matches_threaded_oracle(scenes):
    jt, tt = scenes
    n = 512
    o, d = _rays(np.random.default_rng(12), n, z_band=True)
    tmax = np.full((n,), F32_MAX, np.float32)
    got = _port(tt, o, d, tmax)
    ref = j_threaded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt)
    _check(jt, o, d, got, ref)


def test_twin_inactive_bounded_and_nan_rays(scenes):
    """Inactive lanes return (face -1, t 0); finite t_max bounds the
    search and misses return it; NaN origins miss everything. Tail
    padding: 1000 rays is not a whole number of 128-ray tiles."""
    jt, tt = scenes
    n = 1000
    rng = np.random.default_rng(13)
    o, d = _rays(rng, n)
    tmax = rng.uniform(0.5, 6.0, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.2
    o[rng.uniform(size=n) < 0.05, rng.integers(0, 3)] = np.nan
    got = _port(tt, o, d, tmax, active=active)
    ref = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt,
        active=jnp.asarray(active), tile=128,
    )
    _check(jt, o, d, got, ref)
    gf, gt = got.face.numpy(), got.t.numpy()
    assert (gf[~active] == -1).all() and (gt[~active] == 0.0).all()
    nan_o = np.isnan(o).any(axis=1)
    assert nan_o.any() and (gf[nan_o] == -1).all()
    miss = active & (gf < 0)
    np.testing.assert_array_equal(gt[miss], tmax[miss])
    assert (gt[gf >= 0] < tmax[gf >= 0]).all()


def test_twin_bounce_rays_with_exclusion(scenes):
    """Bounce rays leaving two-sided faces, with the source face's
    duplicate excluded by code (the Pallas kernel's exclusion column);
    exact arithmetic (clustered) rejects the duplicate by t > 0."""
    jt, tt = scenes
    n = 768
    o, d = _rays(np.random.default_rng(14), n, z_band=True)
    tmax = np.full((n,), F32_MAX, np.float32)
    prim = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128
    )
    face = np.asarray(prim.face)
    hit = face >= 0
    fc = np.maximum(face, 0)
    tri = np.asarray(jt.tri)[fc]
    shade = np.asarray(jt.shade_normal)[fc]
    o2 = np.array(j_face_point_offset(
        jnp.asarray(tri), jnp.asarray(shade), prim.u, prim.v
    ))
    nrm = shade[:, 0:3]
    d2 = np.random.default_rng(15).normal(size=(n, 3)).astype(np.float32)
    d2 = d2 / np.linalg.norm(d2, axis=1, keepdims=True) + nrm
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    excl = np.where(
        hit, np.asarray(jt.clusters.partner_code)[fc], -1
    ).astype(np.int32)
    assert (excl >= 0).sum() > 50
    got = _port(tt, o2, d2, tmax, active=hit, excl=excl)
    ref_c = trace_closest_clustered(
        jnp.asarray(o2), jnp.asarray(d2), jnp.asarray(tmax), jt,
        active=jnp.asarray(hit), tile=128,
    )
    _check(jt, o2, d2, got, ref_c)
    ref_p = trace_closest_clustered_pallas(
        jnp.asarray(o2), jnp.asarray(d2), jnp.asarray(tmax), jt, jnp.asarray(hit),
        tile=128, interpret=True, exact_pairs=False,
        excl_code=jnp.asarray(excl),
    )
    _check(jt, o2, d2, got, ref_p)
    # the source face and its duplicate never win
    gf = got.face.numpy()
    assert not np.any((gf == face) & hit)


def test_tile_nears_bit_equal(scenes):
    jt, tt = scenes
    n = 512
    rng = np.random.default_rng(16)
    o, d = _rays(rng, n)
    o[::37, 1] = np.nan
    d[::11, 0] = 0.0
    tmax = rng.uniform(0.0, 8.0, n).astype(np.float32)
    inv = safe_inv_dir(torch.from_numpy(d))
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(j_safe_inv(jnp.asarray(d)))
    )
    got = tile_nears_fused(
        torch.from_numpy(o), inv, torch.from_numpy(tmax), tt.clusters.box,
        128, max_elems=128 * 7,
    )
    ref = j_tile_nears(
        jnp.asarray(o), jnp.asarray(inv.numpy()), jnp.asarray(tmax),
        jt.clusters.box, 128,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kernel_wrapper_never_runs_the_twin_for_other_devices(scenes):
    """The kernel launcher refuses tensors that are not on a CUDA device
    (it does not hand them to the twin), and a renderer asked for a CUDA
    device without one raises."""
    _, tt = scenes
    o, d = _rays(np.random.default_rng(17), 256)
    args = cc.prepare_tiles(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.full((256,), F32_MAX), tt,
    )
    with pytest.raises(ValueError):
        cc._launch_kernel(**args)
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
            for k, v in args.items()}
    with pytest.raises(ValueError):
        cc.trace_closest_tiles(**meta)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tt.to("cuda")


def test_ray_triangle_bit_equal():
    from webgpu_raytracing_tpu.ops.intersect import ray_triangle as j_rt
    from webgpu_raytracing_tpu_torch.ops.intersect import ray_triangle

    rng = np.random.default_rng(19)
    n = 20000
    o, d = _rays(rng, n)
    tri = rng.uniform(-2, 2, (n, 9)).astype(np.float32)
    # aim at a point near the triangle: about half hit, many near an edge
    w = rng.uniform(-0.1, 0.7, (n, 2)).astype(np.float32)
    aim = tri[:, 0:3] + w[:, :1] * tri[:, 3:6] + w[:, 1:] * tri[:, 6:9]
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.5, 8.0, n).astype(np.float32)
    args = (o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    want = j_rt(*[jnp.asarray(a) for a in args], 0.0, jnp.asarray(tmax))
    got = ray_triangle(*[torch.from_numpy(a) for a in args], 0.0,
                       torch.from_numpy(tmax))
    assert np.asarray(want.hit).sum() > 100
    for name in ("hit", "t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name,
        )
