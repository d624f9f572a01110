"""PyTorch port: the threaded and clustered oracles (ops/traverse.py,
ops/cluster_trace.py) against the JAX package's.

The scene and ray sets of tests/test_intersect.py:118-170 and
tests/test_cluster.py:111-160, 234: random rays, bounded ``t_max``,
inactive lanes. Closest hit: face ids equal to JAX's on every ray, and t,
u, v bit-equal. Any hit: the blocked sets equal. The block functions
(``intersect_cluster_block``, its top-2 form, ``boxes_near``) equal JAX's
on one tile; the A·B product is ``torch.matmul`` against JAX's
``jnp.dot`` at HIGHEST precision, and the outputs agree bit for bit on
these rays. The walks run jitted in JAX (their while loops compile in
any case): XLA's FMA contraction moves the last bit of JAX's ray matrix,
which only ranks candidates, and the exact arithmetic that decides is
contraction-proof, so the walks still agree bit for bit; the block
functions are compared op by op.

The port's own cross-check: the threaded walk, the clustered oracle and
the kernels' twin (K2n, K1) give the same faces on one ray set."""

import jax
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
from webgpu_raytracing_tpu.ops import cluster_trace as jct
from webgpu_raytracing_tpu.ops import traverse as jtr
from webgpu_raytracing_tpu.ops.intersect import safe_inv_dir as j_safe_inv
from webgpu_raytracing_tpu_torch.models.scene import tables_from_numpy
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import cluster_trace as tct
from webgpu_raytracing_tpu_torch.ops import traverse as ttr
from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir

torch.set_num_threads(1)

TABLE_FIELDS = (
    "node_box", "node_meta", "tri", "shade_normal", "face_material",
    "model_face_offset", "model_face_count", "mat_color", "mat_emission",
)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def scenes():
    """tests/test_cluster.py's scene: JAX tables and the same arrays as
    port tables; and both again cut into clusters of 16 faces, so that a
    tile walks many clusters."""
    scene = scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )
    out = {}
    for cs in (128, 16):
        jt = scene.tables(cluster_size=cs)
        arrays = {k: np.asarray(getattr(jt, k)) for k in TABLE_FIELDS}
        for k in ("box", "mat_b", "face_id", "partner_code"):
            arrays["clusters." + k] = np.asarray(getattr(jt.clusters, k))
        out[cs] = (jt, tables_from_numpy(arrays, device="cpu"))
    return out


def _rays(seed, n, z_band=True):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    if z_band:
        o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


CASES = {
    # (ray seed, t_max, inactive share)
    "unbounded": (1234, F32_MAX, 0.0),
    "t_max": (1235, 2.5, 0.0),
    "inactive": (1236, F32_MAX, 0.3),
}


def _case(name, n=512):
    seed, tmax_val, off = CASES[name]
    o, d = _rays(seed, n)
    t_max = np.full((n,), tmax_val, np.float32)
    active = np.random.default_rng(seed + 1).uniform(size=n) >= off
    return o, d, t_max, active


def _closest(kind, tables, o, d, t_max, active, port):
    if kind == "threaded":
        fn = ttr.trace_closest if port else jtr.trace_closest
        kw = {}
    else:
        fn = tct.trace_closest_clustered if port else (
            jct.trace_closest_clustered)
        kw = dict(tile=128)
    conv = (lambda x: torch.from_numpy(x)) if port else jnp.asarray
    return fn(conv(o), conv(d), conv(t_max), tables, conv(active), **kw)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind, cluster_size", [
    ("threaded", 128), ("clustered", 128), ("clustered", 16)])
def test_closest_equals_jax(scenes, kind, case, cluster_size):
    jt, tt = scenes[cluster_size]
    o, d, t_max, active = _case(case)
    jh = _closest(kind, jt, o, d, t_max, active, port=False)
    th = _closest(kind, tt, o, d, t_max, active, port=True)
    face = th.face.numpy()
    np.testing.assert_array_equal(face, np.asarray(jh.face))
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(
            bits(getattr(th, k).numpy()), bits(getattr(jh, k)), err_msg=k)
    assert (face >= 0).sum() > 20
    assert (face[~active] == -1).all()


@pytest.mark.parametrize("tmax_val", [F32_MAX, 2.5])
@pytest.mark.parametrize("kind", ["threaded", "clustered"])
def test_any_hit_equals_jax(scenes, kind, tmax_val):
    """tests/test_cluster.py:234's rays, bounded and unbounded, with a
    third of the lanes inactive."""
    jt, tt = scenes[16]
    n = 384
    o, d = _rays(77, n, z_band=False)
    t_max = np.full((n,), tmax_val, np.float32)
    active = np.random.default_rng(78).uniform(size=n) > 0.33
    if kind == "threaded":
        jb = jtr.trace_any(jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(t_max), jt, jnp.asarray(active))
        tb = ttr.trace_any(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(t_max), tt,
                           torch.from_numpy(active))
    else:
        jb = jct.trace_any_clustered(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jt,
            jnp.asarray(active), tile=128)
        tb = tct.trace_any_clustered(
            torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max), tt, torch.from_numpy(active), tile=128)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert 0 < tb.numpy().sum() < active.sum()


def test_cluster_block_functions_equal_jax(scenes):
    """One 128-ray tile against every cluster of the 16-face tables:
    ``ray_matrix``, ``intersect_cluster_block`` and its top-2 form, and the
    dense ``boxes_near``, JAX op by op (jitted, XLA contracts the cross
    product of ``ray_matrix`` into FMAs; the port's is strict, as the
    oracle walks above show it may be)."""
    jt, tt = scenes[16]
    o, d = _rays(90, 128)
    best = np.full((128,), 6.0, np.float32)
    a_t = tct.ray_matrix(torch.from_numpy(o), torch.from_numpy(d))
    hits = 0
    with jax.disable_jit():
        a_j = jct.ray_matrix(jnp.asarray(o), jnp.asarray(d))
        np.testing.assert_array_equal(bits(a_t.numpy()), bits(a_j))
        for c in range(tt.clusters.box.shape[0]):
            b_t, b_j = tt.clusters.mat_b[c], jt.clusters.mat_b[c]
            got = tct.intersect_cluster_block(a_t, b_t,
                                              torch.from_numpy(best))
            want = jct.intersect_cluster_block(a_j, b_j, jnp.asarray(best))
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(bits(g.numpy()), bits(w))
            np.testing.assert_array_equal(got[3].numpy(),
                                          np.asarray(want[3]))
            hits += int((got[3] >= 0).sum())
            for g, w in zip(
                    tct.intersect_cluster_block_top2(a_t, b_t,
                                                     torch.from_numpy(best)),
                    jct.intersect_cluster_block_top2(a_j, b_j,
                                                     jnp.asarray(best))):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        near_j = jct._boxes_near(jnp.asarray(o), j_safe_inv(jnp.asarray(d)),
                                 jt.clusters.box, jnp.asarray(best))
    assert hits > 20
    near_t = tct.boxes_near(torch.from_numpy(o),
                            safe_inv_dir(torch.from_numpy(d)),
                            tt.clusters.box, torch.from_numpy(best))
    np.testing.assert_array_equal(bits(near_t.numpy()), bits(near_j))


@pytest.mark.parametrize("case", list(CASES))
def test_oracles_and_kernel_twins_agree(scenes, case):
    """The port's three independent traces on one ray set: the threaded
    walk, the clustered oracle and the kernels' twins (K2n, and K1 over
    the order sorted outside) give the same face on every ray, and the
    any-hit forms the same blocked set."""
    _, tt = scenes[16]
    o, d, t_max, active = _case(case, n=640)
    o, d, t_max, active = map(torch.from_numpy, (o, d, t_max, active))
    faces = {
        "threaded": ttr.trace_closest(o, d, t_max, tt, active).face,
        "clustered": tct.trace_closest_clustered(o, d, t_max, tt, active,
                                                 tile=128).face,
    }
    blocked = {
        "threaded": ttr.trace_any(o, d, t_max, tt, active),
        "clustered": tct.trace_any_clustered(o, d, t_max, tt, active,
                                             tile=128),
    }
    for near in (True, False):
        name = "K2n twin" if near else "K1 twin"
        faces[name] = cc.trace_closest_clustered_cuda(
            o, d, t_max, tt, active, kernel_near=near).face
        blocked[name] = cc.trace_any_clustered_cuda(
            o, d, t_max, tt, active, kernel_near=near)
    for name in faces:
        np.testing.assert_array_equal(faces[name].numpy(),
                                      faces["threaded"].numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(blocked[name].numpy(),
                                      blocked["threaded"].numpy(),
                                      err_msg=name)
    assert (faces["threaded"] >= 0).sum() > 20
