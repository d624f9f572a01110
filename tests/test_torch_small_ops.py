"""PyTorch port: the small ops against the JAX package, bit for bit.

``ray_aabb``; ``random_3``, ``sample_hemisphere``, ``sample_insphere``
and the ``pdf_inv_*`` family; ``mat4_inverse``; the interval functions
with the reference's OR-quirk; the quad derivatives; ``offset_ray_paper``.
The reference is the JAX function run op by op (``jax.disable_jit``), as
in tests/test_torch_rng_raygen.py. RNG draws are compared on the raw
state, word by word. One stated exception: ``sample_insphere``'s cube
root, within 1 ulp of ``jnp.cbrt`` (XLA's own approximation, which no
torch or numpy function reproduces bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.ops import derivatives as jder
from webgpu_raytracing_tpu.ops import interval as jint
from webgpu_raytracing_tpu.ops import rng as jrng
from webgpu_raytracing_tpu.ops.integrator import (
    offset_ray_paper as j_offset_ray_paper,
)
from webgpu_raytracing_tpu.ops.intersect import ray_aabb as j_ray_aabb
from webgpu_raytracing_tpu.ops.intersect import safe_inv_dir as j_safe_inv
from webgpu_raytracing_tpu.ops.matrix import mat4_inverse as j_mat4_inverse
from webgpu_raytracing_tpu_torch.ops import derivatives as tder
from webgpu_raytracing_tpu_torch.ops import interval as tint
from webgpu_raytracing_tpu_torch.ops import rng as trng
from webgpu_raytracing_tpu_torch.ops.integrator import (
    offset_ray_paper as t_offset_ray_paper,
)
from webgpu_raytracing_tpu_torch.ops.intersect import ray_aabb, safe_inv_dir
from webgpu_raytracing_tpu_torch.ops.matrix import mat4_inverse

torch.set_num_threads(1)


def bits(x):
    """f32 array → its int32 bit patterns (so -0.0 != 0.0, NaN == NaN)."""
    return np.asarray(x, np.float32).view(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_ray_aabb_bit_equal():
    rng = np.random.default_rng(20)
    n = 4096
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, 0] = 0.0  # axis-parallel rays: the safe reciprocal's ±1e30
    c = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    half = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    bmin, bmax = c - half, c + half
    t_max = rng.uniform(0.5, 6.0, n).astype(np.float32)
    with jax.disable_jit():
        jh, jn = j_ray_aabb(jnp.asarray(o), j_safe_inv(jnp.asarray(d)),
                            jnp.asarray(bmin), jnp.asarray(bmax),
                            jnp.asarray(t_max))
    th, tn = ray_aabb(_t(o), safe_inv_dir(_t(d)), _t(bmin), _t(bmax),
                      _t(t_max))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(bits(tn.numpy()), bits(jn))
    assert 0 < th.numpy().sum() < n


def test_random_3_and_samplers_bit_equal():
    rng = np.random.default_rng(21)
    idx = np.arange(8192, dtype=np.int32)
    js = jrng.seed_state(jnp.broadcast_to(jnp.uint32(99), idx.shape),
                         jnp.asarray(idx))
    ts = trng.seed_state(99, _t(idx))
    with jax.disable_jit():
        for _ in range(3):
            jv, js = jrng.random_3(js)
            tv, ts = trng.random_3(ts)
            np.testing.assert_array_equal(
                ts.numpy(), np.asarray(js).astype(np.int64))
            np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))
        n = rng.normal(size=(idx.shape[0], 3)).astype(np.float32)
        t2 = np.asarray(jv)[:, :2]
        np.testing.assert_array_equal(
            bits(trng.sample_hemisphere(_t(t2), _t(n)).numpy()),
            bits(jrng.sample_hemisphere(jnp.asarray(t2), jnp.asarray(n))))
        j_ball = np.asarray(jrng.sample_insphere(jv))
    t_ball = trng.sample_insphere(tv).numpy()
    # the cube root: at most 1 ulp from jnp.cbrt, equal on >= 99 %
    ulp = np.abs(bits(t_ball).astype(np.int64) - bits(j_ball))
    assert ulp.max() <= 1, ulp.max()
    assert (ulp == 0).mean() >= 0.99, (ulp == 0).mean()
    for name in ("sphere", "hemisphere", "circle", "incircle", "insphere",
                 "intriangle", "insquare"):
        f = f"pdf_inv_{name}"
        assert getattr(trng, f)() == getattr(jrng, f)(), f


def test_mat4_inverse_bit_equal():
    rng = np.random.default_rng(22)
    m = rng.normal(size=(64, 4, 4)).astype(np.float32)
    m += np.eye(4, dtype=np.float32) * 3.0
    with jax.disable_jit():
        ji = np.asarray(j_mat4_inverse(jnp.asarray(m)))
    ti = mat4_inverse(_t(m)).numpy()
    np.testing.assert_array_equal(bits(ti), bits(ji))
    # and an inverse: the test_parity_ops.py tolerance
    np.testing.assert_allclose(ti, np.linalg.inv(m), rtol=1e-4, atol=1e-5)


def test_interval_semantics_match_jax():
    """tests/test_parity_ops.py's cases, the OR-quirk included, and the
    five functions on random intervals."""
    assert bool(tint.overlap(0.0, 1.0, 2.0, 3.0))  # disjoint but True
    assert not bool(tint.overlap_correct(0.0, 1.0, 2.0, 3.0))
    assert bool(tint.overlap_correct(0.0, 2.5, 2.0, 3.0))
    assert bool(tint.contains(0.0, 1.0, 1.0))
    assert not bool(tint.surrounds(0.0, 1.0, 1.0))
    a = np.array([0.0, 2.0, 5.0], np.float32)
    b = np.array([1.0, 3.0, 6.0], np.float32)
    x = np.array([-1.0, 2.5, 9.0], np.float32)
    np.testing.assert_array_equal(
        tint.clamp(_t(a), _t(b), _t(x)).numpy(),
        np.asarray(jint.clamp(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(x))))
    rng = np.random.default_rng(23)
    v = [rng.uniform(-2, 2, 512).astype(np.float32) for _ in range(4)]
    for f in ("overlap", "overlap_correct"):
        np.testing.assert_array_equal(
            getattr(tint, f)(*map(_t, v)).numpy(),
            np.asarray(getattr(jint, f)(*map(jnp.asarray, v))), err_msg=f)
    for f in ("contains", "surrounds"):
        np.testing.assert_array_equal(
            getattr(tint, f)(*map(_t, v[:3])).numpy(),
            np.asarray(getattr(jint, f)(*map(jnp.asarray, v[:3]))),
            err_msg=f)
    assert (tint.EMPTY, tint.UNIVERSE, tint.POSITIVE_UNIVERSE) == (
        jint.EMPTY, jint.UNIVERSE, jint.POSITIVE_UNIVERSE)


@pytest.mark.parametrize("shape", [(8, 12), (6, 10, 3)])
def test_quad_derivatives_bit_equal(shape):
    v = np.random.default_rng(24).normal(size=shape).astype(np.float32)
    with jax.disable_jit():
        for f in ("quad_swap_x", "quad_swap_y", "dfdx", "dfdy"):
            np.testing.assert_array_equal(
                bits(getattr(tder, f)(_t(v)).numpy()),
                bits(getattr(jder, f)(jnp.asarray(v))), err_msg=f)


def test_offset_ray_paper_bit_equal():
    rng = np.random.default_rng(25)
    p = rng.uniform(-0.1, 0.1, (4096, 3)).astype(np.float32)
    p[::5, 1] = 0.0  # exact zeros: the int path of both selects
    p[::9, 2] = -0.0
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    with jax.disable_jit():
        jo = j_offset_ray_paper(jnp.asarray(p), jnp.asarray(n))
    np.testing.assert_array_equal(
        bits(t_offset_ray_paper(_t(p), _t(n)).numpy()), bits(jo))
