"""PyTorch port: RNG, deterministic math and camera rays against the JAX
package, bit for bit.

The reference is the JAX functions evaluated op by op (eager), i.e. the
operation sequence as the JAX package writes it with one IEEE rounding
per op. Under ``jax.jit`` XLA:CPU additionally contracts some unguarded
mul-adds into FMAs and rewrites divisions by constants, which moves the
last bit of some camera directions; the frame-level tests
(test_torch_render.py) cover that."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.camera import Camera
from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.ops import detmath as jdet
from webgpu_raytracing_tpu.ops import rng as jrng
from webgpu_raytracing_tpu.ops.raygen import camera_rays as jcamera_rays
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.ops import detmath as tdet
from webgpu_raytracing_tpu_torch.ops import rng as trng
from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays as tcamera_rays

torch.set_num_threads(1)


def bits(x):
    """f32 array → its int32 bit patterns (so -0.0 != 0.0, NaN == NaN)."""
    return np.asarray(x, np.float32).view(np.int32)


def test_pcg_state_words_bit_equal():
    rng = np.random.default_rng(5)
    seed = int(rng.integers(0, 2**32, dtype=np.uint64))
    idx = np.arange(4096, dtype=np.int32)
    js = jrng.seed_state(jnp.broadcast_to(jnp.uint32(seed), idx.shape),
                         jnp.asarray(idx))
    ts = trng.seed_state(seed, torch.from_numpy(idx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(8):
        jv, js = jrng.random_1(js)
        tv, ts = trng.random_1(ts)
        np.testing.assert_array_equal(
            ts.numpy(), np.asarray(js).astype(np.int64)
        )
        np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))
    # masked advance keeps inactive lanes' words
    act = rng.uniform(size=idx.shape) > 0.5
    _, jn = jrng.random_1u(js)
    _, tn = trng.random_1u(ts)
    np.testing.assert_array_equal(
        trng.masked_advance(ts, tn, torch.from_numpy(act)).numpy(),
        np.asarray(jrng.masked_advance(js, jn, jnp.asarray(act))).astype(
            np.int64
        ),
    )


def test_samplers_bit_equal():
    rng = np.random.default_rng(6)
    t = rng.uniform(size=(20000, 2)).astype(np.float32)
    n = rng.normal(size=(20000, 3)).astype(np.float32)
    tt, tn = torch.from_numpy(t), torch.from_numpy(n)
    jt, jn = jnp.asarray(t), jnp.asarray(n)
    for jf, tf in (
        (jrng.sample_sphere, trng.sample_sphere),
        (jrng.sample_incircle, trng.sample_incircle),
        (jrng.sample_insquare, trng.sample_insquare),
    ):
        np.testing.assert_array_equal(bits(tf(tt).numpy()), bits(jf(jt)))
    np.testing.assert_array_equal(
        bits(trng.sample_cosine_weighted_hemisphere(tt, tn).numpy()),
        bits(jrng.sample_cosine_weighted_hemisphere(jt, jn)),
    )


def _detmath_inputs(name, rng):
    if name == "det_div":
        return (
            rng.normal(size=50000).astype(np.float32) * 10.0,
            rng.normal(size=50000).astype(np.float32),
        )
    if name == "det_sqrt":
        return (rng.uniform(0, 100, 50000).astype(np.float32),)
    if name == "normalize":
        return (rng.normal(size=(50000, 3)).astype(np.float32),)
    return (rng.uniform(-4 * np.pi, 4 * np.pi, 50000).astype(np.float32),)


@pytest.mark.parametrize(
    "name", ["det_div", "det_sqrt", "det_sincos", "det_tan", "normalize"]
)
def test_detmath_bit_equal(name):
    args = _detmath_inputs(name, np.random.default_rng(7))
    want = getattr(jdet, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tdet, name)(*[torch.from_numpy(a) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


def _pixel_grid(w, h, rng):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    return pos + rng.uniform(-0.5, 0.5, pos.shape).astype(np.float32)


@pytest.mark.parametrize("projection", [0, 1, 2, 3])
def test_camera_rays_bit_equal(projection):
    """All fov orientations and both lens shapes of one projection on a
    jittered 16x16 grid, with a thin lens and a moved, rotated camera."""
    rng = np.random.default_rng(8 + projection)
    w = h = 16
    pos = _pixel_grid(w, h, rng)
    cam = Camera()
    cam.rotate(np.array([0.3, 0.2], np.float32))
    cam.move(np.array([0.1, 0.2, -0.3], np.float32))
    view = cam.view_matrix()
    seed = 987654321
    idx = np.arange(w * h, dtype=np.int32)
    for fo in range(3):
        for lens in range(2):
            kw = dict(
                width=w, height=h, projection_type=projection,
                fov_orientation=fo, lens_shape=lens,
                circle_of_confusion=0.05, focus_distance=3.0,
                fov=2.0943951023931953 if projection == 1 else 1.3,
            )
            state = jrng.seed_state(
                jnp.broadcast_to(jnp.uint32(seed), idx.shape),
                jnp.asarray(idx),
            )
            with jax.disable_jit():
                jo, jd, js = jcamera_rays(
                    jnp.asarray(pos), jnp.asarray(view), state,
                    JSettings(**kw),
                )
            to, td, ts = tcamera_rays(
                torch.from_numpy(pos), torch.from_numpy(view),
                trng.seed_state(seed, torch.from_numpy(idx)),
                TSettings(**kw),
            )
            np.testing.assert_array_equal(bits(to.numpy()), bits(jo))
            np.testing.assert_array_equal(bits(td.numpy()), bits(jd))
            np.testing.assert_array_equal(
                ts.numpy(), np.asarray(js).astype(np.int64)
            )


def test_camera_rays_default_frame_jit_close():
    """Under jit the JAX rays differ from the op-by-op ones only in the
    last bits (XLA's FMA contraction / constant-division rewrites); the
    port stays within a few ulp of them at the default settings."""
    w, h = 48, 27
    pos = _pixel_grid(w, h, np.random.default_rng(3))
    view = Camera().view_matrix()
    idx = np.arange(w * h, dtype=np.int32)
    state = jrng.seed_state(
        jnp.broadcast_to(jnp.uint32(42), idx.shape), jnp.asarray(idx)
    )
    jfn = jax.jit(functools.partial(jcamera_rays,
                                    settings=JSettings(width=w, height=h)))
    _, jd, _ = jfn(jnp.asarray(pos), jnp.asarray(view), state)
    _, td, _ = tcamera_rays(
        torch.from_numpy(pos), torch.from_numpy(view),
        trng.seed_state(42, torch.from_numpy(idx)),
        TSettings(width=w, height=h),
    )
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
