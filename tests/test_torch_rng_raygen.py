"""PyTorch port: RNG, deterministic math and camera rays against the JAX
package, bit for bit.

The reference is the JAX functions evaluated op by op (eager), i.e. the
operation sequence as the JAX package writes it with one IEEE rounding
per op. Under ``jax.jit`` XLA:CPU additionally contracts some unguarded
mul-adds into FMAs and rewrites divisions by constants, which moves the
last bit of some camera directions; the frame-level tests
(test_torch_render.py) cover that."""

import ctypes
import functools
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.camera import Camera
from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.ops import detmath as jdet
from webgpu_raytracing_tpu.ops import rng as jrng
from webgpu_raytracing_tpu.ops import strictf as jstrictf
from webgpu_raytracing_tpu.ops.raygen import camera_rays as jcamera_rays
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.ops import detmath as tdet
from webgpu_raytracing_tpu_torch.ops import rng as trng
from webgpu_raytracing_tpu_torch.ops import raygen as traygen
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


@pytest.mark.parametrize("orientation", [0, 1, 2])
@pytest.mark.parametrize("projection", [0, 1, 2, 3])
def test_camera_scalar_block_bit_equal(projection, orientation):
    """The f32 block the wrapper hands ``wrt_camera_rays`` holds, bit for
    bit, the scalars of the JAX package's camera_rays evaluated op by op
    (weak-typed Python floats, f32 trigonometry): the twin reads the same
    block (``camera_scalars``)."""
    fov = 2.0943951023931953 if projection == 1 else 1.3
    pd, vc, coc, focus = 1.0, 0.3, 0.05, 3.0
    st = TSettings(width=3840, height=2160, projection_type=projection,
                   fov_orientation=orientation, fov=fov, panini_distance=pd,
                   vertical_compression=vc, circle_of_confusion=coc,
                   focus_distance=focus)
    f32 = np.float32
    with jax.disable_jit():
        viewport = jnp.array([3840, 2160], dtype=jnp.float32)
        uv_div = (viewport[0], viewport[1],
                  jnp.sqrt(jnp.sum(viewport * viewport)))[orientation]
        want = [
            viewport[0], viewport[1], uv_div,
            -1.0 / jnp.tan(fov / 2.0),
            f32(fov / 2.0),
            jnp.arctan2(jnp.sin(fov / 2.0), jnp.cos(fov / 2.0) + pd),
            f32(pd),
            jstrictf.smul(pd, 1.0 - vc),
            f32(coc), f32(focus),
            f32(fov / jnp.pi * 4.0),
        ]
    block = np.frombuffer(traygen.scalar_block(st), np.float32)
    np.testing.assert_array_equal(
        bits(block), bits(np.array([np.asarray(w) for w in want], f32)))
    np.testing.assert_array_equal(
        bits(block), bits(np.array(traygen.camera_scalars(st), f32)))


# raygen.cuh built for the host: the CUDA qualifiers dropped, the library's
# strict arithmetic kept (no contraction, IEEE division and square root)
_HOST_RAYGEN = r"""
#include <cmath>
#include <cstring>
#define __device__
#define __forceinline__ inline
using std::isfinite;
#include "raygen.cuh"
template <int P, int L>
static void rays(const float* pos, const float* view, const long long* st,
                 const wrt::CameraArgs& a, float* o, float* d,
                 long long* st_out, long long n) {
  for (long long i = 0; i < n; ++i) {
    uint32_t s = static_cast<uint32_t>(st[i]);
    const wrt::CameraRay r =
        wrt::camera_ray<P, L>(pos[2 * i], pos[2 * i + 1], s, view, a);
    const float out[6] = {r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z};
    std::memcpy(o + 3 * i, out, 12);
    std::memcpy(d + 3 * i, out + 3, 12);
    st_out[i] = s;
  }
}
extern "C" void host_camera_rays(const float* pos, const float* view,
                                 const long long* st, int proj, int lens,
                                 const float* args, float* o, float* d,
                                 long long* st_out, long long n) {
  wrt::CameraArgs a;
  std::memcpy(&a, args, sizeof(a));
#define RAYS(P)                                               \
  if (proj == P) {                                            \
    if (lens == 0) rays<P, 0>(pos, view, st, a, o, d, st_out, n); \
    else rays<P, 1>(pos, view, st, a, o, d, st_out, n);       \
  }
  RAYS(0) RAYS(1) RAYS(2) RAYS(3)
}
"""


@pytest.fixture(scope="module")
def host_raygen(tmp_path_factory):
    """``csrc/raygen.cuh`` compiled by g++ into a host library."""
    import webgpu_raytracing_tpu_torch.ops._build as build

    out = tmp_path_factory.mktemp("host_raygen")
    src = out / "host_raygen.cpp"
    src.write_text(_HOST_RAYGEN)
    so = str(out / "libhost_raygen.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-I", build.CSRC_DIR, str(src), "-o", so],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.host_camera_rays.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p,
                                     p, p, p, ctypes.c_longlong]
    lib.host_camera_rays.restype = None
    return lib


@pytest.mark.parametrize("lens", [0, 1], ids=["circle", "square"])
@pytest.mark.parametrize("projection", [0, 1, 2, 3],
                         ids=["fisheye", "panini", "pinhole", "ortho"])
def test_camera_ray_source_matches_twin_on_host(host_raygen, projection,
                                                lens):
    """The kernel's arithmetic (``csrc/raygen.cuh`` on detmath.cuh, built
    for the host with g++, no contraction) gives the CPU twin's o, d and
    state bit for bit: every FoV orientation, circle of confusion 0 and
    0.05, two focus distances, the default and a moved camera, state words
    that wrap past 2^32, 851 rays."""
    w, h = 37, 23
    gen = np.random.default_rng(30 + 2 * projection + lens)
    for orientation in range(3):
        for coc in (0.0, 0.05):
            for focus in (4.0, 1.7):
                for moved in (False, True):
                    pos = torch.from_numpy(_pixel_grid(w, h, gen))
                    cam = Camera()
                    if moved:
                        cam.rotate(np.array([0.3, -0.7], np.float32))
                        cam.move(np.array([0.4, -0.2, 1.3], np.float32))
                    view = torch.from_numpy(cam.view_matrix())
                    state = trng.seed_state(2**32 - int(gen.integers(1, 200)),
                                            torch.arange(w * h))
                    st = TSettings(
                        width=w, height=h, projection_type=projection,
                        lens_shape=lens, fov_orientation=orientation,
                        circle_of_confusion=coc, focus_distance=focus)
                    r = w * h
                    o = torch.empty(r, 3)
                    d = torch.empty(r, 3)
                    st_out = torch.empty(r, dtype=torch.int64)
                    block = traygen.scalar_block(st)
                    host_raygen.host_camera_rays(
                        pos.data_ptr(), view.data_ptr(), state.data_ptr(),
                        projection, lens, ctypes.addressof(block),
                        o.data_ptr(), d.data_ptr(), st_out.data_ptr(), r)
                    want = tcamera_rays.twin(pos, view, state, st)
                    np.testing.assert_array_equal(
                        bits(o.numpy()), bits(want[0].contiguous().numpy()))
                    np.testing.assert_array_equal(
                        bits(d.numpy()), bits(want[1].contiguous().numpy()))
                    np.testing.assert_array_equal(st_out.numpy(),
                                                  want[2].numpy())
