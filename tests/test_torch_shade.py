"""PyTorch port: a path segment's shading, the two kernels of
``csrc/shade.cu`` and their plain twins in ``ops/integrator.py``.

* ``csrc/shade.cuh`` built for the host with g++ (no contraction, IEEE
  division and square root) gives the twins' outputs bit for bit on
  random lanes: flat and Phong shading, env-IS on and off past the first
  segment, ``run_env`` on and off, tables with and without partner codes,
  dead and missed lanes, NaN origins from ``offset_ray``'s inverted
  select, NaN throughput through the roulette's max. The pointer block
  comes from the wrappers' own ``_shade_*_buffers``, so the order of its
  fields is held too.
* On CPU tensors ``shade_hit`` / ``shade_bounce`` are their twins (no
  launch); another device raises; the argument checks raise: cases of
  tests/test_torch_binding.py.
* ``path_trace`` through the twins: whole frames of every shading mode
  are held bit for bit to the JAX package run op by op
  (tests/test_torch_render.py, tests/test_torch_nee.py,
  tests/test_torch_envis.py)."""

import ctypes
import subprocess
import types

import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu_torch.config import ShadingType
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops import integrator as ti
from webgpu_raytracing_tpu_torch.ops.intersect import Hit

torch.set_num_threads(1)

# shade.cuh built for the host: the CUDA qualifiers dropped, the library's
# strict arithmetic kept (no contraction, IEEE division and square root)
_HOST_SHADE = r"""
#include <cmath>
#include <cstring>
#define __device__
#define __forceinline__ inline
using std::isfinite;
#include "shade.cuh"
extern "C" void host_shade_hit(const void* const* ptrs, int phong,
                               int env_mis, long long n) {
  wrt::ShadeHitArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  for (long long i = 0; i < n; ++i) {
    if (phong && env_mis) wrt::shade_hit_lane<true, true>(a, i);
    else if (phong) wrt::shade_hit_lane<true, false>(a, i);
    else if (env_mis) wrt::shade_hit_lane<false, true>(a, i);
    else wrt::shade_hit_lane<false, false>(a, i);
  }
}
extern "C" void host_shade_bounce(const void* const* ptrs, int env_is,
                                  int run_env, long long n) {
  wrt::ShadeBounceArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  for (long long i = 0; i < n; ++i) {
    if (env_is) wrt::shade_bounce_lane<true>(a, run_env != 0, i);
    else wrt::shade_bounce_lane<false>(a, run_env != 0, i);
  }
}
"""


@pytest.fixture(scope="module")
def host_shade(tmp_path_factory):
    """``csrc/shade.cuh`` compiled by g++ into a host library."""
    import webgpu_raytracing_tpu_torch.ops._build as build

    out = tmp_path_factory.mktemp("host_shade")
    src = out / "host_shade.cpp"
    src.write_text(_HOST_SHADE)
    so = str(out / "libhost_shade.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-I", build.CSRC_DIR, str(src), "-o", so],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("host_shade_hit", "host_shade_bounce"):
        getattr(lib, name).argtypes = [p, i, i, ctypes.c_longlong]
        getattr(lib, name).restype = None
    return lib


def assert_same_bits(got, want, what):
    """Equal bit for bit, but NaN equals NaN whatever its payload."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.float32:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), what
        got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


def _tables(gen, partner):
    """Random scene tables of 61 faces and 4 materials; a few rows place
    a hit point on exact zeros (-0 with a positive normal component: the
    inverted select's NaN origin), under 1/32 (the integer offset), or
    give the face normal a zero or a NaN component."""
    f, k = 61, 4
    tri = gen.normal(size=(f, 9)).astype(np.float32) * 2.0
    shade = gen.normal(size=(f, 12)).astype(np.float32)
    tri[0:4, [0, 3, 6]] = -0.0  # x of every point of these faces is -0
    shade[0:4, 0] = 0.5
    tri[4:8, 0:3] *= 0.01  # p0 within 1/32 of zero
    tri[4:8, 3:9] *= 0.001
    shade[8, 1] = 0.0
    shade[9, 2] = np.nan
    mat = gen.integers(0, k, f).astype(np.int32)
    emission = gen.uniform(0, 3, (k, 3)).astype(np.float32)
    emission[0] = 0.0
    clusters = types.SimpleNamespace(
        partner_code=torch.from_numpy(
            gen.integers(-1, 5000, f).astype(np.int32)) if partner else None)
    return types.SimpleNamespace(
        tri=torch.from_numpy(tri), shade_normal=torch.from_numpy(shade),
        face_material=torch.from_numpy(mat),
        mat_emission=torch.from_numpy(emission),
        mat_color=torch.from_numpy(gen.uniform(0, 1, (k, 3)).astype(
            np.float32)),
        clusters=clusters)


def _lanes(gen, r, n_faces):
    """A segment's lane state: a third of the lanes miss, a fifth are
    dead; throughput has NaN, zero and above-one lanes."""
    def f32(*shape, scale=1.0):
        return torch.from_numpy(
            (gen.normal(size=shape) * scale).astype(np.float32))

    face = gen.integers(0, n_faces, r).astype(np.int32)
    face[gen.uniform(size=r) < 0.33] = -1
    face[:8] = np.arange(8)  # the crafted rows
    u = gen.uniform(0, 1, r).astype(np.float32)
    v = (gen.uniform(0, 1, r) * (1 - u)).astype(np.float32)
    u[::17] = 0.0
    hit = Hit(t=f32(r), u=torch.from_numpy(u), v=torch.from_numpy(v),
              face=torch.from_numpy(face))
    alive = torch.from_numpy(gen.uniform(size=r) > 0.2)
    alive[:8] = True
    thr = torch.from_numpy(gen.uniform(0, 1.3, (r, 3)).astype(np.float32))
    thr[5::23, 1] = float("nan")
    thr[7::29] = 0.0
    state = torch.from_numpy(
        gen.integers(2**32 - 2**20, 2**32, r).astype(np.int64))
    state[::3] = torch.from_numpy(gen.integers(0, 2**32, (r + 2) // 3))
    return dict(hit=hit, alive=alive, d=f32(r, 3), color=f32(r, 3),
                throughput=thr, env_dir=f32(r, 3), env_w=f32(r, 3),
                env_mis_pdf=f32(r), prev_bsdf_pdf=f32(r).abs(), state=state,
                o=f32(r, 3, scale=3.0))


CASES = {  # shading, env_is, segment, run_env, partner codes
    "flat": (ShadingType.FLAT, False, 1, False, True),
    "phong": (ShadingType.PHONG, False, 2, False, True),
    "phong_envis_run_env": (ShadingType.PHONG, True, 1, True, True),
    "phong_envis_no_partner": (ShadingType.PHONG, True, 2, False, False),
    "flat_envis_run_env_no_partner": (ShadingType.FLAT, True, 2, True,
                                      False),
    "flat_envis_first_segment": (ShadingType.FLAT, True, 0, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shade_source_matches_twins_on_host(host_shade, case):
    """Both lanes' functions on 3,001 random lanes, the bounce fed the
    hit's outputs as the integrator feeds it."""
    shading, env_is, seg, run_env, partner = CASES[case]
    env_mis = env_is and seg > 0
    gen = np.random.default_rng(sorted(CASES).index(case))
    tables = _tables(gen, partner)
    x = _lanes(gen, 3001, tables.tri.shape[0])
    hit_args = (x["hit"], x["alive"], x["d"], x["color"], x["throughput"],
                x["env_dir"], x["env_w"], x["env_mis_pdf"],
                x["prev_bsdf_pdf"], tables)
    want = ti.shade_hit.twin(*hit_args, shading, env_mis)
    got, block, keep = ti._shade_hit_buffers(*hit_args, env_mis)
    host_shade.host_shade_hit(ctypes.addressof(block),
                              int(shading == ShadingType.PHONG),
                              int(env_mis), 3001)
    for name, g, w in zip(ti.HitShading._fields, got, want):
        if w is None:
            assert g is None, name
        else:
            assert_same_bits(g, w, name)
    assert torch.isnan(want.new_o).any()  # the inverted select
    h = want.h
    assert (~x["alive"]).any() and (x["alive"] & (x["hit"].face < 0)).any()

    bounce_args = (x["state"], h, want.n, want.new_o, want.throughput,
                   x["o"], x["d"], x["prev_bsdf_pdf"])
    want_b = ti.shade_bounce.twin(*bounce_args, env_is, run_env)
    got_b, block, keep = ti._shade_bounce_buffers(*bounce_args, env_is)
    host_shade.host_shade_bounce(ctypes.addressof(block), int(env_is),
                                 int(run_env), 3001)
    for name, g, w in zip(ti.Bounce._fields, got_b, want_b):
        assert_same_bits(g, w, name)
    nan_p = torch.isnan(want.throughput).any(-1) & h
    assert nan_p.any() and not want_b.alive[nan_p].any()
    assert want_b.alive.any() and (h & ~want_b.alive).any()
    if env_is:
        assert not torch.equal(want_b.prev_bsdf_pdf, x["prev_bsdf_pdf"])
    else:
        assert want_b.prev_bsdf_pdf is x["prev_bsdf_pdf"]


# --- a scene for the card's whole-frame tests (tests/test_torch_cuda.py)

def _scene(floor_y):
    return scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 1.2, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(floor_y, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )
