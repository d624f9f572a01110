"""PyTorch port: a light sample of NEE, the two kernels of
``csrc/light.cu`` and their plain twins in ``ops/integrator.py``.

* ``csrc/light.cuh`` built for the host with g++ (no contraction, IEEE
  division and square root) gives the twins' outputs bit for bit on
  random lanes: flat and Phong shading normals, a light model of one
  face and of many, ``samples_per_point`` 1 and 2, inactive and
  shadowed lanes, NaN shading points and NaN light points from
  ``offset_ray``'s inverted select, and zero contributions whose sign
  the first sample's +0 colour sets. The pointer blocks come from the
  wrappers' own ``_light_*_buffers``, so the order of their fields is
  held too.
* On CPU tensors ``light_sample`` / ``light_add`` are their twins (no
  launch); another device raises; the argument checks raise: cases of
  tests/test_torch_binding.py.
* ``direct_light`` through the twins is held bit for bit to the JAX
  package run op by op (tests/test_torch_nee.py)."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch
from test_torch_shade import _tables, assert_same_bits

from webgpu_raytracing_tpu_torch.config import ShadingType
from webgpu_raytracing_tpu_torch.ops import integrator as ti

torch.set_num_threads(1)

# light.cuh built for the host: the CUDA qualifiers dropped, the library's
# strict arithmetic kept (no contraction, IEEE division and square root)
_HOST_LIGHT = r"""
#include <cmath>
#include <cstring>
#define __device__
#define __forceinline__ inline
using std::isfinite;
#include "light.cuh"
extern "C" void host_light_sample(const void* const* ptrs, long long n) {
  wrt::LightSampleArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  for (long long i = 0; i < n; ++i) wrt::light_sample_lane(a, n, i);
}
extern "C" void host_light_add(const void* const* ptrs, int spp, int last,
                               long long n) {
  wrt::LightAddArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  for (long long i = 0; i < n; ++i)
    wrt::light_add_lane(a, spp, last != 0, n, i);
}
"""


@pytest.fixture(scope="module")
def host_light(tmp_path_factory):
    """``csrc/light.cuh`` compiled by g++ into a host library."""
    import webgpu_raytracing_tpu_torch.ops._build as build

    out = tmp_path_factory.mktemp("host_light")
    src = out / "host_light.cpp"
    src.write_text(_HOST_LIGHT)
    so = str(out / "libhost_light.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-I", build.CSRC_DIR, str(src), "-o", so],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_light_sample.argtypes = [p, ctypes.c_longlong]
    lib.host_light_add.argtypes = [p, i, i, ctypes.c_longlong]
    lib.host_light_sample.restype = lib.host_light_add.restype = None
    return lib


def light_tables(gen, light_faces):
    """tests/test_torch_shade.py's random tables (61 faces: faces 0-3 with
    every x exactly -0 and a positive normal x, so their offset points are
    NaN; 4-7 within 1/32 of zero; a zero and a NaN normal component) with
    model 0, the light, over faces [offset, offset + count), its first
    face of material 1, whose emission has a -0 (a -0 contribution on
    unshadowed lanes)."""
    t = _tables(gen, True)
    offset, count = light_faces
    t.model_face_offset = torch.tensor([offset, 10, 40], dtype=torch.int32)
    t.model_face_count = torch.tensor([count, 30, 21], dtype=torch.int32)
    t.mat_emission[1, 2] = -0.0
    t.face_material[offset] = 1  # the first light face emits
    return t


def light_lanes(gen, r, tables, shading):
    """Shading points, normals, RNG states and the shadow flags of ``r``
    lanes: points at random face points offset as shade_hit offsets them
    (a few NaN), normals of those faces (``shading``), a fifth of the
    lanes inactive (never shadowed) and a third of the rest shadowed."""
    f = torch.from_numpy(gen.integers(0, tables.tri.shape[0], r))
    f[:16] = torch.arange(16)  # the crafted rows
    u = torch.from_numpy(gen.uniform(0, 1, r).astype(np.float32))
    v = torch.from_numpy((gen.uniform(0, 1, r) * (1 - u.numpy())).astype(
        np.float32))
    point = ti.face_point_offset(tables.tri[f], tables.shade_normal[f], u, v)
    normal = ti.face_normal(tables.shade_normal[f], u, v, shading)
    state = torch.from_numpy(
        gen.integers(2**32 - 2**20, 2**32, r).astype(np.int64))
    state[::3] = torch.from_numpy(gen.integers(0, 2**32, (r + 2) // 3))
    active = torch.from_numpy(gen.uniform(size=r) > 0.2)
    shadowed = active & torch.from_numpy(gen.uniform(size=r) < 0.33)
    return point, normal, state, shadowed


def _craft_zeros(ray, normal):
    """Lanes 16-23 given a shadow direction and a normal whose dot is
    exactly -0 (its products all -0), and a finite 1/pdf and distance: the
    clamped cosine keeps -0, so an unshadowed contribution is -0 and the
    first sample's colour +0."""
    d, carry, normal = ray.d.clone(), ray.carry.clone(), normal.clone()
    d[16:24] = torch.tensor([1.0, 0.0, 0.0])
    normal[16:24] = torch.tensor([-0.0, -1.0, -1.0])
    carry[:2, 16:24] = torch.tensor([[1.5], [4.0]])
    return ray._replace(d=d, carry=carry), normal


CASES = {  # shading, light faces (offset, count), samples_per_point
    "flat_one_face_spp1": (ShadingType.FLAT, (12, 1), 1),
    "phong_one_face_spp2": (ShadingType.PHONG, (5, 1), 2),
    "flat_many_faces_spp2": (ShadingType.FLAT, (0, 20), 2),
    "phong_many_faces_spp1": (ShadingType.PHONG, (0, 61), 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_light_source_matches_twins_on_host(host_light, case):
    """Both lanes' functions on 3,001 random lanes, sample by sample as
    ``direct_light`` chains them: the state, colour and carry of one
    sample feed the next."""
    shading, light_faces, spp = CASES[case]
    gen = np.random.default_rng(40 + sorted(CASES).index(case))
    tables = light_tables(gen, light_faces)
    r = 3001
    point, normal, state, shadowed = light_lanes(gen, r, tables, shading)
    assert torch.isnan(point).any() and (~torch.isnan(point)).any()
    color = None
    for k in range(spp):
        want = ti.light_sample.twin(point, state, tables)
        got, block, keep = ti._light_sample_buffers(point, state, tables)
        host_light.host_light_sample(ctypes.addressof(block), r)
        for name, g, w in zip(ti.LightRay._fields, got, want):
            assert_same_bits(g, w, name)
        assert not torch.equal(want.state, state)
        if light_faces == (0, 20):  # faces 0-3: NaN light points
            assert torch.isnan(want.t_max).any()

        ray, n = _craft_zeros(want, normal)
        last = k == spp - 1
        want_c = ti.light_add.twin(shadowed, ray.d, n, ray.carry, color,
                                   tables, spp, last)
        got_c, block, keep = ti._light_add_buffers(shadowed, ray.d, n,
                                                   ray.carry, color, tables)
        host_light.host_light_add(ctypes.addressof(block), spp, int(last), r)
        assert_same_bits(got_c, want_c, f"color of sample {k}")
        if k == 0:  # the -0 contributions come out +0
            zero = want_c[16:24][~shadowed[16:24]]
            assert zero.numel() and (zero.view(torch.int32) == 0).all()
            assert (want_c[shadowed] == 0).any()
        assert torch.isnan(want_c).any()
        lit = ~shadowed & ~torch.isnan(want_c).any(-1)
        assert (want_c[lit] > 0).any()
        color, state = want_c, want.state
