"""PyTorch port: rederive, the kernel of ``csrc/rederive.cu`` and its plain
twin ``_rederive_uv_torch`` in ``ops/cluster_trace.py``.

* ``csrc/rederive.cuh`` built for the host with g++ (no contraction, IEEE
  division) gives the twin's t, u and v bit for bit, NaN equal to NaN, on
  the edge-case batch (:func:`edge_batch`) and on random rays.
* On CPU tensors ``rederive_uv`` is the twin (no launch counted), and it
  equals the JAX package's ``rederive_uv`` bit for bit on the edge-case
  batch, NaN equal to NaN, once its subnormal outputs are flushed to
  zero: XLA on the CPU flushes them (the edge batch's subnormal
  triangle gives t of some 4e-40), the twin and the kernel keep them.
* Every call of a frame goes through the module attributes that the
  benchmark's traced run wraps (``ops.cluster_cuda.rederive_uv``,
  ``ops.integrator.rederive_uv``): one wrapped call for each
  ``wrt.trace.rederive`` span, on path frames (plain, sorted, binned,
  multipass) and a direct frame.

``edge_batch`` also feeds the card test in tests/test_torch_cuda.py, so
this file imports JAX only inside the test that compares with it."""

import ctypes
import subprocess
import types

import numpy as np
import pytest
import torch
from test_torch_shade import assert_same_bits
from torch.profiler import ProfilerActivity, profile

from webgpu_raytracing_tpu_torch.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator as ti
from webgpu_raytracing_tpu_torch.ops.cluster_trace import rederive_uv
from webgpu_raytracing_tpu_torch.renderer import Renderer
from webgpu_raytracing_tpu_torch.utils import timing

torch.set_num_threads(1)

# rederive.cuh built for the host: the CUDA qualifiers dropped, the
# library's strict arithmetic kept (no contraction, IEEE division)
_HOST_REDERIVE = r"""
#include <cmath>
#include <cstdint>
#define __device__
#define __forceinline__ inline
using std::isfinite;
#include "rederive.cuh"
extern "C" void host_rederive_uv(const float* o, const float* d,
                                 const float* t, const int32_t* face,
                                 const float* tri, float* out, long long n) {
  for (long long i = 0; i < n; ++i)
    wrt::rederive_lane(o, d, t, face, tri, out, n, i);
}
"""


def edge_batch(r=512, seed=19):
    """(o, d, t, face, tables) on the CPU: random rays against 40 random
    triangles, a third of them misses, and crafted lanes: misses with t
    +inf, F32_MAX and NaN (one with a NaN direction); the last face; det
    exactly 0 (a direction in the triangle's plane); |det| of 1e-32 and
    of a subnormal 1e-40 (under 1e-30); det overflowing to -inf; NaN and
    +-inf components in d; a NaN origin."""
    g = np.random.default_rng(seed)
    f = 40
    tri = (g.normal(size=(f, 9)) * 2.0).astype(np.float32)
    tri[1] = [0, 0, -3, 1, 0, 0, 0, 1, 0]  # in z = -3: e1 = x, e2 = y
    tri[2] = [0, 0, -3, 1e-16, 0, 0, 0, 1e-16, 0]
    tri[3] = [0, 0, -3, 1e-20, 0, 0, 0, 1e-20, 0]
    tri[4] = [0, 0, -3, 1e20, 0, 0, 0, 1e20, 0]
    o = g.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = g.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = g.uniform(0.1, 9.0, r).astype(np.float32)
    face = g.integers(0, f, r).astype(np.int32)
    face[g.uniform(size=r) < 0.33] = -1
    inf, nan = np.inf, np.nan
    lanes = [  # face, d (None: keep), t (None: keep)
        (-1, None, inf), (-1, None, F32_MAX), (-1, None, nan),
        (-1, (nan, 0.0, 1.0), inf), (f - 1, None, None),
        (1, (1.0, 0.0, 0.0), None), (1, (0.0, 1.0, 0.0), None),
        (1, (0.0, 0.0, -1.0), None), (2, (0.0, 0.0, 1.0), None),
        (3, (0.0, 0.0, 1.0), None), (4, (0.0, 0.0, 1.0), None),
        (0, (nan, 0.5, 0.5), None), (0, (inf, 0.0, 0.0), None),
        (0, (0.0, -inf, 1.0), None), (f - 1, (-inf, inf, 0.0), None),
        (f - 1, (0.0, 0.0, nan), None),
    ]
    for i, (fc, dv, tv) in enumerate(lanes):
        face[i] = fc
        if dv is not None:
            d[i] = dv
        if tv is not None:
            t[i] = tv
    o[len(lanes)] = (nan, 0.0, 0.0)
    face[len(lanes)] = 0
    tables = types.SimpleNamespace(tri=torch.from_numpy(tri))
    return (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
            torch.from_numpy(face), tables)


@pytest.fixture(scope="module")
def host_rederive(tmp_path_factory):
    """``csrc/rederive.cuh`` compiled by g++ into a host library."""
    import webgpu_raytracing_tpu_torch.ops._build as build

    out = tmp_path_factory.mktemp("host_rederive")
    src = out / "host_rederive.cpp"
    src.write_text(_HOST_REDERIVE)
    so = str(out / "libhost_rederive.so")
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-I", build.CSRC_DIR, str(src), "-o", so],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.host_rederive_uv.argtypes = [p] * 6 + [ctypes.c_longlong]
    lib.host_rederive_uv.restype = None
    return lib


@pytest.mark.parametrize("which", ["edge", "random"])
def test_host_lane_matches_twin(host_rederive, which):
    if which == "edge":
        o, d, t, face, tables = edge_batch()
    else:
        o, d, t, face, tables = edge_batch(4096, seed=3)
        face = torch.from_numpy(np.random.default_rng(8).integers(
            -1, tables.tri.shape[0], 4096).astype(np.int32))
    r = o.shape[0]
    out = torch.full((3, r), 7.0)
    host_rederive.host_rederive_uv(
        o.data_ptr(), d.data_ptr(), t.data_ptr(), face.data_ptr(),
        tables.tri.data_ptr(), out.data_ptr(), r)
    want = rederive_uv.twin(o, d, t, face, tables)
    for i, name in enumerate("tuv"):
        assert_same_bits(out[i], getattr(want, name), name)


def test_cpu_runs_twin_and_matches_jax():
    import jax.numpy as jnp

    from webgpu_raytracing_tpu.ops.cluster_pallas import (
        rederive_uv as j_rederive_uv,
    )

    o, d, t, face, tables = edge_batch()
    before = rederive_uv.launches
    got = rederive_uv(o, d, t, face, tables)
    assert rederive_uv.launches == before
    assert got.face is face
    want = rederive_uv.twin(o, d, t, face, tables)
    jr = j_rederive_uv(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                       jnp.asarray(t.numpy()), jnp.asarray(face.numpy()),
                       types.SimpleNamespace(tri=jnp.asarray(
                           tables.tri.numpy())))
    for name in "tuv":
        g = getattr(got, name)
        assert torch.equal(g.view(torch.int32),
                           getattr(want, name).view(torch.int32)), name
        j = torch.from_numpy(np.array(getattr(jr, name)))
        tiny = g.abs() < np.finfo(np.float32).tiny
        assert_same_bits(torch.where(tiny, g * 0.0, g), j, name)


# frames whose closest-hit legs reach each call site: cluster_cuda's (the
# unsorted legs), integrator's three (sorted, binned, multipass)
FRAMES = {
    "path": dict(),
    "direct": dict(bounces_depth=1),
    "sorted": dict(sort_bounce_rays=True),
    "binned": dict(sort_bounce_rays=True, binned_sort=True),
    "multipass": dict(sort_bounce_rays=True, multipass_cap=4,
                      kernel_near=False),
}


@pytest.mark.parametrize("kind", list(FRAMES))
def test_every_call_goes_through_the_wrapped_attributes(kind, monkeypatch):
    """The benchmark's ``bench.rederive`` ranges wrap the module attributes
    (bench_torch/run.py ``RANGES``, ``Patches.wrap``); a call site that
    bound the kernel otherwise would leave ``rederive.gpu_ms`` short."""
    scene = scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )
    st = RenderSettings(**{**dict(width=32, height=32, bounces_depth=3),
                           **FRAMES[kind]})
    r = Renderer(scene, st, base_seed=3, device="cpu")
    r.tables = scene.tables("cpu", cluster_size=16)
    calls = []

    def wrap(mod):
        fn = getattr(mod, "rederive_uv")

        def wrapper(*args, **kw):
            calls.append(mod.__name__)
            return fn(*args, **kw)

        monkeypatch.setattr(mod, "rederive_uv", wrapper)

    wrap(cc)
    wrap(ti)
    with timing.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        r.step()
    spans = [e for e in p.events() if e.name == "wrt.trace.rederive"]
    samples = 1 + st.sample_count
    legs = samples * (1 if kind == "direct" else st.bounces_depth - 1)
    assert len(calls) == len(spans) == legs, (calls, len(spans))
    sorted_legs = samples * (st.bounces_depth - 2) if st.sort_bounce_rays \
        else 0
    assert calls.count(ti.__name__) == sorted_legs, calls
    # the twins launch nothing, so the frame's counter stays empty
    assert "rederive.kernel_launches" not in r.last_counts
