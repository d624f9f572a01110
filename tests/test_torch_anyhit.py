"""PyTorch port: the any-hit (shadow-ray) cluster trace against the JAX
package.

The kernel's plain-torch twin runs here (CPU tensors); the CUDA kernel is
held against the twin on the card in tests/test_torch_cuda.py. The twin
follows the exact ``0 < t < t_max`` bound of the XLA clustered trace and
the threaded BVH oracle, so its flags equal theirs exactly on the ray sets
of tests/test_cluster.py. The Pallas kernel compares truncated packed keys
against t_max, so it may differ where t is within its key granularity of
t_max: on a NEE shadow set, whose rays end on the light's own face, the
agreement is a share, not equality."""

import os
import subprocess
import sys

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
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu.ops.cluster_trace import (
    trace_any_clustered,
    trace_closest_clustered,
)
from webgpu_raytracing_tpu.ops.integrator import (
    face_point_offset as j_face_point_offset,
)
from webgpu_raytracing_tpu.ops.traverse import trace_any as j_oracle
from webgpu_raytracing_tpu_torch.models.scene import tables_from_numpy
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

torch.set_num_threads(1)

TABLE_FIELDS = (
    "node_box", "node_meta", "tri", "shade_normal", "face_material",
    "model_face_offset", "model_face_count", "mat_color", "mat_emission",
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(scene):
    jt = scene.tables()
    arrays = {k: np.asarray(getattr(jt, k)) for k in TABLE_FIELDS}
    for k in ("box", "mat_b", "face_id", "partner_code"):
        arrays["clusters." + k] = np.asarray(getattr(jt.clusters, k))
    return jt, tables_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """tests/test_cluster.py scene (sphere, plane, two-sided cube)."""
    return _pair(scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    ))


def _rays(n, seed=1234):
    """tests/test_cluster.py's any-hit ray set."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(tt, o, d, tmax, active=None, excl=None):
    return cc.trace_any_clustered_cuda(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax), tt,
        None if active is None else torch.from_numpy(active),
        None if excl is None else torch.from_numpy(excl),
    ).numpy()


def _jax_refs(jt, o, d, tmax, active=None):
    a = None if active is None else jnp.asarray(active)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, a)
    return (
        np.asarray(trace_any_clustered(*args, tile=128)),
        np.asarray(j_oracle(*args)),
    )


@pytest.mark.parametrize("tmax_val", [F32_MAX, 2.5], ids=["unbounded", "2.5"])
def test_any_twin_matches_clustered_and_oracle(scenes, tmax_val):
    jt, tt = scenes
    n = 384
    o, d = _rays(n)
    tmax = np.full((n,), tmax_val, np.float32)
    got = _port(tt, o, d, tmax)
    clustered, oracle = _jax_refs(jt, o, d, tmax)
    np.testing.assert_array_equal(got, clustered)
    np.testing.assert_array_equal(got, oracle)
    assert 20 < got.sum() < n - 20


def _exclusion_set(jt, n, seed):
    """Rays leaving the hit points of a primary set, with the source face's
    two-sided duplicate excluded by code (as path_trace passes it)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    prim = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), jnp.full((n,), F32_MAX), jt, tile=128
    )
    face = np.asarray(prim.face)
    hit = face >= 0
    fc = np.maximum(face, 0)
    shade = np.asarray(jt.shade_normal)[fc]
    o2 = np.array(j_face_point_offset(
        jnp.asarray(np.asarray(jt.tri)[fc]), jnp.asarray(shade), prim.u, prim.v
    ))
    d2 = rng.normal(size=(n, 3)).astype(np.float32)
    d2 = d2 / np.linalg.norm(d2, axis=1, keepdims=True) + shade[:, 0:3]
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    excl = np.where(
        hit, np.asarray(jt.clusters.partner_code)[fc], -1
    ).astype(np.int32)
    return o2, d2, hit, excl


@pytest.mark.parametrize(
    "case", ["inactive", "exclusion", "nan_origin", "exact_tmax"]
)
def test_any_twin_edge_cases(scenes, case):
    """Inactive lanes and NaN origins come out unblocked; exclusion codes
    skip the source face's duplicate (exact arithmetic rejects it by
    t > 0 anyway, so the JAX references, which take no codes, agree); the
    bound is strict: a ray whose t_max is exactly the distance of its
    closest face is unblocked, and 1e-5 further it is blocked."""
    jt, tt = scenes
    n = 1000  # not a whole number of 128-ray tiles: tail padding
    o, d = _rays(n, seed=77)
    rng = np.random.default_rng(78)
    tmax = rng.uniform(0.5, 6.0, n).astype(np.float32)
    active = excl = None
    if case == "inactive":
        active = rng.uniform(size=n) > 0.3
    elif case == "exclusion":
        o, d, active, excl = _exclusion_set(jt, n, seed=79)
        assert (excl >= 0).sum() > 50
        tmax = np.full((n,), F32_MAX, np.float32)
    elif case == "nan_origin":
        o[rng.uniform(size=n) < 0.1, rng.integers(0, 3)] = np.nan
        assert np.isnan(o).any()
    elif case == "exact_tmax":
        closest = cc.trace_closest_clustered_cuda(
            torch.from_numpy(o), torch.from_numpy(d),
            torch.full((n,), F32_MAX), tt,
        )
        hit = closest.face.numpy() >= 0
        assert hit.sum() > 100
        t_hit = closest.t.numpy()
        at = np.where(hit, t_hit, np.float32(2.0)).astype(np.float32)
        got_at = _port(tt, o, d, at)
        assert not got_at[hit].any()
        # clearly above (box entry distances round apart from MT's t by
        # a few ulps and may prune the cluster at t + 1 ulp)
        above = (at * np.float32(1 + 1e-5)).astype(np.float32)
        got_above = _port(tt, o, d, above)
        assert got_above[hit].all()
        for t_set, got in ((at, got_at), (above, got_above)):
            clustered, oracle = _jax_refs(jt, o, d, t_set)
            np.testing.assert_array_equal(got, clustered)
            np.testing.assert_array_equal(got, oracle)
        return
    got = _port(tt, o, d, tmax, active, excl)
    clustered, oracle = _jax_refs(jt, o, d, tmax, active)
    np.testing.assert_array_equal(got, clustered)
    np.testing.assert_array_equal(got, oracle)
    if active is not None:
        assert not got[~active].any()
    if case == "nan_origin":
        assert not got[np.isnan(o).any(axis=1)].any()
    assert got.sum() > 5


@pytest.mark.parametrize(
    "kw",
    [dict(lockstep=True, tiles_per_step=2), dict(lockstep=False)],
    ids=["lockstep", "serial"],
)
def test_any_twin_matches_pallas_interpret(scenes, kw):
    """tests/test_cluster.py's any-hit sets, where the Pallas kernel itself
    equals the oracle: the twin's flags equal the kernel's exactly."""
    jt, tt = scenes
    n = 384
    o, d = _rays(n)
    for tmax_val in (F32_MAX, 2.5):
        tmax = np.full((n,), tmax_val, np.float32)
        pk = trace_closest_clustered_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt, tile=128,
            interpret=True, any_hit=True, **kw,
        )
        np.testing.assert_array_equal(
            _port(tt, o, d, tmax), np.asarray(pk.face) >= 0
        )


def test_nee_shadow_set_vs_pallas_interpret():
    """The mini scene's NEE shadow rays (primary hits → light samples,
    t_max = distance to the light point, exclusion codes): the twin equals
    the XLA clustered trace and the oracle exactly. Against the Pallas
    kernel the flags agree on 409 of 414 live rays (98.8%, not the 99.9%
    first expected), and every disagreement is a knife edge of the
    kernel's bf16 hi/lo matmul t and truncated t_max key: four rays whose
    light face lies within 1.3e-5 relative beyond t_max (the light point
    is offset 2^-16 off its own face), and one ray leaving a light face
    that meets that face again at t = 2e-5 (the reference's inverted
    offset select moved its origin inside). The test asserts both: the
    share, and that each disagreement is such a knife edge."""
    from webgpu_raytracing_tpu.models import test_models as jtm
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops import integrator as ti

    jt, tt = _pair(scene_from_facesets(
        [
            ("light", jtm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                    lon=6)),
            ("sphere", jtm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", jtm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    ))
    n = 1024
    rng = np.random.default_rng(31)
    o = np.tile(np.array([[0.0, 0.5, 2.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = RenderSettings()
    prim = cc.trace_closest_clustered_cuda(
        torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), F32_MAX),
        tt,
    )
    found = prim.face >= 0
    f = prim.face.clamp(min=0).long()
    point = ti.face_point_offset(tt.tri[f], tt.shade_normal[f], prim.u, prim.v)
    excl = torch.where(found, tt.clusters.partner_code[f], -1)
    state = torch.arange(n, dtype=torch.int64) * 2654435761 & 0xFFFFFFFF
    ls, _ = ti.sample_lights(state, tt, st)
    dirn, tmax, _ = ti.light_ray(point, ls)
    got = cc.trace_any_clustered_cuda(point, dirn, tmax, tt, found, excl)
    got = got.numpy()
    args = [x.numpy() for x in (point, dirn, tmax, found, excl)]
    clustered, oracle = _jax_refs(jt, *args[:4])
    np.testing.assert_array_equal(got, clustered)
    np.testing.assert_array_equal(got, oracle)
    pk = np.asarray(trace_closest_clustered_pallas(
        *[jnp.asarray(a) for a in args[:3]], jt, jnp.asarray(args[3]),
        tile=128, interpret=True, any_hit=True,
        excl_code=jnp.asarray(args[4]),
    ).face) >= 0
    live = args[3]
    bad = np.nonzero(pk != got)[0]
    # exact distance of the first face along each disagreeing ray
    t_first = cc.trace_closest_clustered_cuda(
        point[bad], dirn[bad], torch.full((bad.size,), F32_MAX), tt, None,
        excl[bad],
    ).t.numpy()
    for i, t in zip(bad, t_first):
        print(f"ray {i}: twin {got[i]}, Pallas {pk[i]}, t_max {args[2][i]!r}, "
              f"first face at t {t!r}")
    agree = 1.0 - bad.size / live.sum()
    print(f"NEE shadow set: {live.sum()} live rays, {got.sum()} blocked, "
          f"Pallas agreement {agree:.5f}")
    assert got[live].any() and not got[live].all()
    knife = (np.abs(t_first - args[2][bad]) <= 2e-5 * args[2][bad]) | (
        t_first <= 1e-4
    )
    assert knife.all(), bad[~knife]
    assert agree >= 0.98, agree


def test_any_wrapper_never_runs_the_twin_for_other_devices(scenes):
    _, tt = scenes
    o, d = _rays(256)
    args = cc.prepare_tiles(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.full((256,), F32_MAX), tt,
    )
    before = cc.trace_any_tiles.launches
    with pytest.raises(ValueError):
        cc._launch_kernel(**args, any_hit=True)
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
            for k, v in args.items()}
    with pytest.raises(ValueError):
        cc.trace_any_tiles(**meta)
    # the twin is not a launch
    cc.trace_any_tiles(**args)
    assert cc.trace_any_tiles.launches == before


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import webgpu_raytracing_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) > 20, names\n"
        "assert 'webgpu_raytracing_tpu_torch.ops.ray_sort' in names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m == 'webgpu_raytracing_tpu' or m.startswith(('jax.', 'jaxlib', 'webgpu_raytracing_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
