"""PyTorch port: the ``traversal`` dispatch, ``chained_sort`` and the
route of the kernel wrappers.

* Every ``traversal`` renders a small frame on the CPU but ``"pallas"``,
  which runs only the CUDA kernels and raises here; the ``"threaded"``,
  ``"clustered"`` and ``"pallas_interpret"`` frames equal the ``"auto"``
  frame (RMSE < 1e-5; bit for bit in fact); an unknown value raises.
* ``chained_sort``: the four cases of tests/test_chained_sort.py on the
  port, with ``sort_bounce_rays`` on (the port's default is off). At the
  integrator level color, RNG state and first-hit faces are exactly
  equal to the per-trace sort's, for "clustered", with NEE, and for
  "pallas_interpret". For whole frames JAX bounds the relative deviation
  at 1e-6 (its two jitted graphs differ); eager torch computes the same
  operations per lane in both, and the frames are equal bit for bit.
* ``--opt traversal=...`` and ``--opt chained_sort=1`` reach
  ``RenderSettings`` through the CLI.
* the wrappers' routes (ops/cluster_cuda.py ROUTES) and the check that the
  rays lie on the current CUDA device, as a unit test of CPU-side logic."""

import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu_torch.config import F32_MAX
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.frontend import cli
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort, rng
from webgpu_raytracing_tpu_torch.ops.integrator import path_trace
from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays
from webgpu_raytracing_tpu_torch.renderer import Renderer
from webgpu_raytracing_tpu_torch.utils.image import read_image

torch.set_num_threads(1)


def bits(x):
    return x.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def scene():
    """A light, a finely cut sphere, a cube and the floor: a few hundred
    faces in some twenty clusters of 16, so that sorted and chained
    segments really permute their lanes."""
    return scene_from_facesets(
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


def _renderer(scene, st, seed=3):
    r = Renderer(scene, st, base_seed=seed, device="cpu")
    r.tables = scene.tables("cpu", cluster_size=16)
    return r


def _frame(scene, frames=2, **kw):
    st = TSettings(width=16, height=16, bounces_depth=3, sample_count=1,
                   **kw)
    r = _renderer(scene, st)
    for _ in range(frames):
        r.step()
    return r.buffers


FRAME_KW = {
    "plain": {},
    "nee_sorted": dict(next_event_estimation=True, sort_bounce_rays=True),
}


@pytest.mark.parametrize("kw", list(FRAME_KW))
@pytest.mark.parametrize("traversal",
                         ["threaded", "clustered", "pallas_interpret"])
def test_traversal_frame_equals_auto(scene, traversal, kw):
    want = _frame(scene, **FRAME_KW[kw])
    got = _frame(scene, traversal=traversal, **FRAME_KW[kw])
    a, b = got.image.numpy(), want.image.numpy()
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    rmse = float(np.sqrt(np.mean((a[~nan] - b[~nan]) ** 2)))
    assert rmse < 1e-5, rmse
    np.testing.assert_array_equal(a[..., 3], b[..., 3])
    np.testing.assert_array_equal(got.geo_face.numpy(),
                                  want.geo_face.numpy())


def test_pallas_runs_only_the_kernels(scene):
    """``traversal="pallas"`` on CPU tensors raises at the first launch:
    the twin never runs in the kernel's place."""
    r = _renderer(scene, TSettings(width=8, height=8, traversal="pallas"))
    with pytest.raises(ValueError, match="route 'kernel'"):
        r.step()


def test_unknown_traversal_raises(scene):
    with pytest.raises(ValueError, match="traversal"):
        Renderer(scene, TSettings(traversal="xla"), device="cpu")
    r = _renderer(scene, TSettings(width=8, height=8))
    with pytest.raises(ValueError, match="traversal"):
        r.update_settings(traversal="pallas_tpu")


def test_wrapper_routes(scene):
    """One prepared leg through K2n's wrapper: "twin" and "auto" run the
    twin on CPU tensors with equal results and no launch counted;
    "kernel" raises; an unknown route raises."""
    tables = scene.tables("cpu", cluster_size=16)
    g = np.random.default_rng(4)
    o = torch.from_numpy(g.uniform(-2, 2, (256, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(256, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    args = cc.prepare_tiles(o, d, torch.full((256,), F32_MAX), tables,
                            near="kernel")
    wrapper, _ = cc.trace_closest_args(args)
    before = wrapper.launches
    t_a, c_a = wrapper(**args)
    t_t, c_t = wrapper(**args, route="twin")
    assert torch.equal(bits(t_a), bits(t_t)) and torch.equal(c_a, c_t)
    assert (c_a >= 0).sum() > 20 and wrapper.launches == before
    with pytest.raises(ValueError, match="route 'kernel'"):
        wrapper(**args, route="kernel")
    with pytest.raises(ValueError, match="route must be"):
        wrapper(**args, route="interpret")


def test_kernel_rays_must_be_on_the_current_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cc.check_current_device(torch.device("cuda", 1))
    cc.check_current_device(torch.device("cuda"))
    with pytest.raises(ValueError, match="current CUDA device is cuda:1"):
        cc.check_current_device(torch.device("cuda", 0))


# --- chained_sort (tests/test_chained_sort.py:63-90 on the port) ---

def _path_trace(scene, backend, chained, **kw):
    tables = scene.tables("cpu", cluster_size=16)
    w = h = 32
    r = w * h
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    idx = (xs + ys * w).reshape(r)
    pos = torch.stack([xs, ys], -1).reshape(r, 2).to(torch.float32)
    st = TSettings(width=w, height=h, environment="procedural",
                   traversal=backend, sample_count=1, bounces_depth=4,
                   sort_bounce_rays=True, chained_sort=chained, **kw)
    o, d, state = camera_rays(pos, torch.eye(4), rng.seed_state(11, idx), st)
    return path_trace(o, d, torch.full((r,), F32_MAX), state, tables,
                      torch.zeros((1, 1, 3)), st)


def _path_trace_pair(scene, backend, **kw):
    return [_path_trace(scene, backend, chained, **kw)
            for chained in (False, True)]


def _assert_same(a, b):
    assert torch.equal(bits(a.color), bits(b.color))
    assert torch.equal(a.state, b.state)
    assert torch.equal(a.first_hit.face, b.first_hit.face)
    assert float(a.rays) == float(b.rays)


def test_chained_is_pure_reordering_clustered(scene, monkeypatch):
    """Exact at the integrator level; and the chain really replaced the
    per-trace sort: no sorted trace, one permutation per later segment."""
    a, b = _path_trace_pair(scene, "clustered")
    _assert_same(a, b)
    calls = {"sorted_trace": 0, "sort_keys": 0}
    for module, name in ((integrator, "sorted_trace"),
                         (ray_sort, "sort_keys")):
        def counted(*args, _real=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    _path_trace(scene, "clustered", chained=True)
    assert calls == {"sorted_trace": 0, "sort_keys": 2}
    _path_trace(scene, "clustered", chained=False)
    assert calls["sorted_trace"] == 2  # the bounce legs of segments 1, 2


def test_chained_is_pure_reordering_with_nee(scene):
    """NEE shadow rays ride the segment's permutation with no sort of
    their own: still exact."""
    a, b = _path_trace_pair(scene, "clustered", next_event_estimation=True)
    _assert_same(a, b)


def test_chained_is_pure_reordering_pallas(scene):
    """The kernels' twins (K2n; the port's interpret mode), NEE on."""
    a, b = _path_trace_pair(scene, "pallas_interpret",
                            next_event_estimation=True)
    _assert_same(a, b)


def test_chained_frame_deviation_is_ulp_bounded(scene):
    """Whole frames, two steps: faces and sample counts exactly equal, the
    relative deviation within JAX's stated bound (1e-6), and in eager
    torch the frames are in fact equal bit for bit."""
    a = _frame(scene, sort_bounce_rays=True)
    b = _frame(scene, sort_bounce_rays=True, chained_sort=True)
    np.testing.assert_array_equal(a.geo_face.numpy(), b.geo_face.numpy())
    ia, ib = a.image.numpy(), b.image.numpy()
    np.testing.assert_array_equal(ia[..., 3], ib[..., 3])
    rel = np.abs(ia[..., :3] - ib[..., :3]) / np.maximum(
        np.abs(ia[..., :3]), 1e-3)
    assert rel.max() < 1e-6, rel.max()
    np.testing.assert_array_equal(ia.view(np.int32), ib.view(np.int32))


def test_cli_opts_reach_settings(tmp_path):
    """``--opt traversal=...`` and ``--opt chained_sort=1`` set the fields
    (no new flag); a CLI frame with them equals the default one."""
    st = cli._apply_opts(TSettings(), ["traversal=clustered",
                                       "chained_sort=1",
                                       "sort_bounce_rays=1"])
    assert (st.traversal, st.chained_sort, st.sort_bounce_rays) == (
        "clustered", True, True)
    tiny = ["--scene", "analytic", "--size", "16x16", "--spp", "2",
            "--bounces", "2", "--projection", "perspective", "--seed", "3",
            "--device", "cpu"]
    outs = []
    for opts in ([], ["--opt", "traversal=clustered", "--opt",
                      "chained_sort=1", "--opt", "sort_bounce_rays=1"]):
        out = str(tmp_path / f"o{len(outs)}.png")
        cli.main(["render", *tiny, *opts, "-o", out])
        outs.append(read_image(out))
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="traversal"):
        cli.main(["render", *tiny, "--opt", "traversal=xla", "-o",
                  str(tmp_path / "x.png")])
