"""PyTorch port on an NVIDIA GPU: the CUDA kernel against its plain-torch
twin, and a whole frame against the JAX package's golden. Needs a CUDA
device (``cuda`` marker; skips without one).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX.)"""

import os

import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu_torch.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.models.test_models import (
    ground_plane,
    unit_cube_model,
    uv_sphere,
)
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.renderer import Renderer

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mini_scene_2f.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_kernel_matches_twin_on_card(cuda):
    """Random rays with inactive lanes, finite t_max, NaN origins and
    exclusion codes: kernel and twin give the same codes and t bits."""
    scene = scene_from_facesets(
        [
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", ground_plane(-1.5, 8.0)),
            ("cube", unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )
    tables = scene.tables(cuda)
    n = 5000
    rng = np.random.default_rng(18)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = rng.integers(-1, tables.clusters.face_id.numel(), n)

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    args = cc.prepare_tiles(
        t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32)
    )
    before = cc.trace_closest_tiles.launches
    t_k, c_k = cc.trace_closest_tiles(**args)
    torch.cuda.synchronize()
    assert cc.trace_closest_tiles.launches == before + 1
    t_w, c_w = cc._trace_closest_torch(**args)
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_w.cpu().numpy())
    np.testing.assert_array_equal(
        t_k.cpu().numpy().view(np.int32), t_w.cpu().numpy().view(np.int32)
    )
    assert (c_k >= 0).sum() > 100

    # the any-hit entry on the same shadow-like set
    before = cc.trace_any_tiles.launches
    a_k = cc.trace_any_tiles(**args)
    torch.cuda.synchronize()
    assert cc.trace_any_tiles.launches == before + 1
    a_w = cc._trace_any_torch(**args)
    np.testing.assert_array_equal(a_k.cpu().numpy(), a_w.cpu().numpy())
    assert 100 < int((a_k >= 0).sum()) < n - 100


def _mixed_rays(n, seed, rng_face_count):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = rng.integers(-1, rng_face_count, n)
    return o, d, tmax, active, excl


@pytest.mark.parametrize("which", ["g4", "g64"])
def test_two_level_kernels_match_twins_on_card(cuda, which):
    """K3, both entries, against its twins on random rays with inactive
    lanes, finite t_max, NaN origins and exclusion codes: the same codes
    and t bits; and the same faces and flags as K1 over all cluster
    boxes of the same tables. ``g4``: the small scene with S = 16, G = 4;
    ``g64``: a 4,588-face stress scene with S = 2, where the automatic
    rule picks G = 64."""
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    if which == "g4":
        tables = scene_from_facesets(
            [
                ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
                ("plane", ground_plane(-1.5, 8.0)),
                ("cube", unit_cube_model()),
            ],
            np.ones((1, 3), np.float32) * 0.8,
            np.zeros((1, 3), np.float32),
        ).tables(cuda, cluster_size=16, group_size=4)
    else:
        tables = stress_scene(5000).tables(cuda, cluster_size=2)
    ct = tables.clusters
    assert cc.is_two_level(ct) and ct.group == (4 if which == "g4" else 64)
    o, d, tmax, active, excl = _mixed_rays(5000, 31, ct.face_id.numel())
    if which == "g64":  # look down at the sphere grid
        o = o * 4.0 + np.array([0.0, 12.0, 0.0], np.float32)
        d[:, 1] = -np.abs(d[:, 1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    ins = (t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32))
    a2 = cc.prepare_tiles(*ins)
    a1 = cc.prepare_tiles(*ins, two_level=False)
    assert a2["group"] == ct.group
    before = (cc.trace_closest_two_level_tiles.launches,
              cc.trace_any_two_level_tiles.launches)
    t_k, c_k = cc.trace_closest_two_level_tiles(**a2)
    a_k = cc.trace_any_two_level_tiles(**a2)
    torch.cuda.synchronize()
    assert (cc.trace_closest_two_level_tiles.launches,
            cc.trace_any_two_level_tiles.launches) == (before[0] + 1,
                                                       before[1] + 1)
    t_w, c_w = cc._trace_closest_two_level_torch(**a2)
    a_w = cc._trace_any_two_level_torch(**a2)
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_w.cpu().numpy())
    np.testing.assert_array_equal(
        t_k.cpu().numpy().view(np.int32), t_w.cpu().numpy().view(np.int32)
    )
    np.testing.assert_array_equal(a_k.cpu().numpy(), a_w.cpu().numpy())
    assert (c_k >= 0).sum() > 100
    assert 100 < int((a_k >= 0).sum()) < o.shape[0] - 100
    # K1 on the same tables: the same faces and flags
    t_1, c_1 = cc.trace_closest_tiles(**a1)
    np.testing.assert_array_equal(c_1.cpu().numpy(), c_k.cpu().numpy())
    np.testing.assert_array_equal(
        (cc.trace_any_tiles(**a1) >= 0).cpu().numpy(),
        (a_k >= 0).cpu().numpy(),
    )


@pytest.mark.parametrize("which", ["single", "g4", "g64"])
def test_pairs_kernels_match_twins_on_card(cuda, which):
    """K2p (single-level) and K3p (two-level) against their twins on random
    rays with inactive lanes, finite t_max, NaN origins and exclusion
    codes: t1, the three codes and the flag agree bit for bit; after the
    exact adjudication, the faces equal K1's on the same rays."""
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    if which == "g64":
        tables = stress_scene(5000).tables(cuda, cluster_size=2)
    else:
        scene = scene_from_facesets(
            [
                ("sphere", uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
                ("plane", ground_plane(-1.5, 8.0)),
                ("cube", unit_cube_model()),
            ],
            np.ones((1, 3), np.float32) * 0.8,
            np.zeros((1, 3), np.float32),
        )
        kw = dict(cluster_size=16, group_size=4) if which == "g4" else {}
        tables = scene.tables(cuda, **kw)
    ct = tables.clusters
    assert cc.is_two_level(ct) == (which != "single")
    o, d, tmax, active, excl = _mixed_rays(5000, 37, ct.face_id.numel())
    if which == "g64":  # look down at the sphere grid
        o = o * 4.0 + np.array([0.0, 12.0, 0.0], np.float32)
        d[:, 1] = -np.abs(d[:, 1])

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    ins = (t(o), t(d), t(tmax), tables, t(active), t(excl, torch.int32))
    args = cc.prepare_tiles(*ins, pairs=True)
    wrapper, twin = cc.trace_pairs_args(args)
    assert wrapper is (cc.trace_pairs_tiles if which == "single"
                       else cc.trace_pairs_two_level_tiles)
    before = wrapper.launches
    got = wrapper(**args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = twin(**args)
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.int32),
                                  want[0].cpu().numpy().view(np.int32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert (got[1] >= 0).sum() > 100
    exact = cc.trace_closest_clustered_cuda(*ins, exact_pairs=True)
    plain = cc.trace_closest_clustered_cuda(*ins)
    np.testing.assert_array_equal(exact.face.cpu().numpy(),
                                  plain.face.cpu().numpy())


def _mini_scene():
    return scene_from_facesets(
        [
            ("light", uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4, lon=6)),
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def test_nee_launches_on_card(cuda):
    """A 2-frame NEE render (2 samples, 2 segments): 8 closest-hit and 8
    any-hit launches, and the same accumulation as on the CPU (twins)."""
    st = RenderSettings(width=32, height=32, bounces_depth=3, sample_count=1,
                        environment="procedural", next_event_estimation=True)
    k1, k_any = cc.trace_closest_tiles.launches, cc.trace_any_tiles.launches
    r = Renderer(_mini_scene(), st, base_seed=77, device=cuda)
    r.step()
    r.step()
    assert cc.trace_closest_tiles.launches == k1 + 2 * 2 * 2
    assert cc.trace_any_tiles.launches == k_any + 2 * 2 * 2
    c = Renderer(_mini_scene(), st, base_seed=77, device="cpu")
    c.step()
    c.step()
    got, want = r.buffers.image.cpu().numpy(), c.buffers.image.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert float(np.sqrt(np.mean((got[ok] - want[ok]) ** 2))) < 1e-5


def test_golden_mini_scene_on_card(cuda):
    scene = _mini_scene()
    st = RenderSettings(width=32, height=32, bounces_depth=3, sample_count=1,
                        environment="procedural")
    before = cc.trace_closest_tiles.launches
    r = Renderer(scene, st, base_seed=77, device=cuda)
    r.step()
    r.step()
    assert cc.trace_closest_tiles.launches == before + 2 * 2 * 2
    got = r.buffers.image.cpu().numpy()
    rmse = float(np.sqrt(np.mean((got - np.load(GOLDEN)["image"]) ** 2)))
    assert rmse < 1e-5, rmse


def test_two_level_frames_on_card(cuda):
    """A 2-frame NEE render on two-level tables of the mini scene (S = 16,
    G = 4) in 2 slabs: 16 two-level closest-hit and 16 two-level any-hit
    launches and no single-level one; the accumulation equals the CPU
    twins' and the single-level frame on the card."""
    st = RenderSettings(width=32, height=32, bounces_depth=3, sample_count=1,
                        environment="procedural", next_event_estimation=True,
                        frame_slabs=2)
    wrappers = (cc.trace_closest_tiles, cc.trace_any_tiles,
                cc.trace_closest_two_level_tiles,
                cc.trace_any_two_level_tiles)
    images = {}
    for dev, two_level in (("cuda", True), ("cpu", True), ("cuda", False)):
        r = Renderer(_mini_scene(), st, base_seed=77, device=dev)
        if two_level:
            r.tables = _mini_scene().tables(dev, cluster_size=16,
                                            group_size=4)
        before = [w.launches for w in wrappers]
        r.step()
        r.step()
        torch.cuda.synchronize()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        if dev == "cuda":
            assert launched == ([0, 0, 16, 16] if two_level
                                else [16, 16, 0, 0]), launched
        images[dev, two_level] = r.buffers.image.cpu().numpy()
    want = images["cpu", True]
    for key in (("cuda", True), ("cuda", False)):
        got = images[key]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert float(np.sqrt(np.mean((got[ok] - want[ok]) ** 2))) < 1e-5
