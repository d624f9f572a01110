"""PyTorch port: next-event estimation and the direct-lighting integrator
against the JAX package.

* ``sample_intriangle``, ``sample_lights`` and ``direct_light`` bit-equal
  to the JAX functions run op by op, NaN shading points included;
* whole frames of the mini scene (NEE path, and ``bounces_depth=1``, the
  direct integrator) against the jitted JAX renderer with
  ``traversal="clustered"``: equal sample counts and ray counts, equal NaN
  masks, RMSE <= 1e-2 and >= 99% of pixels equal to 1e-5 relative;
* with a constant environment, frames bit-identical to the JAX renderer
  run op by op, NaN pixels included: a variant puts the floor at y = 0,
  whose shading points are NaN by the reference's own offset rule, as on
  ``stress_scene``. The JAX reference there traces with its threaded BVH
  oracle: its XLA clustered trace picks candidates by a bilinear-form
  matmul and misses a knife-edge hit on the light's front face at pixel
  (0, 9) of this frame that the oracle, the Pallas kernel and the port
  all find."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.config import ShadingType as JShading
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops import integrator as ji
from webgpu_raytracing_tpu.ops import rng as jrng
from webgpu_raytracing_tpu.renderer import Renderer as JRenderer
from webgpu_raytracing_tpu_torch.config import F32_MAX
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.config import ShadingType as TShading
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator as ti
from webgpu_raytracing_tpu_torch.ops import rng as trng
from webgpu_raytracing_tpu_torch.renderer import Renderer as TRenderer

torch.set_num_threads(1)


def _mini(scene_mod, tm, floor_y=-1.5):
    return scene_mod.scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4, lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(floor_y, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


@pytest.fixture(scope="module")
def tables():
    return _mini(jscene, jtm).tables(), _mini(tscene, ttm).tables("cpu")


def test_sample_intriangle_bit_equal():
    t = np.random.default_rng(3).uniform(size=(50000, 2)).astype(np.float32)
    t[:10] = [[0.5, 0.5], [1, 0], [0, 1], [1, 1], [0, 0], [0.25, 0.75],
              [0.75, 0.25000003], [1, 0.5], [0.5, 1], [0.9, 0.1]]
    got = trng.sample_intriangle(torch.from_numpy(t)).numpy()
    want = np.asarray(jrng.sample_intriangle(jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) <= 1.0).all()


def _shading_points(tt, n, seed):
    """Primary hits of a fan of camera-like rays: points, normals and the
    hit mask. Missed lanes keep face 0's corner, a light vertex with an
    exact 0 coordinate, so their offset point is NaN (the reference's
    inverted offset select), which exercises the NaN path."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.5, 2.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = cc.trace_closest_clustered_cuda(
        torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), F32_MAX),
        tt,
    )
    f = hit.face.clamp(min=0).long()
    point = ti.face_point_offset(tt.tri[f], tt.shade_normal[f], hit.u, hit.v)
    normal = ti.face_normal(tt.shade_normal[f], hit.u, hit.v, TShading.PHONG)
    state = torch.from_numpy(
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    )
    return point, normal, hit.face >= 0, state


@pytest.mark.parametrize("shading", ["PHONG", "FLAT"])
def test_sample_lights_bit_equal(tables, shading):
    jt, tt = tables
    state = np.random.default_rng(4).integers(0, 2**32, 4096, dtype=np.uint64)
    got, s_got = ti.sample_lights(
        torch.from_numpy(state.astype(np.int64)), tt,
        TSettings(shading_type=TShading[shading]),
    )
    with jax.disable_jit():
        want, s_want = ji.sample_lights(
            jnp.asarray(state.astype(np.uint32)), jt,
            JSettings(shading_type=JShading[shading]),
        )
    for name in ("p", "point", "normal", "material_idx"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))


@pytest.mark.parametrize("spp", [1, 2])
def test_direct_light_bit_equal(tables, spp):
    """pointColor with ``samples_per_point`` light samples and their
    shadow rays: colors (NaN positions included) and RNG states equal the
    JAX function's, run op by op with its clustered trace."""
    jt, tt = tables
    point, normal, found, state = _shading_points(tt, 1024, seed=1)
    got, s_got = ti.direct_light(
        point, normal, state, tt, TSettings(samples_per_point=spp),
        active=found,
    )
    with jax.disable_jit():
        want, s_want = ji.direct_light(
            jnp.asarray(point.numpy()), jnp.asarray(normal.numpy()),
            jnp.asarray(state.numpy().astype(np.uint32)), jt,
            JSettings(traversal="clustered", samples_per_point=spp),
            active=jnp.asarray(found.numpy()),
        )
    got, want = got.numpy(), np.asarray(want)
    assert np.isnan(got).any() and (got[found.numpy()] > 0).any()
    np.testing.assert_array_equal(got, want)  # NaNs compare equal here
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))


FRAMES = {
    "nee": dict(next_event_estimation=True, bounces_depth=3),
    "direct": dict(bounces_depth=1),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_match_jax_clustered(name):
    kw = dict(width=32, height=24, sample_count=1, environment="procedural",
              **FRAMES[name])
    jr = JRenderer(_mini(jscene, jtm),
                   JSettings(traversal="clustered", **kw), base_seed=2024)
    tr = TRenderer(_mini(tscene, ttm), TSettings(**kw),
                   base_seed=2024, device="cpu")
    for _ in range(2):
        jr.step()
        tr.step()
        assert tr.last_rays == jr.last_rays
    want = np.asarray(jr.buffers.image)
    got = tr.buffers.image.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert not nan.any()
    ok = ~nan.any(-1)
    rmse = float(np.sqrt(np.mean((got[ok] - want[ok]) ** 2)))
    close = float(np.mean(np.all(
        np.abs(got[ok] - want[ok]) <= 1e-5 * np.maximum(np.abs(want[ok]), 0.1),
        axis=-1,
    )))
    print(f"{name}: NaN pixels {nan[..., 0].mean():.4f}, RMSE {rmse:.3g}, "
          f"pixels equal to 1e-5 {close:.4f}")
    assert rmse <= 1e-2, rmse
    assert close >= 0.99, close


@pytest.mark.parametrize(
    "floor_y, kw",
    [(-1.5, dict(next_event_estimation=True, bounces_depth=3)),
     (-1.5, dict(bounces_depth=1, samples_per_point=2)),
     (0.0, dict(next_event_estimation=True, bounces_depth=3))],
    ids=["nee", "direct_spp2", "nee_nan_floor"],
)
def test_frames_bit_identical_to_eager_jax(floor_y, kw):
    """``nee_nan_floor`` puts the floor at y = 0, as on ``stress_scene``:
    its shading points are NaN by the reference's own offset rule, so NEE
    pixels there are NaN in both packages, at the same positions. (Against
    the jitted JAX frame one silhouette pixel of this scene differs: jit
    rounds that camera ray apart, and it hits the floor in one frame and
    not the other.)"""
    kw = dict(width=16, height=16, sample_count=1, environment="white", **kw)
    jr = JRenderer(_mini(jscene, jtm, floor_y),
                   JSettings(traversal="threaded", **kw), base_seed=5)
    with jax.disable_jit():
        jr.step()
    tr = TRenderer(_mini(tscene, ttm, floor_y), TSettings(**kw), base_seed=5,
                   device="cpu")
    tr.step()
    want = np.asarray(jr.buffers.image)
    np.testing.assert_array_equal(tr.buffers.image.numpy(), want)
    assert tr.last_rays == jr.last_rays
    if floor_y == 0.0:
        assert np.isnan(want[..., 0]).any()
