"""PyTorch port: environment importance sampling against the JAX package.

* ``build_env_distribution``: every table bit-equal;
* ``sample_env``: texel rows and columns bit-equal (compares on identical
  f32 CDFs), directions within 1e-6 (``sin``/``cos`` of two libraries),
  radiance bit-equal; ``env_pdf``, ``bsdf_pdf`` and ``balance_weight``
  within 1e-6 relative;
* the JAX package's own checks of the distribution, in the port;
* whole mini-scene frames with env-IS (``env_nee_depth`` 0 and 1) against
  the jitted JAX renderer with ``traversal="clustered"``, and bit for bit
  against it run op by op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops import env_sample as jes
from webgpu_raytracing_tpu.ops import rng as jrng
from webgpu_raytracing_tpu.renderer import Renderer as JRenderer
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.models.scene import env_distribution_from_numpy
from webgpu_raytracing_tpu_torch.ops import env_sample as tes
from webgpu_raytracing_tpu_torch.renderer import Renderer as TRenderer

torch.set_num_threads(1)

FIELDS = ("img", "row_cdf", "cond_cdf", "lum", "total")


def _env_img(h=16, w=32, seed=0):
    """A dim random equirect with one bright sun texel."""
    img = (np.random.default_rng(seed).random((h, w, 3)) * 0.5).astype(
        np.float32
    )
    img[h // 4, w // 3] = 200.0
    return img


def _states(n, seed):
    s = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    return torch.from_numpy(s.astype(np.int64)), jnp.asarray(s.astype(np.uint32))


@pytest.mark.parametrize("shape", [(16, 32), (7, 5), (64, 128)])
def test_build_env_distribution_bit_equal(shape):
    img = _env_img(*shape, seed=shape[0])
    want = jes.build_env_distribution(img)
    got = tes.build_env_distribution(img)
    for k in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k
        )
    # the port's carrier from the JAX arrays is the same distribution
    moved = env_distribution_from_numpy(
        {k: np.asarray(getattr(want, k)) for k in FIELDS}, "cpu"
    )
    for k in FIELDS:
        assert torch.equal(getattr(moved, k), getattr(got, k)), k


@pytest.mark.parametrize("shape", [(16, 32), (64, 128)])
def test_sample_env_matches_jax(shape):
    h, w = shape
    img = _env_img(h, w, seed=3)
    jd, td = jes.build_env_distribution(img), tes.build_env_distribution(img)
    ts, js = _states(20000, seed=w)
    row, col, _ = tes.sample_texel(td, ts)
    t2, _ = jrng.random_2(js)
    j_row = np.asarray(jes._invert_cdf(jd.row_cdf, t2[..., 0], h))
    j_col = np.asarray(jax.vmap(
        lambda r, u: jes._invert_cdf(jd.cond_cdf[r], u, w)
    )(jnp.asarray(j_row), t2[..., 1]))
    np.testing.assert_array_equal(row.numpy(), j_row)
    np.testing.assert_array_equal(col.numpy(), j_col)

    d, rad, pdf, s = tes.sample_env(td, ts)
    jd_, jrad, jpdf, js2 = jes.sample_env(jd, js)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(rad.numpy(), np.asarray(jrad))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd_), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    # the sun is drawn, and rows/cols cover the map
    assert (rad.numpy()[:, 0] > 50).mean() > 0.05
    assert len(np.unique(row.numpy())) > h // 2


def test_pdfs_and_weight_match_jax():
    img = _env_img(32, 64, seed=5)
    jd, td = jes.build_env_distribution(img), tes.build_env_distribution(img)
    rng = np.random.default_rng(6)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = rng.normal(size=(20000, 3)).astype(np.float32) * 1.3
    got_env = tes.env_pdf(td, torch.from_numpy(d)).numpy()
    want_env = np.asarray(jes.env_pdf(jd, jnp.asarray(d)))
    # a direction on a texel border may round to the neighbour texel in
    # atan2/acos of the two libraries; every other pdf agrees to 1e-6
    close = np.isclose(got_env, want_env, rtol=1e-6, atol=0)
    assert close.mean() > 0.999, close.mean()
    got_b = tes.bsdf_pdf(torch.from_numpy(d), torch.from_numpy(n)).numpy()
    want_b = np.asarray(jes.bsdf_pdf(jnp.asarray(d), jnp.asarray(n)))
    np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-12)
    assert (got_b == 0).mean() > 0.3 and (got_b > 0).mean() > 0.3
    got_w = tes.balance_weight(
        torch.from_numpy(want_env), torch.from_numpy(want_b)
    ).numpy()
    want_w = np.asarray(jes.balance_weight(want_env, want_b))
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6, atol=0)


def test_env_distribution_pdf_normalizes():
    """∫ pdf dω over the sphere ≈ 1 (texel sum of pdf·Δω)."""
    rng = np.random.default_rng(3)
    img = rng.random((32, 64, 3)).astype(np.float32) * 3.0
    dist = tes.build_env_distribution(img)
    h, w = 32, 64
    theta = np.pi * (1.0 - (np.arange(h) + 0.5) / h)
    d_omega = np.sin(theta)[:, None] * (2.0 * np.pi**2 / (h * w))
    lum = dist.lum.numpy()
    pdf = lum / float(dist.total) * (h * w) / (2.0 * np.pi**2)
    assert abs((pdf * d_omega).sum() - 1.0) < 1e-3


def test_sample_env_histogram_matches_luminance():
    """Bright texels are drawn proportionally more often, and the pdf of
    a drawn direction is the pdf it was drawn with."""
    img = np.ones((8, 16, 3), np.float32) * 0.1
    img[2, 5] = 100.0  # a sun
    dist = tes.build_env_distribution(img)
    state = torch.from_numpy(
        (np.arange(20000, dtype=np.uint64) * 2654435761 % 2**32).astype(
            np.int64
        )
    )
    d, rad, pdf, _ = tes.sample_env(dist, state)
    frac_sun = (rad.numpy()[:, 0] > 50).mean()
    assert frac_sun > 0.8, frac_sun
    np.testing.assert_allclose(
        tes.env_pdf(dist, d).numpy(), pdf.numpy(), rtol=1e-4, atol=1e-6
    )


def _mini(scene_mod, tm):
    return scene_mod.scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4, lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


@pytest.mark.parametrize("nee_depth", [0, 1])
def test_envis_frames_match_jax_clustered(nee_depth):
    """Two 32x24 frames of the mini scene under a sun-lit random equirect,
    env-IS with MIS, against the jitted JAX renderer: equal sample counts,
    ray counts and NaN masks, RMSE <= 1e-2, and >= 99% of pixels within
    1e-5 relative (the rest: env directions rounded apart by ``sin``/``cos``
    and texel-border ``atan2`` of the two libraries)."""
    img = _env_img(16, 32, seed=9)
    jd = jes.build_env_distribution(img)
    td = env_distribution_from_numpy(
        {k: np.asarray(getattr(jd, k)) for k in FIELDS}, "cpu"
    )
    kw = dict(width=32, height=24, sample_count=1, bounces_depth=4,
              environment="equirect", env_importance_sampling=True,
              env_nee_depth=nee_depth)
    jr = JRenderer(_mini(jscene, jtm), JSettings(traversal="clustered", **kw),
                   env_data=jd, base_seed=2024)
    tr = TRenderer(_mini(tscene, ttm), TSettings(**kw), env_data=td,
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
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    close = float(np.mean(np.all(
        np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), 0.1), axis=-1
    )))
    print(f"env-IS depth {nee_depth}: RMSE {rmse:.3g}, pixels equal to "
          f"1e-5 {close:.4f}")
    assert rmse <= 1e-2, rmse
    assert close >= 0.99, close


@pytest.mark.parametrize("nee_depth", [0, 1])
def test_envis_frames_bit_identical_to_eager_jax(nee_depth):
    """A 16x16 frame of the mini scene under the random equirect, env-IS
    with MIS, against the JAX renderer run op by op: every value bit for
    bit, equal ray counts."""
    img = _env_img(16, 32, seed=9)
    jd = jes.build_env_distribution(img)
    td = env_distribution_from_numpy(
        {k: np.asarray(getattr(jd, k)) for k in FIELDS}, "cpu"
    )
    kw = dict(width=16, height=16, sample_count=1, bounces_depth=3,
              environment="equirect", env_importance_sampling=True,
              env_nee_depth=nee_depth)
    jr = JRenderer(_mini(jscene, jtm), JSettings(traversal="clustered", **kw),
                   env_data=jd, base_seed=9)
    with jax.disable_jit():
        jr.step()
    tr = TRenderer(_mini(tscene, ttm), TSettings(**kw), env_data=td,
                   base_seed=9, device="cpu")
    tr.step()
    np.testing.assert_array_equal(tr.buffers.image.numpy(),
                                  np.asarray(jr.buffers.image))
    assert tr.last_rays == jr.last_rays


def test_envis_needs_a_distribution():
    st = TSettings(width=8, height=8, environment="equirect",
                   env_importance_sampling=True)
    with pytest.raises(ValueError, match="EnvDistribution"):
        TRenderer(_mini(tscene, ttm), st, env_data=_env_img(), base_seed=0,
                  device="cpu")
    r = TRenderer(_mini(tscene, ttm), st.replace(env_importance_sampling=False),
                  env_data=_env_img(), base_seed=0, device="cpu")
    with pytest.raises(ValueError, match="EnvDistribution"):
        r.update_settings(env_importance_sampling=True)
