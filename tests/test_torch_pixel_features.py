"""PyTorch port: the per-pixel features (temporal reprojection, the quad
hit predictor, the BVH wireframe, resolution and G-buffer scales) against
the JAX package.

* ops, bit for bit against the JAX functions evaluated op by op (under
  ``jax.disable_jit``, as tests/test_torch_rng_raygen.py does), RNG state
  words included. Two stated exceptions: the bilateral filter's weights
  go through ``exp``, which XLA and PyTorch round differently (at most one
  ulp; both flush results below the least normal f32), so filtered colours
  agree to 1e-5 relative; the wireframe is held against the JAX function
  called as ``Renderer.image`` calls it (its ``jnp.linspace`` is compiled,
  which turns the division into a product with the reciprocal);
  ``jax.image.resize`` (the blit's resize) is compiled too and sums in
  another order: 2e-7 absolute.
* whole frames at 16x12 against the jitted JAX renderer
  (``traversal="clustered"``): equal sample and ray counts, >= 99 % of
  the G-buffer faces equal; display images within RMSE 1e-5, and >= 99 % of the
  accumulation buffer's values equal to 1e-5 relative (under jit XLA
  contracts mul-adds into FMAs, which moves the last bit of some rays);
  the port's own repeated runs RMSE 0.
* the cases of tests/test_reproject.py on the port."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops import predictor as jpred
from webgpu_raytracing_tpu.ops import reproject as jrep
from webgpu_raytracing_tpu.ops import sampling as jsamp
from webgpu_raytracing_tpu.ops import wireframe as jwire
from webgpu_raytracing_tpu.renderer import Renderer as JRenderer
from webgpu_raytracing_tpu.renderer import blit as jblit
from webgpu_raytracing_tpu_torch.camera import Camera
from webgpu_raytracing_tpu_torch.config import ProjectionType
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.config import check_supported
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import predictor as tpred
from webgpu_raytracing_tpu_torch.ops import reproject as trep
from webgpu_raytracing_tpu_torch.ops import sampling as tsamp
from webgpu_raytracing_tpu_torch.ops import wireframe as twire
from webgpu_raytracing_tpu_torch.renderer import FrameBuffers, FrameInputs
from webgpu_raytracing_tpu_torch.renderer import Renderer as TRenderer
from webgpu_raytracing_tpu_torch.renderer import blit as tblit
from webgpu_raytracing_tpu_torch.renderer import (
    render_frame,
    render_frame_slabs,
)

torch.set_num_threads(1)


def bits(x):
    """f32 array → its int32 bit patterns (so -0.0 != 0.0), every NaN one
    pattern (a NaN's payload differs across libraries)."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), x).view(np.int32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mini(scene_mod, tm):
    return scene_mod.scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


@pytest.fixture(scope="module")
def prev_frame():
    """A 16x16 frame of the mini scene from the port (its prev buffers,
    view and hit points): the inputs of the reprojection ops."""
    st = TSettings(width=16, height=16, bounces_depth=2, sample_count=0,
                   projection_type=ProjectionType.PERSPECTIVE, fov=0.8)
    r = TRenderer(_mini(tscene, ttm), st, base_seed=4, device="cpu")
    r.step()
    b = r.buffers
    rng = np.random.default_rng(8)
    p = b.geo_position.numpy().reshape(-1, 3)
    # exact points (converge at once), nudged points (search), far points
    # (outside the previous view)
    p = np.concatenate([
        p, p + rng.normal(0, 2e-3, p.shape).astype(np.float32),
        rng.normal(0, 30, (64, 3)).astype(np.float32),
    ]).astype(np.float32)
    return dict(
        settings=st, view=r.camera.view_matrix(), p=p,
        c=rng.uniform(0, 2, p.shape).astype(np.float32),
        state=rng.integers(0, 2**32, p.shape[0], dtype=np.uint64).astype(
            np.uint32),
        prev_image=b.prev_image.numpy(),
        prev_geo_position=b.prev_geo_position.numpy(),
        prev_geo_face=b.prev_geo_face.numpy(),
    )


def test_sample_bilinear_bit_equal():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(9, 13, 4)).astype(np.float32)
    uv = rng.uniform(-3, 16, (5000, 2)).astype(np.float32)
    uv[:4] = [[np.nan, 1.0], [1e20, 2.0], [-1e20, 3.0], [2.0**31, 4.0]]
    with jax.disable_jit():
        want = jsamp.sample_bilinear(jnp.asarray(img), jnp.asarray(uv))
    got = tsamp.sample_bilinear(t(img), t(uv))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_to_int32_saturates_like_xla():
    x = np.array([np.nan, 1e20, -1e20, 2.5, -2.5, 2.0**31, -(2.0**31),
                  2147483520.0, np.inf, -np.inf], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(tsamp.to_int32(t(x)).numpy(), want)


def test_reprojection_frustum_and_point_bit_equal(prev_frame):
    view = prev_frame["view"]
    for w, h, fov in ((16, 16, 0.8), (32, 18, 2.0943951)):
        np.testing.assert_array_equal(
            trep.reprojection_frustum(view, w, h, fov),
            jrep.reprojection_frustum(view, w, h, fov),
        )
    fr = trep.reprojection_frustum(view, 16, 16, 0.8)
    origin = np.asarray(view[:3, 3], np.float32)
    p = prev_frame["p"]
    with jax.disable_jit():
        want = jrep.reproject_point(jnp.asarray(p), jnp.asarray(fr),
                                    jnp.asarray(origin))
    got = trep.reproject_point(t(p), t(fr), t(origin))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def _reproject_args(prev_frame, jnp_mode):
    fr = trep.reprojection_frustum(prev_frame["view"], 16, 16, 0.8)
    origin = np.asarray(prev_frame["view"][:3, 3], np.float32)
    arrays = [prev_frame["p"], prev_frame["c"], prev_frame["state"], fr,
              origin, prev_frame["prev_image"],
              prev_frame["prev_geo_position"]]
    if jnp_mode:
        return [jnp.asarray(a) for a in arrays]
    arrays[2] = arrays[2].astype(np.int64)
    return [t(a) for a in arrays]


def _eager_fori_loop(lower, upper, body, carry):
    """``lax.fori_loop`` op by op: the loop index as the int32 array the
    JAX body expects (under ``disable_jit`` the stock loop passes a Python
    int, which the search body's ``.astype`` refuses)."""
    for i in range(lower, upper):
        carry = body(jnp.int32(i), carry)
    return carry


@pytest.mark.parametrize("mode", ["plain", "debug_reprojection",
                                  "bilateral_filter"])
def test_reproject_bit_equal_with_rng_state(prev_frame, mode, monkeypatch):
    """The stochastic search draws from each lane's stream only while the
    lane searches: the state words equal JAX's word for word. Colours and
    debug tints bit for bit; with the bilateral filter to 1e-5 relative
    (its weights' exp), with the same rejected lanes."""
    kw = {} if mode == "plain" else {mode: True}
    st_j = JSettings(width=16, height=16, reprojection_rate=1, **kw)
    st_t = TSettings(width=16, height=16, reprojection_rate=1, **kw)
    monkeypatch.setattr(jax.lax, "fori_loop", _eager_fori_loop)
    with jax.disable_jit():
        jres, jstate = jrep.reproject(*_reproject_args(prev_frame, True),
                                      st_j)
    tres, tstate = trep.reproject(*_reproject_args(prev_frame, False), st_t)
    np.testing.assert_array_equal(tstate.numpy(),
                                  np.asarray(jstate).astype(np.int64))
    want = np.asarray(jres.color)
    got = tres.color.numpy()
    # the search both converged and left lanes unconverged / outside
    if mode != "debug_reprojection":
        count = want[:, 3]
        assert (count > 0).mean() > 0.05 and (count == 0).mean() > 0.05
    if mode == "bilateral_filter":
        np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(bits(got), bits(want))


def test_bilateral_filter_weights_within_an_ulp(prev_frame):
    """Everything but the exp of each tap's weight is the JAX package's
    operation order; the filtered colours agree to 1e-5 relative."""
    uv = np.random.default_rng(3).uniform(0, 16, (400, 2)).astype(np.float32)
    p = prev_frame["p"][:400]
    c = prev_frame["c"][:400]
    with jax.disable_jit():
        want = jrep.bilateral_filter(
            jnp.asarray(uv), jnp.asarray(p), jnp.asarray(c),
            jnp.asarray(prev_frame["prev_image"]),
            jnp.asarray(prev_frame["prev_geo_position"]),
        )
    got = trep.bilateral_filter(
        t(uv), t(p), t(c), t(prev_frame["prev_image"]),
        t(prev_frame["prev_geo_position"]),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(6, 8), (7, 9), (1, 1)])
def test_quad_faces_bit_equal(shape):
    f = np.random.default_rng(2).integers(-1, 50, shape).astype(np.int32)
    np.testing.assert_array_equal(
        tpred.quad_faces(t(f)).numpy(), np.asarray(jpred.quad_faces(f))
    )


def test_predict_hit_dist_bit_equal(prev_frame):
    """Re-tests of the quad's previous faces bound each ray: the same t
    bits, F32_MAX where nothing re-hits."""
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    scene = _mini(tscene, ttm)
    tables = scene.tables("cpu")
    st = prev_frame["settings"]
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    pos = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) + 0.25
    state = torch.arange(256, dtype=torch.int64)
    o, d, _ = camera_rays(t(pos), torch.as_tensor(prev_frame["view"]),
                          state, st)
    quads = tpred.quad_faces(t(prev_frame["prev_geo_face"])).reshape(-1, 4)
    got = tpred.predict_hit_dist(o, d, quads, tables)
    jt = types.SimpleNamespace(tri=jnp.asarray(tables.tri.numpy()))
    with jax.disable_jit():
        want = jpred.predict_hit_dist(jnp.asarray(o.numpy()),
                                      jnp.asarray(d.numpy()),
                                      jnp.asarray(quads.numpy()), jt)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert (got.numpy() < 3e38).mean() > 0.3


def test_wireframe_bit_equal():
    """Every node box of the mini scene rasterised: the same intensity
    bits per pixel (a scatter-add of one constant, order-free), and the
    overlay."""
    scene = _mini(tscene, ttm)
    tables = scene.tables("cpu")
    cam = Camera()
    cam.move(np.array([0.3, 0.5, 1.0], np.float32))
    vp = np.asarray(cam.view_projection_matrix(40, 24, 1.2), np.float32)
    lo = tables.node_box[:, 0:3]
    hi = tables.node_box[:, 3:6]
    got = twire.rasterize_bvh_wireframe(lo, hi, t(vp), 40, 24)
    want = jwire.rasterize_bvh_wireframe(
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()), jnp.asarray(vp),
        40, 24,
    )
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert (got.numpy() > 0).mean() > 0.1
    disp = np.random.default_rng(4).uniform(0, 1, (24, 40, 3)).astype(
        np.float32)
    with jax.disable_jit():
        want_o = jwire.overlay_wireframe(jnp.asarray(disp), want)
    got_o = twire.overlay_wireframe(t(disp), got)
    np.testing.assert_array_equal(bits(got_o.numpy()), bits(want_o))


@pytest.mark.parametrize("scale", [0.5, 2.0, 0.75, 1.5])
def test_blit_resize_matches_jax(scale):
    """The blit's resize to the canvas (``jax.image.resize(..., "linear")``
    against ``F.interpolate``'s bilinear mode, both antialiased when
    shrinking): the same triangle weights, summed in another order, 2e-7
    absolute."""
    w, h = 20, 12
    st = dict(width=w, height=h, resolution_scale=scale)
    rw, rh = TSettings(**st).render_width, TSettings(**st).render_height
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 3, (rh, rw, 4)).astype(np.float32)
    img[..., 3] = 2.0
    want = np.asarray(jblit(img, img, JSettings(**st)))
    got = tblit(t(img), t(img), TSettings(**st)).numpy()
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


FRAMES = {
    "reprojection_rate=2, camera moved": dict(reprojection_rate=2),
    "use_hit_predictor": dict(use_hit_predictor=True),
    "debug_bvh": dict(debug_bvh=True),
    "debug_reprojection": dict(reprojection_rate=1, debug_reprojection=True),
    "resolution_scale=0.5": dict(resolution_scale=0.5),
    "resolution_scale=2": dict(resolution_scale=2.0),
    "geometry_buffer_scale=0.5": dict(geometry_buffer_scale=0.5),
}


def _frames(make, kw, steps=3):
    r = make(kw)
    for k in range(steps):
        r.step()
        if k == 0:  # the camera moves between frames, without a reset
            r.camera.move(np.array([0.05, 0.0, 0.02], np.float32))
    return r


@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_match_jax(name):
    kw = dict(width=16, height=12, bounces_depth=3, sample_count=1,
              environment="procedural", **FRAMES[name])
    jr = _frames(lambda k: JRenderer(_mini(jscene, jtm),
                                     JSettings(traversal="clustered", **k),
                                     base_seed=5), kw)

    def port():
        return _frames(lambda k: TRenderer(_mini(tscene, ttm), TSettings(**k),
                                           base_seed=5, device="cpu"), kw)

    tr, tr2 = port(), port()
    want = np.asarray(jr.buffers.image)
    got = tr.buffers.image.numpy()
    np.testing.assert_array_equal(bits(tr2.buffers.image.numpy()), bits(got))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    # the same faces, but where an ulp of a jitted ray direction moves a
    # silhouette pixel onto its neighbour (at most 1 %)
    for f in ("geo_face", "geo_object", "prev_geo_face"):
        same = np.mean(getattr(tr.buffers, f).numpy()
                       == np.asarray(getattr(jr.buffers, f)))
        assert same >= 0.99, (f, same)
    assert tr.last_rays == jr.last_rays
    close = float(np.mean(
        (np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), 0.1))[ok]
    ))
    assert close >= 0.99, close
    gi, wi = tr.image(), jr.image()
    assert gi.shape == wi.shape == (12, 16, 3)
    np.testing.assert_array_equal(bits(tr2.image()), bits(gi))
    finite = np.isfinite(wi)
    np.testing.assert_array_equal(np.isfinite(gi), finite)
    rmse = float(np.sqrt(np.mean((gi[finite] - wi[finite]) ** 2)))
    print(f"{name}: display RMSE {rmse:.3g}, accumulation values equal to "
          f"1e-5 {close:.4f}")
    assert rmse <= 1e-5, rmse


def test_slabs_keep_prev_snapshots_whole():
    """With reprojection and the predictor on, four slabs equal the whole
    frame bit for bit (the prev snapshots ride whole, quads anchor at
    global rows); slabs refuse a G-buffer of fewer rows."""
    st = TSettings(width=16, height=16, bounces_depth=2, sample_count=1,
                   reprojection_rate=1, use_hit_predictor=True)
    r = TRenderer(_mini(tscene, ttm), st, base_seed=6, device="cpu")
    r.step()
    fr = trep.reprojection_frustum(r.camera.view_matrix(), 16, 16, st.fov)
    inputs = FrameInputs(
        view=torch.as_tensor(r.camera.view_matrix()), seed=99, counter=1,
        jitter=torch.zeros(2), frustum=t(fr),
        prev_origin=t(np.asarray(r.camera.view_matrix()[:3, 3])),
    )
    whole, rays = render_frame(r.buffers, r.tables, r.env_data, inputs, st)
    slabs, rays4 = render_frame_slabs(r.buffers, r.tables, r.env_data,
                                      inputs, st.replace(frame_slabs=4))
    for f in dataclasses.fields(FrameBuffers):
        np.testing.assert_array_equal(
            bits(getattr(slabs, f.name).numpy().astype(np.float32)),
            bits(getattr(whole, f.name).numpy().astype(np.float32)),
            err_msg=f.name,
        )
    assert float(rays4) == float(rays) > 0
    half = st.replace(geometry_buffer_scale=0.5, frame_slabs=4)
    with pytest.raises(ValueError, match="geometry_buffer_scale"):
        TRenderer(_mini(tscene, ttm), half, base_seed=6, device="cpu").step()


def test_resume_with_reprojection_bit_identical(tmp_path):
    """Stopped between updatePrev frames (reprojection every 3 frames) and
    resumed in a fresh Renderer: the same buffers as a run never stopped
    (the checkpoint holds the frame counter, the host RNG and the jitter
    kept since the last updatePrev)."""
    st = TSettings(width=12, height=8, bounces_depth=2, sample_count=1,
                   reprojection_rate=3, jitter_strength=0.5)
    ref = _port(st, seed=11)
    for _ in range(5):
        ref.step()
    a = _port(st, seed=11)
    a.step()
    a.step()
    a.save_checkpoint(str(tmp_path / "ck.npz"))
    b = _port(st, seed=99)
    b.load_checkpoint(str(tmp_path / "ck.npz"))
    for _ in range(3):
        b.step()
    for f in dataclasses.fields(FrameBuffers):
        np.testing.assert_array_equal(
            getattr(b.buffers, f.name).numpy(),
            getattr(ref.buffers, f.name).numpy(), err_msg=f.name,
        )


def test_check_supported_refuses_only_traversal():
    for kw in (dict(reprojection_rate=3, bilateral_filter=True),
               dict(use_hit_predictor=True), dict(debug_bvh=True),
               dict(resolution_scale=0.5), dict(geometry_buffer_scale=0.25),
               dict(debug_reprojection=True, reprojection_rate=1)):
        check_supported(TSettings(**kw))
    for trav in ("auto", "pallas", "clustered", "threaded",
                 "pallas_interpret"):
        check_supported(TSettings(traversal=trav))
    with pytest.raises(ValueError, match="traversal"):
        check_supported(TSettings(traversal="xla"))


# --- the cases of tests/test_reproject.py, on the port ---

BASE = TSettings(
    width=16, height=16, bounces_depth=2, sample_count=0,
    environment="procedural", projection_type=ProjectionType.PERSPECTIVE,
    fov=0.8, use_hit_predictor=False,
)


def _port(st, seed=4):
    return TRenderer(_mini(tscene, ttm), st, base_seed=seed, device="cpu")


def test_reproject_static_camera_reuses_history():
    r = _port(BASE.replace(reprojection_rate=1))
    r.step()
    img1 = r.buffers.image.numpy()
    r.step()
    img2 = r.buffers.image.numpy()
    hit = r.buffers.geo_face.numpy() >= 0
    assert hit.sum() > 40
    assert (img1[..., 3][hit] == 1.0).all()
    counts = img2[..., 3][hit]
    merge_rate = (counts >= 2.0 - 1e-4).mean()
    assert merge_rate > 0.3, merge_rate
    assert ((counts == 1.0) | (counts == 2.0)).all()


def test_reproject_rejects_disocclusion():
    r = _port(BASE.replace(reprojection_rate=1))
    r.step()
    r.camera.position = np.array([50.0, 0.0, 40.0], np.float32)
    r.step()
    img = r.buffers.image.numpy()
    assert np.isfinite(img).all()
    assert (img[..., 3] >= 0).all()


def test_bilateral_filter_smoke():
    r = _port(BASE.replace(reprojection_rate=1, bilateral_filter=True))
    r.step()
    r.step()
    assert np.isfinite(r.buffers.image.numpy()).all()


def test_debug_reprojection_tints():
    r = _port(BASE.replace(reprojection_rate=1, debug_reprojection=True))
    r.step()
    assert np.isfinite(r.buffers.image.numpy()).all()
