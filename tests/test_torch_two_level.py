"""PyTorch port: two-level (supercluster) tables, the two-level trace
(K3) and frame slabs against the JAX package (the large-scene path,
BASELINE config #5).

The K3 twins run here (CPU tensors); the CUDA kernel is held against them
on the card in tests/test_torch_cuda.py. The scene and ray sets are those
of tests/test_two_level.py, with ``cluster_size=16, group_size=4`` so a
small scene has several supers. References: the XLA clustered trace
(exact f32), the threaded BVH oracle and the Pallas two-level kernel
under the interpreter (``exact_pairs=False``). The closest-hit result is
the minimum of (t, code) over all valid slots, so K3's faces must also
equal K1's on the same tables."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import stress as jstress
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    is_two_level as j_is_two_level,
)
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    rederive_uv as j_rederive_uv,
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
from webgpu_raytracing_tpu.ops.traverse import trace_any as j_any_oracle
from webgpu_raytracing_tpu.ops.traverse import trace_closest as j_oracle
from webgpu_raytracing_tpu.renderer import Renderer as JRenderer
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import stress as tstress
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.renderer import (
    FrameBuffers,
    FrameInputs,
    Renderer as TRenderer,
    render_frame,
    render_frame_slabs,
)

torch.set_num_threads(1)

TWO_LEVEL = dict(cluster_size=16, group_size=4)


def _cluster_scene(scene_mod, tm):
    """tests/test_two_level.py scene."""
    return scene_mod.scene_from_facesets(
        [
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


def _mini(scene_mod, tm):
    """tests/test_parity_ops.py golden scene (it has a light, for NEE)."""
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


def _cluster_arrays(ct):
    return {
        k: np.asarray(getattr(ct, k)) for k in tscene.CLUSTER_FIELDS
        if getattr(ct, k) is not None
    }


@pytest.fixture(scope="module")
def scenes():
    """(JAX single-level tables, JAX two-level tables, port two-level
    tables built by the port itself)."""
    return (
        _cluster_scene(jscene, jtm).tables(),
        _cluster_scene(jscene, jtm).tables(**TWO_LEVEL),
        _cluster_scene(tscene, ttm).tables("cpu", **TWO_LEVEL),
    )


def test_two_level_tables_match_jax(scenes):
    _, jt2, tt2 = scenes
    want = _cluster_arrays(jt2.clusters)
    got = _cluster_arrays(tt2.clusters)
    assert set(got) == set(want) == set(tscene.CLUSTER_FIELDS)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    ct = tt2.clusters
    assert ct.group == 4 and ct.super_box.shape == (ct.box.shape[0] // 4, 6)
    assert cc.is_two_level(ct) == j_is_two_level(jt2.clusters) is True
    for k in tscene.TABLE_FIELDS:
        np.testing.assert_array_equal(
            getattr(tt2, k).numpy(), np.asarray(getattr(jt2, k)), err_msg=k
        )
    # the numpy hand-over keeps the two-level fields
    back = tscene.tables_to_numpy(
        tscene.tables_from_numpy(tscene.tables_to_numpy(tt2), "cpu")
    )
    assert back["clusters.child_box_t"].shape == want["child_box_t"].shape


@pytest.mark.parametrize("cluster_size, group", [(2, 64), (8, 0)])
def test_automatic_two_level_rule_matches_jax(cluster_size, group):
    """G = 64 once a scene holds more than 1024 clusters' worth of faces
    (4,588 faces: two-level at S = 2, single-level at S = 8)."""
    jt = jstress.stress_scene(5000).tables(cluster_size=cluster_size)
    tt = tstress.stress_scene(5000).tables("cpu", cluster_size=cluster_size)
    assert jt.clusters.group == tt.clusters.group == group
    want = _cluster_arrays(jt.clusters)
    got = tscene.tables_to_numpy(tt)
    for k, v in want.items():
        np.testing.assert_array_equal(got["clusters." + k], v, err_msg=k)


def _rays(seed, n, z_band):
    """tests/test_two_level.py's generator."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    if z_band:
        o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _bounce(jt, n, seed):
    """Rays leaving the hit points of a primary set, excluding the source
    face's two-sided duplicate by code (as path_trace passes it)."""
    o, d = _rays(seed, n, True)
    prim = trace_closest_clustered(
        jnp.asarray(o), jnp.asarray(d), jnp.full((n,), F32_MAX), jt, tile=128
    )
    face = np.asarray(prim.face)
    fc = np.maximum(face, 0)
    shade = np.asarray(jt.shade_normal)[fc]
    o2 = np.array(j_face_point_offset(
        jnp.asarray(np.asarray(jt.tri)[fc]), jnp.asarray(shade), prim.u,
        prim.v,
    ))
    rng = np.random.default_rng(seed + 1)
    d2 = rng.normal(size=(n, 3)).astype(np.float32)
    d2 = d2 / np.linalg.norm(d2, axis=1, keepdims=True) + shade[:, 0:3]
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    excl = np.where(
        face >= 0, np.asarray(jt.clusters.partner_code)[fc], -1
    ).astype(np.int32)
    return o2, d2, face >= 0, excl


def _ray_set(name, jt2):
    """(o, d, t_max, active, excl) of a named set. The ``edge`` set: 128
    bounce rays that exclude their source face's duplicate by code, then
    256 rays with inactive lanes and NaN origins."""
    active = excl = None
    if name == "interpret_384":  # test_two_level_interpret_matches_threaded
        o, d = _rays(7, 384, True)
    elif name == "approx_div_256":  # test_two_level_approx_div_...
        o, d = _rays(7, 256, True)
    elif name == "any_hit_256":  # test_two_level_any_hit_interpret
        o, d = _rays(7, 256, False)
    else:
        ob, db, hit, eb = _bounce(jt2, 128, 41)
        assert (eb >= 0).sum() > 50
        o, d = _rays(43, 256, True)
        rng = np.random.default_rng(44)
        o[rng.uniform(size=256) < 0.1, rng.integers(0, 3)] = np.nan
        o, d = np.concatenate([ob, o]), np.concatenate([db, d])
        active = np.concatenate([hit, rng.uniform(size=256) > 0.3])
        excl = np.concatenate([eb, np.full(256, -1, np.int32)])
    tmax = np.full((o.shape[0],), F32_MAX, np.float32)
    return o, d, tmax, active, excl


def _t(a):
    return None if a is None else torch.from_numpy(a)


SETS = ["interpret_384", "approx_div_256", "any_hit_256", "edge"]


@pytest.mark.parametrize("name", SETS)
def test_closest_two_level_matches_jax(scenes, name):
    """Face ids equal the XLA clustered trace and the threaded oracle on
    the two-level tables; after rederive_uv, t, u, v are bit-equal to
    JAX's. Against the Pallas two-level kernel (bf16 hi/lo matmul
    decisions, exclusion codes passed) they are equal too on these sets:
    no knife edge appeared."""
    jt1, jt2, tt2 = scenes
    o, d, tmax, active, excl = _ray_set(name, jt2)
    got = cc.trace_closest_clustered_cuda(
        _t(o), _t(d), _t(tmax), tt2, _t(active), _t(excl)
    )
    gf = got.face.numpy()
    ja = None if active is None else jnp.asarray(active)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    clustered = trace_closest_clustered(*jargs, jt2, ja, tile=128)
    oracle = j_oracle(*jargs, jt1, ja)
    pallas = trace_closest_clustered_pallas(
        *jargs, jt2, ja, tile=128, interpret=True, exact_pairs=False,
        excl_code=None if excl is None else jnp.asarray(excl),
    )
    for ref in (clustered, oracle, pallas):
        np.testing.assert_array_equal(gf, np.asarray(ref.face))
    assert (gf >= 0).sum() > 50
    if active is not None:
        assert (gf[~active] < 0).all()
        assert (gf[:128] >= 0).any()  # some bounce rays hit
    if name == "edge":
        assert (gf[np.isnan(o).any(axis=1)] < 0).all()
    jr = j_rederive_uv(jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(got.t.numpy()), jnp.asarray(gf), jt2)
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(jr, k)), err_msg=k
        )


@pytest.mark.parametrize("tmax_val", [F32_MAX, 2.5], ids=["unbounded", "2.5"])
@pytest.mark.parametrize("name", ["any_hit_256", "edge"])
def test_any_two_level_matches_jax(scenes, name, tmax_val):
    """Shadow flags equal the XLA clustered any-hit trace and the threaded
    oracle on the two-level tables, unbounded and with t_max = 2.5."""
    jt1, jt2, tt2 = scenes
    o, d, _, active, excl = _ray_set(name, jt2)
    tmax = np.full((o.shape[0],), tmax_val, np.float32)
    got = cc.trace_any_clustered_cuda(
        _t(o), _t(d), _t(tmax), tt2, _t(active), _t(excl)
    ).numpy()
    ja = None if active is None else jnp.asarray(active)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    np.testing.assert_array_equal(
        got, np.asarray(trace_any_clustered(*jargs, jt2, ja, tile=128))
    )
    np.testing.assert_array_equal(got, np.asarray(j_any_oracle(*jargs, jt1, ja)))
    assert 10 < got.sum() < got.size - 10


def _mixed_args(tt2, two_level, seed=19, n=2000):
    """Inactive lanes, finite t_max, NaN origins and exclusion codes."""
    rng = np.random.default_rng(seed)
    o, d = _rays(seed, n, True)
    o[rng.uniform(size=n) < 0.03, 1] = np.nan
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 8.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = rng.integers(-1, tt2.clusters.face_id.numel(), n).astype(np.int32)
    return cc.prepare_tiles(_t(o), _t(d), _t(tmax), tt2, _t(active),
                            _t(excl), two_level=two_level)


def test_two_level_twin_equals_single_level_twin(scenes):
    """On the same tables, K3's twin and K1's twin (over all C cluster
    boxes) give the same closest codes and t bits, and the same any-hit
    flags: the results do not depend on the schedule."""
    tt2 = scenes[2]
    a2 = _mixed_args(tt2, None)
    a1 = _mixed_args(tt2, False)
    assert a2["group"] == 4 and "group" not in a1
    assert a2["snear"].shape[1] == tt2.clusters.super_box.shape[0]
    assert a1["snear"].shape[1] == tt2.clusters.box.shape[0]
    assert cc.trace_closest_args(a2)[0] is cc.trace_closest_two_level_tiles
    assert cc.trace_any_args(a1)[0] is cc.trace_any_tiles
    t2, c2 = cc.trace_closest_two_level_tiles(**a2)
    t1, c1 = cc.trace_closest_tiles(**a1)
    np.testing.assert_array_equal(c2.numpy(), c1.numpy())
    np.testing.assert_array_equal(t2.numpy().view(np.int32),
                                  t1.numpy().view(np.int32))
    assert (c2 >= 0).sum() > 200
    f2 = cc.trace_any_two_level_tiles(**a2) >= 0
    f1 = cc.trace_any_tiles(**a1) >= 0
    np.testing.assert_array_equal(f2.numpy(), f1.numpy())
    assert 100 < int(f2.sum()) < f2.numel() - 100


def test_walk_stats_count_the_two_level_cull(scenes):
    """The twins' work counts: the two-level walk tests fewer triangles'
    boxes per ray than the whole cluster list, and counts its in-kernel
    child cull (every ray of a visited tile against every child with
    faces)."""
    tt2 = scenes[2]
    a2 = _mixed_args(tt2, None)
    a1 = _mixed_args(tt2, False)
    s2, s1 = {}, {}
    cc.trace_closest_two_level_tiles.twin(**a2, stats=s2)
    cc.trace_closest_tiles.twin(**a1, stats=s1)
    w2 = cc.walk_stats(s2, tt2.clusters.face_id, any_hit=False)
    w1 = cc.walk_stats(s1, tt2.clusters.face_id, any_hit=False)
    for w in (w1, w2):
        assert w["ops"] > 0 and w["bytes"] > 48 * a1["o"].shape[0]
        assert 0 < w["clusters_tested"] <= tt2.clusters.box.shape[0]
    assert s2["rays"] == s1["rays"] == a1["o"].shape[0]
    assert s2["box_tests"] >= 128 * s2["table_steps"]


def _port_frame(st, two_level):
    r = TRenderer(_mini(tscene, ttm), TSettings(**st), base_seed=13,
                  device="cpu")
    assert r.tables.clusters.super_box is None
    if two_level:
        r.tables = _mini(tscene, ttm).tables("cpu", **TWO_LEVEL)
    r.step()
    return r


@pytest.mark.parametrize("kw", [dict(), dict(next_event_estimation=True)],
                         ids=["default", "nee"])
def test_frames_on_two_level_tables(kw):
    """A 32x32 frame on two-level tables is bit-identical to the port's
    frame on single-level tables of the same scene."""
    st = dict(width=32, height=32, bounces_depth=3, sample_count=1,
              environment="white", **kw)
    before = cc.trace_closest_two_level_tiles.launches
    one, two = _port_frame(st, False), _port_frame(st, True)
    assert cc.trace_closest_two_level_tiles.launches == before  # CPU: twins
    got = two.buffers.image.numpy()
    np.testing.assert_array_equal(got, one.buffers.image.numpy())
    np.testing.assert_array_equal(two.buffers.geo_face.numpy(),
                                  one.buffers.geo_face.numpy())
    assert two.last_rays == one.last_rays
    assert (got[..., 3] == 2.0).all() and np.isfinite(got).all()


def test_frame_on_two_level_tables_bit_identical_to_eager_jax():
    """A NEE frame (closest-hit and shadow legs) on two-level tables is
    bit-identical to the JAX renderer run op by op (jit disabled,
    traversal="clustered") on the same tables, with a constant
    environment: 16x16 and one bounce, since op by op JAX takes about 15 s
    per 32x32 frame of three segments."""
    st = dict(width=16, height=16, bounces_depth=2, sample_count=1,
              environment="white", next_event_estimation=True)
    two = _port_frame(st, True)
    jr = JRenderer(_mini(jscene, jtm), JSettings(traversal="clustered", **st),
                   base_seed=13)
    jr.tables = _mini(jscene, jtm).tables(**TWO_LEVEL)
    assert jr.tables.clusters.super_box is not None
    with jax.disable_jit():
        jr.step()
    np.testing.assert_array_equal(two.buffers.image.numpy(),
                                  np.asarray(jr.buffers.image))
    np.testing.assert_array_equal(two.buffers.geo_face.numpy(),
                                  np.asarray(jr.buffers.geo_face))
    assert two.last_rays == jr.last_rays
    assert (two.buffers.geo_face.numpy() >= 0).mean() > 0.3


def test_frame_slabs_bit_identical():
    """render_frame_slabs with 4 slabs equals render_frame bit for bit
    (global pixel indices and RNG streams), on two-level tables; so does
    Renderer.step with frame_slabs=4; a slab count that does not divide
    the height raises."""
    scene = _mini(tscene, ttm)
    tables = scene.tables("cpu", **TWO_LEVEL)
    st = TSettings(width=24, height=32, bounces_depth=3, sample_count=1,
                   environment="procedural")
    inputs = FrameInputs(
        view=torch.eye(4), seed=1234567, counter=0,
        jitter=torch.tensor([0.1, -0.2]),
    )
    buffers = FrameBuffers.create(24, 32, "cpu")
    env = torch.zeros((1, 1, 3))
    whole, rays = render_frame(buffers, tables, env, inputs, st)
    slabs, rays4 = render_frame_slabs(
        buffers, tables, env, inputs, st.replace(frame_slabs=4)
    )
    for f in dataclasses.fields(FrameBuffers):
        np.testing.assert_array_equal(
            getattr(slabs, f.name).numpy(), getattr(whole, f.name).numpy(),
            err_msg=f.name,
        )
    assert float(rays4) == float(rays) > 0

    images = []
    for n in (1, 4):
        r = TRenderer(scene, st.replace(frame_slabs=n), base_seed=8,
                      device="cpu")
        r.step()
        r.step()
        images.append(r.buffers.image.numpy())
    np.testing.assert_array_equal(images[0], images[1])
    assert (images[1][..., 3] == 4.0).all()

    bad = TRenderer(scene, st.replace(frame_slabs=3), base_seed=8,
                    device="cpu")
    with pytest.raises(ValueError, match="frame_slabs=3"):
        bad.step()


def test_resume_from_checkpoint_is_bit_identical(tmp_path):
    """Config #5's kill-and-resume contract at a small size: a run stopped
    after a frame, saved, loaded into a fresh Renderer and stepped equals
    the run that was never stopped, bit for bit (the checkpoint carries
    the host generator's state)."""
    scene = _mini(tscene, ttm)
    st = TSettings(width=16, height=16, bounces_depth=3, sample_count=1,
                   frame_slabs=2)
    path = str(tmp_path / "ckpt.npz")
    whole = TRenderer(scene, st, base_seed=21, device="cpu")
    whole.step()
    whole.step()
    first = TRenderer(scene, st, base_seed=21, device="cpu")
    first.step()
    first.save_checkpoint(path)
    resumed = TRenderer(scene, st, base_seed=21, device="cpu")
    resumed.load_checkpoint(path)
    assert resumed.counter == 1
    resumed.step()
    for f in dataclasses.fields(FrameBuffers):
        np.testing.assert_array_equal(
            getattr(resumed.buffers, f.name).numpy(),
            getattr(whole.buffers, f.name).numpy(), err_msg=f.name,
        )


def test_two_level_wrappers_never_run_the_twin_for_other_devices(scenes):
    tt2 = scenes[2]
    o, d = _rays(3, 256, True)
    args = cc.prepare_tiles(_t(o), _t(d), torch.full((256,), F32_MAX), tt2)
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
            for k, v in args.items()}
    counts = (cc.trace_closest_two_level_tiles.launches,
              cc.trace_any_two_level_tiles.launches)
    for wrapper in (cc.trace_closest_two_level_tiles,
                    cc.trace_any_two_level_tiles):
        with pytest.raises(ValueError):
            wrapper(**meta)
        wrapper(**args)  # the twin is not a launch
    with pytest.raises(ValueError):
        cc._launch_kernel(**args)
    assert counts == (cc.trace_closest_two_level_tiles.launches,
                      cc.trace_any_two_level_tiles.launches)
    with pytest.raises(ValueError, match="two-level"):
        cc.prepare_tiles(_t(o), _t(d), torch.full((256,), F32_MAX),
                         _mini(tscene, ttm).tables("cpu"), two_level=True)
