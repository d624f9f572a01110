"""PyTorch port: the exact-pairs trace (K2p single-level, K3p two-level)
and the exact adjudication against the JAX package.

The pairs twins run here (CPU tensors); the CUDA kernels are held against
them on the card in tests/test_torch_cuda.py. Scenes and ray sets are those
of tests/test_adjudicate.py (the mini scene: random rays, a grazing band
across a triangle edge, and their mix) and tests/test_two_level.py (the
sphere, plane and cube with ``cluster_size=16, group_size=4``).

* The adjudication functions are bit-equal to JAX's eager ones on the same
  candidate faces, including the dense fallback when every ray is flagged.
* The port's pairs twins followed by the adjudication give the faces of
  the port's K1/K3 twins and of JAX's threaded oracle on the random sets,
  and of JAX's Pallas kernel in pairs mode under the interpreter. On the
  grazing band a mismatch must be a miss, within JAX's own 2 % allowance
  (tests/test_adjudicate.py:129-131).
* A 16x16 frame with both exact flags: the port's frame equals its default
  frame bit for bit, and matches JAX's jitted Pallas-interpreter frame with
  exact pairs at the tolerances tests/test_torch_render.py holds jitted
  JAX frames to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.config import RenderSettings as JSettings
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops import cluster_pallas as jcp
from webgpu_raytracing_tpu.ops import strictf as jstrictf
from webgpu_raytracing_tpu.ops.cluster_trace import ray_matrix as j_ray_matrix
from webgpu_raytracing_tpu.ops.traverse import trace_closest as j_oracle
from webgpu_raytracing_tpu.renderer import Renderer as JRenderer
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.ops import adjudicate as adj
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops.cluster_trace import ray_matrix
from webgpu_raytracing_tpu_torch.renderer import Renderer as TRenderer

torch.set_num_threads(1)

TWO_LEVEL = dict(cluster_size=16, group_size=4)


def _mini(scene_mod, tm):
    """tests/test_adjudicate.py scene (also the golden mini scene)."""
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


@pytest.fixture(scope="module")
def tables():
    """name → (JAX tables, port tables); the two-level ones with S = 16,
    G = 4, and JAX's single-level tables of the same scene for the
    oracle."""
    return {
        "mini": (_mini(jscene, jtm).tables(),
                 _mini(tscene, ttm).tables("cpu")),
        "cluster": (_cluster_scene(jscene, jtm).tables(),
                    _cluster_scene(tscene, ttm).tables("cpu")),
        "two_level": (_cluster_scene(jscene, jtm).tables(**TWO_LEVEL),
                      _cluster_scene(tscene, ttm).tables("cpu", **TWO_LEVEL)),
    }


def _random(seed, n, z_band=True):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    if z_band:
        o[:, 2] = rng.uniform(0, 2, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _grazing(jt, rng, n=None, eps=None):
    """Rays at a tight band across the v = 0 edge of face 3, from its front
    side (tests/test_adjudicate.py)."""
    tri = np.asarray(jt.tri)
    p0, e1, e2 = tri[3, 0:3], tri[3, 3:6], tri[3, 6:9]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm)
    if eps is None:
        eps = rng.uniform(-2e-5, 2e-5, n)
    s = rng.uniform(0.05, 0.95, eps.shape[0])
    pts = p0[None, :] + s[:, None] * e1[None, :] + eps[:, None] * e2[None, :]
    o = (pts + nrm[None, :] * 2.0).astype(np.float32)
    d = np.broadcast_to(-nrm, o.shape).astype(np.float32)
    return o, d


def _ray_set(name, jt):
    """(o, d) of a named set of tests/test_adjudicate.py or
    tests/test_two_level.py."""
    if name == "random_384":  # test_exact_pairs_full_batch_matches_oracle
        return _random(7, 384)
    if name == "grazing_256":  # test_exact_pairs_matches_oracle_on_grazing
        rng = np.random.default_rng(7)
        eps = np.concatenate([
            np.geomspace(1e-7, 1e-3, 64), -np.geomspace(1e-7, 1e-3, 64),
            rng.uniform(-2e-5, 2e-5, 128),
        ])
        return _grazing(jt, rng, eps=eps)
    # "mixed_1024": test_adjudicate_compact_equals_dense (640 random rays,
    # then 384 grazing)
    rng = np.random.default_rng(7)
    o = rng.uniform(-3, 3, (640, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0, 2, 640)
    d = rng.normal(size=(640, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    og, dg = _grazing(jt, rng, 384)
    return np.concatenate([o, og]), np.concatenate([d, dg])


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _pairs(tt, o, d, tmax, active=None, excl=None, two_level=None):
    """The port's pairs twin → (args, (t1, c1, c2, c3, amb), faces)."""
    args = cc.prepare_tiles(_t(o), _t(d), _t(tmax), tt, _t(active), _t(excl),
                            two_level=two_level, pairs=True)
    out = cc.trace_pairs_args(args)[0](**args)
    r = o.shape[0]
    faces = tuple(cc.code_to_face(c[:r], tt.clusters.face_id)
                  for c in out[1:4])
    return args, tuple(x[:r] for x in out), faces


def _hit_equal(got, want):
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy().view(np.int32),
            np.asarray(getattr(want, k)).view(np.int32), err_msg=k,
        )
    np.testing.assert_array_equal(got.face.numpy(), np.asarray(want.face))


def test_ray_matrix_matches_jax():
    """A = [o | o×d | d | 1]: bit-equal to JAX's with strict cross
    products, and within an ulp-scale bound of JAX's ``ray_matrix`` (whose
    ``jnp.cross`` may contract)."""
    o, d = _random(3, 512, z_band=False)
    got = ray_matrix(_t(o), _t(d)).numpy()
    strict = np.concatenate(
        [o, np.asarray(jstrictf.scross(jnp.asarray(o), jnp.asarray(d))), d,
         np.ones((512, 1), np.float32)], axis=1,
    )
    np.testing.assert_array_equal(got, strict)
    np.testing.assert_allclose(got, np.asarray(j_ray_matrix(o, d)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["candidates", "pair", "compact_2",
                                  "compact_64", "overflow_8"])
def test_adjudication_bit_equal_to_jax(tables, case):
    """On the mixed set's carried faces (from the port's pairs twin),
    adjudicate_candidates, adjudicate_pair and adjudicate_compact (with
    the twin's flag at cap_frac 2 and 64, and with every ray flagged at
    cap_frac 8, the dense fallback) equal JAX's eager functions bit for
    bit: t, u, v and face."""
    jt, tt = tables["mini"]
    o, d = _ray_set("mixed_1024", jt)
    tmax = np.full((o.shape[0],), F32_MAX, np.float32)
    _, (t1, _, _, _, amb), faces = _pairs(tt, o, d, tmax)
    tf = _t(tmax)
    jo, jd, jtm_ = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)
    jfaces = tuple(jnp.asarray(f.numpy()) for f in faces)
    if case == "candidates":
        got = adj.adjudicate_candidates(_t(o), _t(d), tf, faces, tt)
        want = jcp.adjudicate_candidates(jo, jd, jtm_, jfaces, jt)
    elif case == "pair":
        got = adj.adjudicate_pair(_t(o), _t(d), tf, faces[0], faces[1], tt)
        want = jcp.adjudicate_pair(jo, jd, jtm_, jfaces[0], jfaces[1], jt)
    else:
        cap_frac = int(case.split("_")[1])
        if case.startswith("overflow"):
            amb = torch.ones_like(amb)
        got = adj.adjudicate_compact(_t(o), _t(d), tf, t1, faces, amb, tt,
                                     cap_frac=cap_frac)
        want = jcp.adjudicate_compact(
            jo, jd, jtm_, jnp.asarray(t1.numpy()), jfaces,
            jnp.asarray(amb.numpy()), jt, cap_frac=cap_frac,
        )
        dense = adj.adjudicate_candidates(_t(o), _t(d), tf, faces, tt)
        _hit_equal(got, dense)
    _hit_equal(got, want)
    assert (got.face >= 0).sum() > 300


def _jax_pairs(jt, o, d, tmax, active=None, excl=None):
    return jcp.trace_closest_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt,
        None if active is None else jnp.asarray(active), tile=128,
        interpret=True, exact_pairs=True,
        excl_code=None if excl is None else jnp.asarray(excl),
    )


def _bounce_set(jt, tt):
    """128 bounce rays leaving the hit points of random rays (exclusion
    codes of the source face's duplicate, inactive where the primary
    missed), then 256 random rays with inactive lanes and NaN origins
    (tests/test_torch_two_level.py's ``edge`` set)."""
    o, d = _random(41, 128)
    prim = cc.trace_closest_clustered_cuda(_t(o), _t(d),
                                           torch.full((128,), F32_MAX), tt)
    face = prim.face.numpy()
    fc = np.maximum(face, 0)
    shade = tt.shade_normal.numpy()[fc]
    from webgpu_raytracing_tpu_torch.ops.integrator import face_point_offset

    ob = face_point_offset(tt.tri[fc], tt.shade_normal[fc], prim.u,
                           prim.v).numpy()
    rng = np.random.default_rng(42)
    db = rng.normal(size=(128, 3)).astype(np.float32)
    db = db / np.linalg.norm(db, axis=1, keepdims=True) + shade[:, 0:3]
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)
    eb = np.where(face >= 0, tt.clusters.partner_code.numpy()[fc], -1)
    o, d = _random(43, 256)
    rng = np.random.default_rng(44)
    o[rng.uniform(size=256) < 0.1, rng.integers(0, 3)] = np.nan
    active = np.concatenate([face >= 0, rng.uniform(size=256) > 0.3])
    excl = np.concatenate([eb, np.full(256, -1)]).astype(np.int32)
    return np.concatenate([ob, o]), np.concatenate([db, d]), active, excl


@pytest.mark.parametrize("scene, rays", [
    ("mini", "random_384"), ("mini", "mixed_1024"),
    ("cluster", "random_384"), ("two_level", "random_384"),
    ("two_level", "bounce"),
])
def test_adjudicated_faces_match_k1_k3_and_oracle(tables, scene, rays):
    """Pairs twin + adjudicate_compact (the ``exact_pairs`` route of
    trace_closest_clustered_cuda) give the faces of the port's K1/K3 twin
    and of JAX's threaded oracle on the random sets, with t, u, v
    bit-equal to the K1/K3 route's; and the faces of JAX's Pallas kernel
    in pairs mode under the interpreter (on the mixed set, whose grazing
    half is knife-edge territory, at most 2 % of the rays differ, each a
    miss on one side)."""
    jt, tt = tables[scene]
    active = excl = None
    if rays == "bounce":
        o, d, active, excl = _bounce_set(jt, tt)
    else:
        o, d = _ray_set(rays, tables["mini"][0])
    r = o.shape[0]
    tmax = np.full((r,), F32_MAX, np.float32)
    ins = (_t(o), _t(d), _t(tmax), tt, _t(active), _t(excl))
    got = cc.trace_closest_clustered_cuda(*ins, exact_pairs=True)
    plain = cc.trace_closest_clustered_cuda(*ins)
    gf = got.face.numpy()
    np.testing.assert_array_equal(gf, plain.face.numpy())
    for k in ("t", "u", "v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(plain, k).numpy(), err_msg=k)
    oracle_tables = tables["cluster"][0] if scene == "two_level" else jt
    ja = None if active is None else jnp.asarray(active)
    oracle = np.asarray(j_oracle(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmax), oracle_tables, ja).face)
    pallas = np.asarray(_jax_pairs(jt, o, d, tmax, active, excl).face)
    if rays == "mixed_1024":
        np.testing.assert_array_equal(gf[:640], oracle[:640])
        mism = gf != pallas
        assert mism.mean() <= 0.02, f"{mism.sum()} of {r} differ"
        assert ((gf[mism] < 0) | (pallas[mism] < 0)).all()
    else:
        np.testing.assert_array_equal(gf, oracle)
        np.testing.assert_array_equal(gf, pallas)
    assert (gf >= 0).sum() > 50
    if active is not None:
        assert (gf[~active] < 0).all()
        assert (gf[np.isnan(o).any(axis=1)] < 0).all()


def test_grazing_band_against_oracle(tables):
    """tests/test_adjudicate.py's grazing band: the adjudicated decisions
    equal the exact oracle's except double-knife-edge rays, which must be
    rare (at most 2 %) and misses; where faces agree, t matches the
    oracle's to 1e-6 relative. The band crosses a decision boundary."""
    jt, tt = tables["mini"]
    o, d = _ray_set("grazing_256", jt)
    tmax = np.full((o.shape[0],), F32_MAX, np.float32)
    got = cc.trace_closest_clustered_cuda(_t(o), _t(d), _t(tmax), tt,
                                          exact_pairs=True)
    ref = j_oracle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt)
    gf, want = got.face.numpy(), np.asarray(ref.face)
    mism = gf != want
    print(f"grazing band: {mism.sum()} of {gf.size} differ from the oracle")
    assert mism.mean() <= 0.02
    assert (gf[mism] == -1).all()
    assert (want < 0).any() or len(np.unique(want[want >= 0])) >= 2
    hits = (want >= 0) & ~mism
    np.testing.assert_allclose(got.t.numpy()[hits], np.asarray(ref.t)[hits],
                               rtol=1e-6)


def test_flag_complete_and_sparse(tables):
    """Wherever the dense verdict over the carried faces differs from the
    first candidate's rederive, the twin flagged the ray; the flag is
    rarer than 5 % on the random prefix of the mixed set."""
    jt, tt = tables["mini"]
    o, d = _ray_set("mixed_1024", jt)
    tmax = _t(np.full((o.shape[0],), F32_MAX, np.float32))
    _, (t1, _, _, _, amb), faces = _pairs(tt, o, d, tmax.numpy())
    dense = adj.adjudicate_candidates(_t(o), _t(d), tmax, faces, tt)
    base = cc.rederive_uv(_t(o), _t(d), torch.where(faces[0] >= 0, t1, tmax),
                          faces[0], tt)
    differs = (base.face != dense.face) | (base.t != dense.t)
    assert (amb[differs] != 0).all()
    assert float(amb[:640].float().mean()) < 0.05
    print(f"flag rate: random {float(amb[:640].float().mean()):.4f}, "
          f"grazing {float(amb[640:].float().mean()):.4f}; dense differs "
          f"from rederive on {int(differs.sum())}")


def test_pairs_walk_counts_its_work(tables):
    """walk_stats of a pairs walk: the estimate and magnitude terms follow
    the counts of the steps each slot needs (a gate's magnitudes only
    outside the exact triangle, t_num past every gate, the robust test
    only below the carried robust pair), at most those of the full test,
    which ``ops_full_test`` counts; the bytes count 19 B entries per face
    tested."""
    _, tt = tables["two_level"]
    o, d = _random(5, 1000)
    args = cc.prepare_tiles(_t(o), _t(d), torch.full((1000,), F32_MAX), tt,
                            pairs=True)
    stats = {}
    cc._walk_pairs_two_level_torch(**args, stats=stats)
    w = cc.walk_stats(stats, args["face_id"], any_hit=False, pairs=True)
    past = stats["slot_tests_past_cull"]
    assert 0 < past <= w["slot_tests"]
    steps = [stats[f"pairs_{k}"] for k in ("u_pass", "v_pass", "gate_pass",
                                            "valid")]
    assert past >= steps[0] >= steps[1] >= steps[2] >= steps[3] > 0
    assert 0 < stats["pairs_robust_tests"] <= stats["pairs_valid"]
    assert w["estimate_terms"] == (3 * w["slot_tests"] + 6 * past
                                   + 6 * steps[0] + 4 * steps[2])
    assert w["estimate_terms"] <= 3 * w["slot_tests"] + 16 * past
    assert w["magnitude_terms"] == (
        6 * stats["pairs_magnitudes_u"] + 6 * stats["pairs_magnitudes_v"]
        + 7 * stats["pairs_robust_tests"])
    assert 0 < w["magnitude_terms"] < 19 * past
    assert w["bytes"] >= 80 * 1024 + 76 * w["faces_tested"]
    assert w["ops_full_test"] > cc.PAIRS_SLOT_REST_OPS * past
    assert 13 * past < w["ops"] < w["ops_full_test"]


def test_pairs_wrappers_never_run_the_twin_for_other_devices(tables):
    _, tt = tables["two_level"]
    o, d = _random(3, 256)
    for two_level in (True, False):
        args = cc.prepare_tiles(_t(o), _t(d), torch.full((256,), F32_MAX),
                                tt, two_level=two_level, pairs=True)
        assert ("o" not in args and "tri" not in args
                and args["a"].shape == (256, 10))
        wrapper = cc.trace_pairs_args(args)[0]
        meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
                for k, v in args.items()}
        before = wrapper.launches
        with pytest.raises(ValueError):
            wrapper(**meta)
        wrapper(**args)  # the twin is not a launch
        with pytest.raises(ValueError):
            cc._launch_pairs(**args)
        assert wrapper.launches == before


@pytest.mark.parametrize("exact, bounce, depth, want", [
    (True, False, 4, 2), (True, True, 4, 6), (True, True, 3, 4),
    (True, False, 1, 2), (False, True, 4, 0),
])
def test_exact_settings_route_the_legs(monkeypatch, exact, bounce, depth,
                                       want):
    """Per 8x8 frame (2 camera samples): ``exact_pairs`` sends the primary
    legs through the pairs walk, ``exact_pairs_bounce`` also the bounce
    legs (the direct integrator's one leg is primary); without
    ``exact_pairs`` the bounce flag does nothing."""
    calls = {}

    def spy_on(wrapper):
        walk = wrapper.twin
        calls[wrapper] = []

        def spy(*args, **kw):
            calls[wrapper].append((args[0] if args else kw["a"]).shape[0])
            return walk(*args, **kw)

        monkeypatch.setattr(wrapper, "twin", spy)

    spy_on(cc.trace_pairs_tiles)
    spy_on(cc.trace_near_pairs_tiles)
    # the default orders each tile inside the kernel (K2n's pairs entry);
    # kernel_near=False keeps K2p over the order sorted outside
    for near, ran, idle in (
        (True, cc.trace_near_pairs_tiles, cc.trace_pairs_tiles),
        (False, cc.trace_pairs_tiles, cc.trace_near_pairs_tiles),
    ):
        st = TSettings(width=8, height=8, bounces_depth=depth, sample_count=1,
                       exact_pairs=exact, exact_pairs_bounce=bounce)
        assert st.kernel_near is True
        r = TRenderer(_mini(tscene, ttm), st.replace(kernel_near=near),
                      base_seed=4, device="cpu")
        r.step()
        assert len(calls[ran]) == want and not calls[idle]
        assert np.isfinite(r.buffers.image.numpy()).all()
        calls[ran].clear()


def _frame(st, exact, two_level=False):
    r = TRenderer(_mini(tscene, ttm), TSettings(
        exact_pairs=exact, exact_pairs_bounce=exact, **st,
    ), base_seed=11, device="cpu")
    if two_level:
        r.tables = _mini(tscene, ttm).tables("cpu", **TWO_LEVEL)
    r.step()
    return r


FRAME = dict(width=16, height=16, bounces_depth=3, sample_count=1,
             environment="procedural")


@pytest.mark.parametrize("two_level", [False, True],
                         ids=["single", "two_level"])
def test_exact_frame_equals_default_frame(two_level):
    """A 16x16 frame with exact_pairs and exact_pairs_bounce equals the
    default frame bit for bit (any differing pixel is listed)."""
    a = _frame(FRAME, True, two_level).buffers
    b = _frame(FRAME, False, two_level).buffers
    img_a, img_b = a.image.numpy(), b.image.numpy()
    diff = np.argwhere(np.any(img_a != img_b, axis=-1))
    assert diff.size == 0, f"pixels differ: {diff.tolist()}"
    np.testing.assert_array_equal(a.geo_face.numpy(), b.geo_face.numpy())
    assert (img_a[..., 3] == 2.0).all()


def test_exact_frame_matches_jax_pallas_interpret():
    """Against JAX's jitted frame with traversal="pallas_interpret" and
    both exact flags: equal sample counts, RMSE <= 1e-2, >= 99 % of pixels
    equal to 1e-5 relative, equal primary faces (the tolerances
    tests/test_torch_render.py holds jitted JAX frames to)."""
    jr = JRenderer(_mini(jscene, jtm), JSettings(
        traversal="pallas_interpret", trace_tile=128, exact_pairs=True,
        exact_pairs_bounce=True, **FRAME,
    ), base_seed=11)
    jr.step()
    tr = _frame(FRAME, True)
    want = np.asarray(jr.buffers.image)
    got = tr.buffers.image.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    close = float(np.mean(np.all(
        np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), 0.1), axis=-1
    )))
    print(f"exact-pairs frame vs JAX pallas_interpret: RMSE {rmse:.3g}, "
          f"pixels equal to 1e-5 {close:.4f}")
    assert rmse <= 1e-2, rmse
    assert close >= 0.99, close
    np.testing.assert_array_equal(tr.buffers.geo_face.numpy(),
                                  np.asarray(jr.buffers.geo_face))
