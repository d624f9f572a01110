"""PyTorch port: its spans and counters (``utils/timing.py``), on the CPU.

* Off, :func:`span` is the shared no-op, the profiler records no
  ``wrt.*`` range, ``last_counts`` is empty, and a frame runs the same
  operations as one that reads back only its ray count.
* On, each frame kind (path, NEE, env-IS, sorted, sliced, direct) has
  the span tree its calls make: one ``wrt.frame``, a ``wrt.raygen`` and a
  ``wrt.shade`` per sample and slab, a ``wrt.trace`` per leg inside
  ``wrt.shade``, prep and rederive inside the legs, the environment's
  work (``wrt.env``) and the lights' (``wrt.light``, around NEE's shadow
  legs and no other) inside ``wrt.shade``; the only added operation is
  the stack of the frame's one read-back.
* Counters: the closest-hit legs' live lanes sum to ``last_rays`` on a
  path frame without shadow legs; no leg has more live lanes than lanes;
  the frame's counters are the integrator's, the ray sort's (sorted
  frames only) and one ``renderer.restarts`` of a first frame.
* Tracing changes no result: image, G-buffer, ``last_rays``, the
  integrator's RNG state and the host generator are bit-identical.
* A garbage collection inside a traced frame is a ``wrt.gc`` span.
* ``cli render --profile`` writes the spans into its Chrome trace and
  ``--metrics`` rows carry the frame's counters.
* ``bench_torch/spans.py`` (which ``tools/torch_frame_profile.py``
  prints) finds the frame's spans in a real profile."""

import collections
import dataclasses
import gc
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import webgpu_raytracing_tpu_torch.renderer as renderer_mod
from webgpu_raytracing_tpu_torch.config import RenderSettings
from webgpu_raytracing_tpu_torch.frontend import cli
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort
from webgpu_raytracing_tpu_torch.ops.env_sample import build_env_distribution
from webgpu_raytracing_tpu_torch.renderer import FrameBuffers, Renderer
from webgpu_raytracing_tpu_torch.utils import timing

torch.set_num_threads(1)

BASE = dict(width=16, height=16, bounces_depth=3, sample_count=1)
KINDS = {
    "path": {},
    "nee": dict(next_event_estimation=True),
    "envis": dict(environment="equirect", env_importance_sampling=True),
    "sorted": dict(next_event_estimation=True, sort_bounce_rays=True),
    "sliced": dict(frame_slabs=2),
    "direct": dict(bounces_depth=1),
}


@pytest.fixture(scope="module")
def scene():
    """A light, a sphere, a cube and the floor in clusters of 16."""
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


def settings_of(kind):
    return RenderSettings(**{**BASE, **KINDS[kind]})


def renderer(scene, kind, seed=5):
    st = settings_of(kind)
    env = None
    if st.env_importance_sampling:
        g = np.random.default_rng(1)
        env = build_env_distribution(
            g.random((8, 16, 3)).astype(np.float32) * 2.0)
    r = Renderer(scene, st, env_data=env, base_seed=seed, device="cpu")
    r.tables = scene.tables("cpu", cluster_size=16)
    return r


def wrt_events(prof):
    return [e for e in prof.events() if e.name.startswith("wrt.")]


def inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def legs(st):
    """(closest-hit legs, shadow legs) of one frame."""
    samples = (1 + st.sample_count) * st.frame_slabs
    if st.bounces_depth <= 1:
        return samples, samples * st.samples_per_point
    segs = st.bounces_depth - 1
    shadow = 0
    if st.next_event_estimation:
        shadow += segs * st.samples_per_point
    if st.env_importance_sampling:
        shadow += (segs if st.env_nee_depth == 0
                   else min(segs, st.env_nee_depth))
    return samples * segs, samples * shadow


def test_off_is_the_shared_no_op_and_records_nothing(scene):
    assert timing.span("wrt.a") is timing.span("wrt.b", 3)
    assert timing.span("wrt.a") is timing._NO_SPAN
    r = renderer(scene, "nee")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.step()
    assert wrt_events(prof) == []
    assert r.last_counts == {} and timing._counts == {}
    assert timing._gc_span not in gc.callbacks


@pytest.mark.parametrize("kind", list(KINDS))
def test_span_tree(scene, kind):
    r = renderer(scene, kind)
    st = r.settings
    with timing.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        r.step()
    ev = wrt_events(p)
    by = collections.defaultdict(list)
    for e in ev:
        by[e.name].append(e)
    (frame,) = by["wrt.frame"]
    samples = (1 + st.sample_count) * st.frame_slabs
    assert len(by["wrt.raygen"]) == samples
    assert len(by["wrt.shade"]) == samples
    closest, shadow = legs(st)
    assert len(by["wrt.trace"]) == closest + shadow
    # NEE's shadow legs, one wrt.light around each vertex's light samples
    light = 0
    if st.bounces_depth <= 1:
        light = samples
    elif st.next_event_estimation:
        light = samples * (st.bounces_depth - 1)
    assert len(by["wrt.light"]) == light
    assert by["wrt.env"]  # the deferred fetch, in every frame
    assert len(by["wrt.trace.prep"]) >= closest + shadow
    assert len(by["wrt.trace.rederive"]) >= closest
    assert "wrt.trace.kernel" not in by  # the twins launch nothing
    assert ("wrt.trace.sort" in by) == st.sort_bounce_rays
    for e in ev:
        assert e is frame or inside(e, frame), e.name
    for e in by["wrt.raygen"]:
        assert not any(inside(e, s) for s in by["wrt.shade"])
    for name in ("wrt.trace", "wrt.env", "wrt.light"):
        for e in by[name]:
            assert any(inside(e, s) for s in by["wrt.shade"]), name
    in_light = [e for e in by["wrt.trace"]
                if any(inside(e, x) for x in by["wrt.light"])]
    assert len(in_light) == light * st.samples_per_point
    assert not any(inside(e, x) for e in by["wrt.trace"] + by["wrt.light"]
                   for x in by["wrt.env"])
    for name in ("wrt.trace.prep", "wrt.trace.rederive", "wrt.trace.sort"):
        for e in by[name]:
            assert any(inside(e, t) for t in by["wrt.trace"]), name
    # the counters name every leg
    counts = r.last_counts
    assert counts["trace.closest.lanes"] == closest * (
        st.render_width * st.render_height // st.frame_slabs)
    if st.bounces_depth > 1 and st.next_event_estimation:
        assert counts["trace.shadow.lanes"] > 0
    if st.env_importance_sampling:
        assert counts["trace.env_shadow.lanes"] > 0


def test_on_adds_one_stack_and_drops_the_scalar_read(scene):
    """Tracing on, the frame's operations are those of tracing off, with
    the read-back's stack (and the views it takes) for its item."""
    def ops(on):
        r = renderer(scene, "nee")
        with timing.tracing(on), profile(
                activities=[ProfilerActivity.CPU]) as p:
            r.step()
        return collections.Counter(e.name for e in p.events()
                                   if e.name.startswith("aten::"))
    off, on = ops(False), ops(True)
    added, dropped = on - off, off - on
    assert added["aten::stack"] == 1 and added["aten::cat"] == 1
    assert set(added) <= {"aten::stack", "aten::cat", "aten::unsqueeze",
                          "aten::as_strided", "aten::resolve_conj",
                          "aten::resolve_neg"}, added
    assert dropped == {"aten::item": 1, "aten::_local_scalar_dense": 1}


def test_closest_live_lanes_sum_to_last_rays(scene):
    r = renderer(scene, "path")
    with timing.tracing():
        r.step()
        r.step()
    c = r.last_counts
    assert set(c) == {"trace.closest.live", "trace.closest.lanes"}
    assert c["trace.closest.live"] == r.last_rays
    assert 0 < c["trace.closest.live"] < c["trace.closest.lanes"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_no_leg_has_more_live_lanes_than_lanes(scene, kind, monkeypatch):
    calls, sort_calls = [], []

    def spy(into):
        def count(name, value):
            into.append((name, float(value)))
            timing.count(name, value)
        return count

    monkeypatch.setattr(integrator, "count", spy(calls))
    monkeypatch.setattr(ray_sort, "count", spy(sort_calls))
    r = renderer(scene, kind)
    with timing.tracing():
        r.step()
    assert calls
    assert bool(sort_calls) == r.settings.sort_bounce_rays
    live = {}
    for name, v in calls:
        kind_, what = name.rsplit(".", 1)
        if what == "live":
            live[kind_] = v
        else:
            assert 0 <= live.pop(kind_) <= v, name
    assert not live
    want = collections.Counter()
    for name, v in calls + sort_calls:
        want[name] += v
    # the integrator's and the ray sort's counters, and the renderer's
    # own: a first frame starts its accumulation from zero
    counts = dict(r.last_counts)
    assert counts.pop("renderer.restarts") == 1
    assert dict(want) == pytest.approx(counts)


def _run_frames(scene, kind, on, monkeypatch):
    states = []

    for name in ("path_trace", "trace_direct"):
        fn = getattr(renderer_mod, name)

        def keep(*a, _fn=fn, **k):
            res = _fn(*a, **k)
            states.append(res.state.clone())
            return res

        monkeypatch.setattr(renderer_mod, name, keep)
    r = renderer(scene, kind)
    rays = []
    with timing.tracing(on):
        for _ in range(2):
            r.step()
            rays.append(r.last_rays)
    monkeypatch.undo()
    return r, rays, states


def _bits(x):
    return (x.contiguous().view(torch.int32) if x.is_floating_point()
            else x)


@pytest.mark.parametrize("kind", list(KINDS))
def test_tracing_changes_no_result(scene, kind, monkeypatch):
    a, rays_a, st_a = _run_frames(scene, kind, False, monkeypatch)
    b, rays_b, st_b = _run_frames(scene, kind, True, monkeypatch)
    assert rays_a == rays_b
    for f in dataclasses.fields(FrameBuffers):
        assert torch.equal(_bits(getattr(a.buffers, f.name)),
                           _bits(getattr(b.buffers, f.name))), f.name
    assert len(st_a) == len(st_b) > 0
    assert all(torch.equal(x, y) for x, y in zip(st_a, st_b))
    assert a._rng.bit_generator.state == b._rng.bit_generator.state
    assert a.last_counts == {} and b.last_counts


def test_gc_inside_a_traced_frame_is_a_span(scene, monkeypatch):
    fn = renderer_mod.path_trace

    def collecting(*a, **k):
        gc.collect()
        return fn(*a, **k)

    monkeypatch.setattr(renderer_mod, "path_trace", collecting)
    r = renderer(scene, "path")
    with timing.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        assert timing._gc_span in gc.callbacks
        r.step()
    assert timing._gc_span not in gc.callbacks and not timing._gc_open
    ev = wrt_events(p)
    (frame,) = [e for e in ev if e.name == "wrt.frame"]
    spans = [e for e in ev if e.name == "wrt.gc"]
    assert len(spans) >= 2  # one collection a sample
    assert all(inside(e, frame) for e in spans)


def test_read_counts_sums_host_and_device_values():
    total = torch.tensor(7.0)
    assert timing.read_counts(total) == (7.0, {})
    with timing.tracing():
        timing.count("a", torch.tensor(2.0))
        timing.count("a", 3)
        timing.count("b", torch.tensor(1.5))
        assert timing.read_counts(total) == (7.0, {"a": 5.0, "b": 1.5})
        assert timing._counts == {}
        with timing.tracing(False):
            timing.count("a", 1)
            assert timing._counts == {}
        timing.count("a", 1)
    assert timing._counts == {}  # switching drops what was kept


def test_cli_render_profile_shows_the_spans(tmp_path):
    trace_dir, metrics = tmp_path / "prof", tmp_path / "m.jsonl"
    cli.main(["render", "--scene", "analytic", "--size", "16x16", "--spp",
              "2", "--bounces", "2", "--seed", "3", "--device", "cpu",
              "--profile", str(trace_dir), "--metrics", str(metrics),
              "-o", str(tmp_path / "a.png")])
    names = {e.get("name") for e in
             json.loads((trace_dir / "trace.json").read_text())[
                 "traceEvents"]}
    assert {"wrt.frame", "wrt.raygen", "wrt.shade", "wrt.trace",
            "wrt.trace.prep", "wrt.trace.rederive"} <= names
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert rows and all(
        x["last_counts"]["trace.closest.live"] == x["rays"] for x in rows)
    assert not timing._on


@pytest.mark.parametrize("kind", ["nee", "envis"])
def test_the_span_table_of_a_traced_frame(scene, kind):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_torch", "spans.py")
    spec = importlib.util.spec_from_file_location("bench_spans", path)
    spans = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(spans)

    r = renderer(scene, kind)
    with timing.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        r.step()
    cpu, ops, launch_at = spans.device_view(p.events())
    assert ops == []  # no device here
    t = spans.span_table(cpu, ops, launch_at, frames=1)
    own = {"nee": {"wrt.light"}, "envis": set()}[kind]
    assert set(t) == {"wrt.frame", "wrt.raygen", "wrt.shade", "wrt.trace",
                      "wrt.trace.prep", "wrt.trace.rederive",
                      "wrt.env"} | own
    frame = t["wrt.frame"]["host_us"]
    assert 0 < t["wrt.shade"]["host_us"] + t["wrt.raygen"]["host_us"] < frame
    assert t["wrt.trace"]["host_us"] < t["wrt.shade"]["host_us"]
    for name in ("wrt.env",) + tuple(own):
        assert 0 < t[name]["host_us"] < t["wrt.shade"]["host_us"], name
    assert all(row["incl_launches"] == 0 for row in t.values())
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r.step()
    assert spans.span_table(*spans.device_view(p.events()), 1) == {}
