"""PyTorch port: BASELINE config #5 with the ray sort and live slice on,
the benchmark's ``stress1m_4k.sorted`` cell, on the CPU.

``bench_torch/run.run`` renders the cell's own files (the 1M-triangle
scene in 8 slabs) at 128x32: slabs of 512 rays, so that each sorted leg
is cut to a slice of 384 (segment 1) or 256 (later segments) rows. At
32x16 a slab's 64 rays are never cut. Each point is one case:

* ``sound``: a sound run is correct;
* ``control``: the reference in bfloat16 in the program's place is not;
* ``altered``: colours 1 % off where the integrator makes them are not;
* ``as_path``: the compared frame's per-sample colours and ray count
  equal those of ``stress1m_4k.path`` at the same seed and size, bit for
  bit (the sort only reorders rays);
* ``counters``: every closest-hit leg past a sample's first segment is a
  sorted leg, with one count read, and sliced legs trace fewer rows than
  they have;
* ``overflow``: a leg whose live rays are made to overflow its slice
  traces the full width, counts one ``trace.sort.full_width``, and gives
  the sliced leg's and the unsorted leg's bits;
* ``key_span``: in a traced frame the key's launch lies inside
  ``wrt.trace.sort.key``, inside ``wrt.trace.sort``, and never goes
  through ``cluster_cuda._run`` or its ``wrt.trace.kernel``.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from webgpu_raytracing_tpu_torch.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort
from webgpu_raytracing_tpu_torch.renderer import Renderer
from webgpu_raytracing_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import calibrate  # noqa: E402
import compare  # noqa: E402
import run  # noqa: E402

CELL = "stress1m_4k.sorted"
SIZE = (128, 32)  # 8 slabs of 4 rows: sorted legs of 512 rays, sliced
SMALL = (32, 16)  # the faults need no slice
SEED = 2**31 + 1013


def _cell_run(cell, size):
    """One run of ``cell`` on the CPU at ``size`` with the port's tracing
    on → (result, the compared frame's per-sample colours and ray count,
    each frame's counters)."""
    seen, counts = [], []
    add, step = compare.Tally.add, Renderer.step

    def tally_add(self, prog_colors, ref_colors, prog_rays, *a, **k):
        seen.append(([c.clone() for c in prog_colors], prog_rays))
        return add(self, prog_colors, ref_colors, prog_rays, *a, **k)

    def traced_step(self, *a, **k):
        with timing.tracing():
            out = step(self, *a, **k)
        counts.append(dict(self.last_counts))
        return out

    args = argparse.Namespace(workload=cell, seed=SEED, seconds=0.5,
                              trace=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compare.Tally, "add", tally_add)
        mp.setattr(Renderer, "step", traced_step)
        res = run.run(args, "cpu", run.cell_spec(cell), size=size,
                      out=lambda s: None)
    (compared,) = seen
    return res, compared, counts


@pytest.fixture(scope="module")
def sorted_run():
    return _cell_run(CELL, SIZE)


def _altered(fn):
    """The integrator's colours 1 % off."""
    def integrate(*a, **k):
        res = fn(*a, **k)
        return res._replace(color=res.color * 1.01)
    return integrate


def _scene():
    """A light, a sphere, a cube and the floor."""
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


def _bits(hit):
    return [x.contiguous().view(torch.int32) for x in hit]


def _leg_counts(fn):
    with timing.tracing():
        out = fn()
        return out, timing.read_counts(torch.zeros(()))[1]


def _check_sound(request):
    res, _, _ = request.getfixturevalue("sorted_run")
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1
    assert res["metrics"]["mrays_per_s"]["value"] > 0


def _check_control(request):
    spec = run.cell_spec(CELL)
    numbers = calibrate.control(spec, SEED, "cpu", SIZE)
    assert not compare.verdict(numbers, spec["limits"]["limits"]), numbers


def _check_altered(request):
    import webgpu_raytracing_tpu_torch.renderer as rmod

    mp = request.getfixturevalue("monkeypatch")
    for name in run.INTEGRATORS:
        mp.setattr(rmod, name, _altered(getattr(rmod, name)))
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.5,
                              trace=0)
    res = run.run(args, "cpu", run.cell_spec(CELL), size=SMALL,
                  out=lambda s: None)
    assert not res["correct"], res["compared"]


def _check_as_path(request):
    _, (colors, rays), _ = request.getfixturevalue("sorted_run")
    _, (want, want_rays), counts = _cell_run("stress1m_4k.path", SIZE)
    assert not any("trace.sort.legs" in c for c in counts)
    assert len(colors) == len(want) == 2
    for got, w in zip(colors, want):
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))
    assert rays == want_rays


def _check_counters(request):
    _, _, counts = request.getfixturevalue("sorted_run")
    st = run.settings_of(run.cell_spec(CELL))
    slabs = st["frame_slabs"]
    legs = slabs * (1 + st["sample_count"]) * (st["bounces_depth"] - 2)
    per_leg = SIZE[0] * SIZE[1] // slabs
    assert len(counts) >= 3  # the warm-up frames and the window's
    for c in counts:
        assert c["trace.sort.legs"] == legs == 32
        assert c["trace.sort.rays"] == legs * per_leg
        assert c["trace.sort.count_reads"] == legs
        full = c.get("trace.sort.full_width", 0)
        assert 0 <= full < legs
        # segment 1 cut to 384 rows, segment 2 to 256, unless overflowed
        sliced = legs // 2 * (384 + 256)
        assert c["trace.sort.traced"] <= sliced + full * 256
        assert c["trace.sort.traced"] < c["trace.sort.rays"]


def _leg():
    """A bounce leg of 512 rays over two-level tables, three in five of
    its lanes dead, so that the live rays fit a slice of 256."""
    tables = _scene().tables("cpu", cluster_size=16, group_size=4)
    g = np.random.default_rng(31)
    r = 512
    o = g.uniform(-2.5, 2.5, (r, 3)).astype(np.float32)
    o[:, 2] -= 4.0
    d = g.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = g.uniform(size=r) > 0.6
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.full((r,), F32_MAX), tables, torch.from_numpy(active))


def _check_overflow(request):
    o, d, t_max, tables, active = _leg()
    st = RenderSettings(width=32, height=16, sort_bounce_rays=True,
                        live_slice=True)

    def leg(settings):
        return integrator.trace_closest(o, d, t_max, tables, settings,
                                        active, sort=True, seg=2)

    want = _bits(leg(st.replace(sort_bounce_rays=False)))
    sliced, c = _leg_counts(lambda: leg(st))
    assert c == {"trace.sort.legs": 1, "trace.sort.rays": 512,
                 "trace.sort.count_reads": 1, "trace.sort.traced": 256}
    mp = request.getfixturevalue("monkeypatch")
    mp.setattr(ray_sort, "live_count", lambda key_s, n: key_s.shape[0])
    full, c = _leg_counts(lambda: leg(st))
    assert c == {"trace.sort.legs": 1, "trace.sort.rays": 512,
                 "trace.sort.count_reads": 1, "trace.sort.full_width": 1,
                 "trace.sort.traced": 512}
    for got in (sliced, full):
        for g, w in zip(_bits(got), want):
            assert torch.equal(g, w)


def _check_key_span(request):
    """The key's launch function runs beside its twin (the launch itself
    is a stand-in that only marks where it was called), in a traced 64x32
    frame of two-level tables."""
    mp = request.getfixturevalue("monkeypatch")
    via_run, launched = [], []

    def fake_launch(label, entry, dev, *args):
        with record_function("probe." + entry):
            launched.append(entry)

    def twin_and_launch(o, inv_d, t_max, boxes, n, t_start=None, **kw):
        cc._launch_top_keys(o, inv_d, t_max, boxes, n, t_start=t_start)
        return real(o, inv_d, t_max, boxes, n, t_start=t_start, **kw)

    real = cc.top_keys_tiles.twin
    mp.setattr(cc, "launch", fake_launch)
    mp.setattr(cc, "_run", lambda entry, dev, args: via_run.append(entry))
    mp.setattr(cc.top_keys_tiles, "twin", twin_and_launch)
    st = RenderSettings(width=64, height=32, bounces_depth=4,
                        sample_count=1, sort_bounce_rays=True)
    r = Renderer(_scene(), st, base_seed=9, device="cpu")
    r.tables = _scene().tables("cpu", cluster_size=16, group_size=4)
    with timing.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        r.step()
        legs = r.last_counts["trace.sort.legs"]
    ev = [e for e in p.events()
          if e.name.startswith(("wrt.", "probe."))]
    by = {}
    for e in ev:
        by.setdefault(e.name, []).append(e)

    def inside(e, name):
        return any(s.time_range.start <= e.time_range.start
                   and e.time_range.end <= s.time_range.end
                   for s in by.get(name, []))

    assert launched == ["wrt_top_keys"] * legs and legs == 4
    assert via_run == []
    assert len(by["wrt.trace.sort.key"]) == legs
    for e in by["probe.wrt_top_keys"]:
        assert inside(e, "wrt.trace.sort.key")
        assert not inside(e, "wrt.trace.kernel")
    for e in by["wrt.trace.sort.key"]:
        assert inside(e, "wrt.trace.sort")


CHECKS = {
    "sound": _check_sound, "control": _check_control,
    "altered": _check_altered, "as_path": _check_as_path,
    "counters": _check_counters, "overflow": _check_overflow,
    "key_span": _check_key_span,
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_the_sorted_cell(case, request):
    CHECKS[case](request)
