"""CPU tests of the port's benchmark (bench_torch/).

    python -m pytest bench_torch/tests -q

They check the manifest against the benchmark's contract, that every
cell's files resolve, that the copied generators give the port's faces,
the roofline count on a hand-made leg, that a new traffic file or a new
configuration becomes a cell with no file edited, that run.py refuses to
run without a CUDA device, and, on the CPU at small sizes, that a sound
run is correct and that the control and each fault a cell can have are
not. For a camera that moves (BASELINE config #4's scripted orbit) they
check the harness's orbit poses and frame draws against the port's, and
a configuration of that kind (``orbit_floor``, written here) with its
control and faults; that a run reports no result once JAX is loaded; and
that a configuration under temporal reprojection is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

import calibrate  # noqa: E402
import compare  # noqa: E402
import motion  # noqa: E402
import reference  # noqa: E402
import roofline  # noqa: E402
import run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = (32, 16)  # 8 slabs of 2 rows where a cell cuts its frame
SEED = 2**31 + 77


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cells():
    return [w["name"] for w in manifest()["workloads"]]


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench_torch"]
    assert 1 <= m["run_seconds"] <= 51
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_torch/")
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    metrics = m["end_to_end"] + m["per_layer"]
    for x in metrics:
        names.append(x["name"])
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
        assert "\n" not in x["layer"] and 1 <= len(x["layer"]) <= 200
    assert all(NAME.match(n) for n in names), names
    for group in (m["configs"], m["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}


@pytest.mark.parametrize("cell", cells())
def test_cell_files_resolve(cell):
    spec = run.cell_spec(cell)
    assert spec["limits"]["limits"]["accum_px"] == 0
    assert set(spec["limits"]["limits"]) == set(compare.NAMES)
    run.program_settings(run.settings_of(spec))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for gen in (spec["config"]["scene"], spec["traffic"].get("env")):
        if gen:
            assert os.path.exists(os.path.join(
                HERE, "scenes", gen["generator"] + ".py"))


def test_no_jax_and_the_reference_stands_alone():
    alone = re.compile(r"^\s*(import|from)\s+(jax|webgpu_raytracing_tpu)",
                       re.M)
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            src = open(os.path.join(dirpath, f)).read()
            assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), f
            assert not re.search(
                r"^\s*(import|from)\s+webgpu_raytracing_tpu\b(?!_torch)",
                src, re.M), f
            if f not in ("run.py", "calibrate.py", "test_bench.py"):
                assert not alone.search(src), f


def test_reference_defaults_are_the_programs():
    from webgpu_raytracing_tpu_torch.config import RenderSettings

    prog = run.program_settings(dict(reference.DEFAULTS))
    assert prog == RenderSettings()


def test_view_matrix_is_the_cameras():
    from webgpu_raytracing_tpu_torch.camera import Camera

    pos = np.array([0.5, -1.25, 3.0], np.float32)
    q = np.array([0.1, 0.7, -0.2, 0.5], np.float32)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    want = Camera(position=pos, orientation=q).view_matrix()
    assert np.array_equal(reference.view_matrix(pos, q), want)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_generators_give_the_programs_faces(seed):
    from webgpu_raytracing_tpu_torch.frontend.cli import analytic_scene
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    from scenes import analytic, stress
    from scenes._mesh import FIELDS

    for mine, theirs in ((stress.generate(7, 44_556, seed),
                          stress_scene(44_556, seed)),
                         (analytic.generate(seed), analytic_scene())):
        models, mat_color, mat_emission = mine
        assert np.array_equal(mat_color, theirs.mat_color)
        assert np.array_equal(mat_emission, theirs.mat_emission)
        assert [n for n, _ in models] == [m.name for m in theirs.models]
        for (_, f), m in zip(models, theirs.models):
            for k in FIELDS:
                assert np.array_equal(f[k], getattr(m.faces, k)), k


def test_roofline_counts_a_two_cluster_leg():
    # cluster 0: the unit box at the origin, 3 faces; cluster 1: a box at
    # x in [4, 5], 2 faces; cluster 2: behind the rays, 1 face
    box = torch.tensor([[0., 0., 0., 1., 1., 1.],
                        [4., 0., 0., 5., 1., 1.],
                        [-9., 0., 0., -8., 1., 1.]])
    face_id = torch.tensor([[0, 1, 2, -1], [3, 4, -1, -1], [5, -1, -1, -1]])
    o = torch.tensor([[-1., .5, .5], [-1., .5, .5], [-1., .5, .5],
                      [-1., 5., .5]])
    d = torch.tensor([[1., 0., 0.]] * 4)
    t_max = torch.full((4,), 100.)
    active = torch.tensor([True, True, False, True])
    # ray 0 hits in cluster 0 at t 1.5: meets box 0 only; ray 1 misses:
    # meets boxes 0 and 1; ray 2 is inactive; ray 3 meets nothing
    t = torch.tensor([1.5, 100., 100., 100.])
    face = torch.tensor([1, -1, -1, -1])
    w = roofline.leg_work(o, d, t_max, active, t, face, box, face_id)
    assert w["box_tests"] == 3 and w["slot_tests"] == 3 + 3 + 2
    assert w["hits"] == 1 and w["rays"] == 3
    assert w["ops"] == 25 * 3 + 15 * 8 + 35 * 1
    table = (24 + 4 * 4) * 2 + 36 * (3 + 2)
    assert w["bytes"] == 40 * 3 + table
    s, which = roofline.bound_s(w, roofline.PEAKS["H100"])
    assert which == "bytes" and s == pytest.approx(w["bytes"] / 3.35e12)


@pytest.mark.parametrize("seed", [0, 2**31 + 9])
def test_block_cull_finds_every_box_a_ray_meets(seed):
    g = torch.Generator().manual_seed(seed)
    lo = torch.rand((300, 3), generator=g) * 20 - 10
    box = torch.cat([lo, lo + torch.rand((300, 3), generator=g) * 3], 1)
    box[::37] = torch.tensor([1., 1., 1., -1., -1., -1.]) * 3e38  # pads
    o = torch.rand((500, 3), generator=g) * 24 - 12
    d = torch.nn.functional.normalize(torch.randn((500, 3), generator=g),
                                      dim=1)
    d[::50, 1:] = 0.0  # axis-aligned rays
    t_max = torch.rand((500,), generator=g) * 30
    active = torch.rand((500,), generator=g) < 0.9
    r, b = reference.box_pairs(o, d, t_max, active, box,
                               reference.blocks_of(box))
    inv = 1.0 / torch.where(d.abs() < 1e-12,
                            torch.where(d >= 0, 1e-12, -1e-12), d)
    flat = reference.meets(o, inv, t_max, box) & active[:, None]
    want = set(zip(*[x.tolist() for x in flat.nonzero(as_tuple=True)]))
    assert set(zip(r.tolist(), b.tolist())) == want and len(r) == len(want)
    assert len(want) > 100 and not (b % 37 == 0).any()


# a scene written into a checkout as a new generator for the
# configuration ``orbit_floor``
FLOOR_SCENE = """\
from __future__ import annotations

import numpy as np

from scenes._mesh import ground_plane, uv_sphere


def generate(seed: int):
    del seed
    models = [
        ("light", uv_sphere((0.5, 6.0, -6.5), 1.0, material_idx=0, lat=8,
                            lon=12)),
        ("sphere", uv_sphere((-0.7, 0.2, -6.3), 1.1, material_idx=1)),
        ("floor", ground_plane(-1.0, 20.0, material_idx=2)),
    ]
    return (models,
            np.array([[0, 0, 0], [0.8, 0.3, 0.3], [0.7, 0.7, 0.7]],
                     np.float32),
            np.array([[12, 12, 12], [0, 0, 0], [0, 0, 0]], np.float32))
"""
# config #4 as ``cli orbit`` flies it (cli.PRESETS[4]: the orbit about
# (0, 1, -6), radius 6, height 1, 4 poses, 1024 spp a pose at 2 spp a
# frame), with a pose every ``frames_per_pose`` frames
ORBIT_FLOOR = {
    "name": "orbit_floor",
    "source": "BASELINE.json configs #4: a scripted orbit, reset-on-move",
    "reduced": [],
    "scene": {"generator": "floor_scene", "args": {}},
    "camera_path": {"center": [0.0, 1.0, -6.0], "radius": 6.0,
                    "height": 1.0, "poses": 4, "frames_per_pose": 512},
    "settings": {"width": 256, "height": 256, "sample_count": 1,
                 "bounces_depth": 4},
}
LIMITS = {"bad_px_pct": 0.5, "rays_err_pct": 0.03, "accum_px": 0}


def new_cell(root, config, traffic, per_pose=None):
    """Copy the benchmark into ``root`` and add the cell ``config.traffic``
    with new files and entries alone: a traffic file where the mix is
    new, the configuration ``orbit_floor`` with its generator, the cell's
    limits and the manifest's entries; no file that was there changes.
    ``per_pose`` sets ``orbit_floor``'s frames a pose. → the cell's
    name."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(HERE, root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    mix = root / "bench_torch" / "traffic" / (traffic + ".json")
    if not mix.exists():
        mix.write_text(json.dumps(
            {"why": "a white environment",
             "settings": {"environment": "white"}, "env": None}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    if config == ORBIT_FLOOR["name"]:
        cfg = json.loads(json.dumps(ORBIT_FLOOR))
        if per_pose is not None:
            cfg["camera_path"]["frames_per_pose"] = per_pose
        (root / "bench_torch" / "scenes" / "floor_scene.py").write_text(
            FLOOR_SCENE)
        (root / "bench_torch" / "configs" / (config + ".json")).write_text(
            json.dumps(cfg))
        m["configs"].append(dict(
            name=config, source=ORBIT_FLOOR["source"], reduced=[],
            file=f"bench_torch/configs/{config}.json", why="a new config"))
    name = f"{config}.{traffic}"
    (root / "bench_torch" / "cells" / (name + ".json")).write_text(
        json.dumps({"limits": LIMITS}))
    m["workloads"].append(dict(name=name, config=config, traffic=traffic,
                               chips=1, why="a new cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data
    return name


@pytest.mark.parametrize("config,traffic", [
    ("analytic_256", "white"),  # a traffic file written here
    ("stress1m_4k", "nee"),  # mixes kept for the cells planned next
    ("stress1m_4k", "envis"),
    ("orbit_floor", "path"),  # a camera path: config #4's orbit
])
def test_a_new_cell_needs_new_files_and_entries_alone(tmp_path, config,
                                                      traffic):
    root = tmp_path / "checkout"
    root.mkdir()
    name = new_cell(root, config, traffic)
    spec = run.cell_spec(name, str(root))
    mix = json.loads((root / "bench_torch" / "traffic"
                      / (traffic + ".json")).read_text())
    assert all(run.settings_of(spec)[k] == v
               for k, v in mix["settings"].items())
    args = argparse.Namespace(workload=name, seed=SEED, seconds=0.5,
                              trace=0)
    res = run.run(args, "cpu", spec, size=SMALL, out=lambda s: None)
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == set(spec["limits"]["limits"])


def test_run_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no CUDA device" in proc.stderr


def cpu_run(cell, trace=0, seed=SEED):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5,
                              trace=trace)
    return run.run(args, "cpu", size=SMALL, out=lambda s: None)


@pytest.mark.parametrize("cell", cells())
def test_a_sound_run_is_correct(cell):
    res = cpu_run(cell)
    assert res["correct"], res["compared"]
    assert res["metrics"]["mrays_per_s"]["value"] > 0
    assert list(res)[-1] == "compared"


def test_a_traced_run_is_correct_and_reports_the_layers():
    res = cpu_run("analytic_256.direct", trace=1)
    assert res["correct"], res["compared"]
    assert "integrator.gpu_ms" in res["metrics"]
    assert "window_s" in res["device"] and "busy_s" in res["device"]


@pytest.mark.parametrize("cell", cells())
def test_the_control_is_not_correct(cell):
    limits = run.cell_spec(cell)["limits"]["limits"]
    numbers = calibrate.control(run.cell_spec(cell), SEED, "cpu", SMALL)
    assert not compare.verdict(numbers, limits), numbers


def _unchanged(fn):
    """A frame that returns the state it was given."""
    def frame(buffers, *a, **k):
        _, rays = fn(buffers, *a, **k)
        return buffers, rays
    return frame


def _half_batch(fn):
    """The integrator leaves out the second half of its lanes and gives
    them the mean colour of the rest."""
    def integrate(*a, **k):
        res = fn(*a, **k)
        n = res.color.shape[0] // 2
        color = res.color.clone()
        color[n:] = res.color[:n].nanmean(0)
        return res._replace(color=color)
    return integrate


def _altered(fn):
    """One answer altered where it is produced: the colours 1 % off."""
    def integrate(*a, **k):
        res = fn(*a, **k)
        return res._replace(color=res.color * 1.01)
    return integrate


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["stress1m_4k.path",
                                  "analytic_256.direct"])
def test_each_fault_is_not_correct(cell, fault, monkeypatch):
    import webgpu_raytracing_tpu_torch.renderer as rmod

    if fault == "unchanged":
        for name in ("render_frame", "render_frame_slabs"):
            monkeypatch.setattr(rmod, name, _unchanged(getattr(rmod, name)))
    else:
        make = _half_batch if fault == "half_batch" else _altered
        for name in run.INTEGRATORS:
            monkeypatch.setattr(rmod, name, make(getattr(rmod, name)))
    res = cpu_run(cell)
    assert not res["correct"], res["compared"]


# --- a camera that moves: config #4's scripted orbit -----------------------

@pytest.mark.parametrize("center,radius,height,poses,per_pose", [
    ([0.0, 1.0, -6.0], 6.0, 1.0, 4, 1),  # cli orbit's
    ([-1.25, 1.2, -1.25], 12.0, 4.0, 240, 2),
    ([0.3, -2.0, 5.0], 3, 0, 7, 3),  # level with the centre
])
def test_orbit_poses_are_the_ports(center, radius, height, poses, per_pose):
    from webgpu_raytracing_tpu_torch.camera import orbit_path

    want = list(orbit_path(np.array(center), radius, height, poses))
    path = motion.CameraPath({"camera_path": dict(
        center=center, radius=radius, height=height, poses=poses,
        frames_per_pose=per_pose)})
    for f in range(2 * poses * per_pose + 1):
        cam = want[(f // per_pose) % poses]
        position, orientation = path.pose(f)
        assert np.array_equal(position, cam.position)
        assert np.array_equal(orientation, cam.orientation)
        assert np.array_equal(path.view(f), cam.view_matrix())
        assert path.moves_before(f) == (f > 0 and f % per_pose == 0
                                        and poses > 1)


def test_drive_hands_each_frame_its_pose_and_draws(monkeypatch):
    """A CPU ``Renderer`` driven along a camera path renders each frame
    from the path's view, with the seed and jitter that ``frame_inputs``
    gives the reference, and from zero accumulation after each move."""
    import webgpu_raytracing_tpu_torch.renderer as rmod
    from webgpu_raytracing_tpu_torch.camera import Camera

    from scenes import analytic

    seen = []

    def record(fn):
        def frame(buffers, tables, env, inputs, settings):
            seen.append(inputs)
            return fn(buffers, tables, env, inputs, settings)
        return frame

    monkeypatch.setattr(rmod, "render_frame", record(rmod.render_frame))
    st = dict(reference.DEFAULTS, width=8, height=6, jitter_strength=0.75)
    path = motion.CameraPath(dict(ORBIT_FLOOR, camera_path=dict(
        ORBIT_FLOOR["camera_path"], frames_per_pose=3)))
    renderer = rmod.Renderer(
        run.program_scene(analytic.generate(0)), run.program_settings(st),
        camera=Camera(*path.pose(0)), base_seed=SEED, device="cpu")
    drive = run.Drive(renderer, path, Camera)
    for _ in range(10):
        drive.step()
    draws = run.frame_inputs(SEED, 10, 0.75)
    assert len(seen) == 10
    for f, (inputs, (seed, jitter)) in enumerate(zip(seen, draws)):
        assert inputs.seed == seed
        assert np.array_equal(inputs.jitter.numpy(), jitter)
        assert np.array_equal(inputs.view.numpy(), path.view(f))
        assert inputs.counter == f % 3


def test_a_configuration_under_reprojection_is_refused():
    config = dict(ORBIT_FLOOR, settings=dict(ORBIT_FLOOR["settings"],
                                             reprojection_rate=4))
    with pytest.raises(SystemExit, match="reprojection"):
        run.settings_of(dict(config=config, traffic={}))


@pytest.fixture(scope="module")
def orbit_cells(tmp_path_factory):
    """``orbit_floor`` with a new pose every frame ("moved": the compared
    frame follows a move) and every third frame ("still": it does not)."""
    out = {}
    for key, per_pose in (("moved", 1), ("still", 3)):
        root = tmp_path_factory.mktemp(key) / "checkout"
        root.mkdir()
        name = new_cell(root, "orbit_floor", "path", per_pose)
        out[key] = run.cell_spec(name, str(root))
    return out


def orbit_run(spec, seed=SEED):
    """A run whose compared frame is the third, the first window frame: a
    window shorter than a frame draws it whatever the machine's pace."""
    args = argparse.Namespace(workload="orbit_floor.path", seed=seed,
                              seconds=0.01, trace=0)
    return run.run(args, "cpu", spec, size=SMALL, out=lambda s: None)


@pytest.mark.parametrize("seed", [SEED, 7])
@pytest.mark.parametrize("key", ["moved", "still"])
def test_a_moving_run_is_correct(orbit_cells, key, seed):
    res = orbit_run(orbit_cells[key], seed)
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("key", ["moved", "still"])
def test_the_moving_control_is_not_correct(orbit_cells, key):
    spec = orbit_cells[key]
    numbers = calibrate.control(spec, SEED, "cpu", SMALL)
    assert not compare.verdict(numbers, spec["limits"]["limits"]), numbers


def _no_reset(monkeypatch, rmod):
    """A move does not restart the accumulation."""
    monkeypatch.setattr(rmod.Renderer, "reset", lambda self: None)


def _cleared(monkeypatch, rmod):
    """Every frame clears the accumulation, the camera moved or not."""
    fn = rmod.render_frame

    def frame(buffers, tables, env, inputs, settings):
        return fn(buffers, tables, env,
                  dataclasses.replace(inputs, counter=0), settings)
    monkeypatch.setattr(rmod, "render_frame", frame)


def _wrong_view(monkeypatch, rmod):
    """Each frame's rays leave from the last frame's view."""
    views = []
    fn = rmod.camera_rays

    def rays(pos, view, *a, **k):
        if not views or view is not views[-1]:
            views.append(view)
        return fn(pos, views[-2] if len(views) > 1 else view, *a, **k)
    monkeypatch.setattr(rmod, "camera_rays", rays)


@pytest.mark.parametrize("fault,key,fails", [
    (_no_reset, "moved", "accum_px"), (_cleared, "still", "accum_px"),
    (_wrong_view, "moved", "bad_px_pct"),
])
def test_each_moving_fault_is_not_correct(orbit_cells, fault, key, fails,
                                          monkeypatch):
    import webgpu_raytracing_tpu_torch.renderer as rmod

    fault(monkeypatch, rmod)
    res = orbit_run(orbit_cells[key])
    assert not res["correct"], res["compared"]
    number = res["compared"][fails]
    assert number["value"] > number["limit"], res["compared"]


# --- no result once JAX is loaded ------------------------------------------

@pytest.mark.parametrize("loaded", [None, "jax.numpy", "jaxlib", "flax",
                                    "webgpu_raytracing_tpu.renderer"])
def test_no_result_once_jax_is_loaded(loaded, monkeypatch, capsys):
    """``main`` drives a whole run (on the CPU here, its check for a card
    passed over) in which the module ``loaded`` is loaded: it prints no
    result, fails, and names the module on standard error. The port's own
    modules, whose name begins with the JAX package's, are no such
    module."""
    import types

    for name in run.jax_loaded():
        monkeypatch.delitem(sys.modules, name)
    real = run.run

    def on_cpu(args, device, spec, out=print, phases=None):
        if loaded:
            monkeypatch.setitem(sys.modules, loaded,
                                types.ModuleType(loaded))
        return real(args, "cpu", spec, size=SMALL, out=out, phases=phases)

    monkeypatch.setattr(run, "run", on_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    rc = run.main(["--workload", "analytic_256.direct", "--seed", str(SEED),
                   "--seconds", "0.3"])
    out, err = capsys.readouterr()
    assert "webgpu_raytracing_tpu_torch.renderer" in sys.modules
    last = out.strip().splitlines()[-1]
    if loaded is None:
        assert rc == 0 and json.loads(last)["correct"]
        assert err.strip().splitlines()[-1].startswith("accum_px")
    else:
        assert rc != 0 and not last.startswith("{")
        assert loaded in err.strip().splitlines()[-1]
