"""PyTorch port: BASELINE config #4 as the benchmark runs it (bench_torch/),
on the CPU at 32x16.

``orbit44k_256.path``: the main path's 44,556-face stress scene seen from
``cli orbit``'s scripted orbit (4 poses about (0, 1, -6), 512 frames a
pose at 2 spp a frame, 1024 spp a pose), path integrator, procedural sky;
before each frame whose pose changes the harness sets the camera and
calls ``reset()``, as ``cli orbit`` does.

``bench_torch/run.run`` renders the cell's own files through the port's
``Renderer`` and compares one frame with the plain reference
(bench_torch/reference.py): a sound run is correct at two seeds; the
control (the reference in bfloat16 in the program's place) and colours
1 % off where the integrator produces them are not. With a move before
every frame (the cell's path at one frame a pose), a sound run is
correct and one whose move does not reset fails ``accum_px``. A traced
frame that follows a move counts one ``renderer.restarts``; a frame
that does not, none.
"""

import argparse
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import calibrate  # noqa: E402
import compare  # noqa: E402
import run  # noqa: E402

CELL = "orbit44k_256.path"
SMALL = (32, 16)
SEED = 2**31 + 1013


def _spec(per_pose=None):
    """The cell's files; ``per_pose`` sets its frames a pose in memory."""
    spec = run.cell_spec(CELL)
    if per_pose is not None:
        spec = copy.deepcopy(spec)
        spec["config"]["camera_path"]["frames_per_pose"] = per_pose
    return spec


def _altered(fn):
    """The integrator's colours 1 % off."""
    def integrate(*a, **k):
        res = fn(*a, **k)
        return res._replace(color=res.color * 1.01)
    return integrate


def _run(spec, seed=SEED):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5,
                              trace=0)
    return run.run(args, "cpu", spec, size=SMALL, out=lambda s: None)


def test_the_cell_is_config4():
    config = _spec()["config"]
    assert config["camera_path"] == {
        "center": [0.0, 1.0, -6.0], "radius": 6.0, "height": 1.0,
        "poses": 4, "frames_per_pose": 512}
    st = run.settings_of(_spec())
    assert (st["width"], st["height"]) == (256, 256)
    assert (1 + st["sample_count"]) * 512 == 1024
    assert st["bounces_depth"] == 4 and st["environment"] == "procedural"
    assert st["projection_type"] == "panini" and config["reduced"] == []
    assert run.program_settings(st).reprojection_rate == 0


@pytest.mark.parametrize("case, seed", [
    ("sound", SEED), ("sound", 7), ("control", SEED), ("altered", SEED),
])
def test_the_cell_is_correct_and_its_faults_are_not(case, seed,
                                                    monkeypatch):
    spec = _spec()
    limits = spec["limits"]["limits"]
    if case == "control":
        numbers = calibrate.control(spec, seed, "cpu", SMALL)
        assert not compare.verdict(numbers, limits), numbers
        return
    if case == "altered":
        import webgpu_raytracing_tpu_torch.renderer as rmod

        for name in run.INTEGRATORS:
            monkeypatch.setattr(rmod, name, _altered(getattr(rmod, name)))
    res = _run(spec, seed)
    assert res["correct"] == (case == "sound"), res["compared"]
    assert res["attempted"] >= 1
    assert res["metrics"]["mrays_per_s"]["value"] > 0
    assert res["metrics"]["frame_ms_p95"]["value"] > 0


@pytest.mark.parametrize("reset", [True, False])
def test_a_move_before_every_frame(reset, monkeypatch):
    """The compared frame follows a move: it starts from zero, and a move
    that does not reset is caught by ``accum_px``."""
    if not reset:
        import webgpu_raytracing_tpu_torch.renderer as rmod

        monkeypatch.setattr(rmod.Renderer, "reset", lambda self: None)
    res = _run(_spec(per_pose=1))
    assert res["correct"] == reset, res["compared"]
    if not reset:
        number = res["compared"]["accum_px"]
        assert number["value"] > number["limit"], res["compared"]


@pytest.mark.parametrize("moved", [True, False])
def test_a_traced_frame_counts_its_restart(moved):
    """Frames 0, 1 and 2 of the cell's path at two frames a pose: frame 2
    follows a move, frame 1 does not."""
    import webgpu_raytracing_tpu_torch.renderer as rmod
    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.utils import timing

    from motion import CameraPath

    spec = _spec(per_pose=2)
    st = run.settings_of(spec)
    st["width"], st["height"] = SMALL
    path = CameraPath(spec["config"])
    renderer = rmod.Renderer(
        run.program_scene(run.generate_scene(spec, SEED)),
        run.program_settings(st), camera=Camera(*path.pose(0)),
        base_seed=SEED, device="cpu")
    drive = run.Drive(renderer, path, Camera)
    last = 2 if moved else 1
    with timing.tracing():
        for _ in range(last + 1):
            drive.step()
    assert path.moves_before(last) == moved
    counts = renderer.last_counts
    assert counts["trace.closest.lanes"] > 0  # a traced frame
    if moved:
        assert counts["renderer.restarts"] == 1, counts
    else:
        assert "renderer.restarts" not in counts, counts
