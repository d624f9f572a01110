"""PyTorch port: the CLI and the metrics sink (counterparts of
tests/test_frontend.py), on the CPU (``--device cpu``).

The port's PNGs are held against the JAX CLI's on the same arguments
(within 1/255 per channel: the frames agree to ~1e-8, and an 8-bit
rounding may land on either side); the port's own repeated runs are
equal byte for byte."""

import json
import os

import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu.frontend import cli as jcli
from webgpu_raytracing_tpu_torch.frontend import cli
from webgpu_raytracing_tpu_torch.utils.image import read_image, rmse
from webgpu_raytracing_tpu_torch.utils.timing import FrameMetrics

torch.set_num_threads(1)

TINY = ["--scene", "analytic", "--size", "16x16", "--spp", "2",
        "--bounces", "2", "--projection", "perspective", "--seed", "3"]


def test_frame_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = FrameMetrics(path=path, smoothing=0.5)
    r1 = m.record(0.1, 1000.0, 2)
    r2 = m.record(0.2, 1000.0, 4)
    m.close()
    assert r1["frame"] == 1 and r2["frame"] == 2
    assert abs(r2["smoothed_ms"] - (0.5 * 100 + 0.5 * 200)) < 1e-6
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    assert len(rows) == 2
    assert rows[1]["mrays_per_s"] == pytest.approx(0.005, rel=1e-3)


def test_cli_render_and_compare_match_jax(tmp_path, capsys):
    """render on the analytic scene: two port runs equal byte for byte,
    the JAX CLI's PNG within 1/255 per channel; compare prints RMSE 0."""
    a, b, j = (str(tmp_path / f"{n}.png") for n in "abj")
    metrics = str(tmp_path / "m.jsonl")
    cli.main(["render", *TINY, "--device", "cpu", "--metrics", metrics,
              "-o", a])
    cli.main(["render", *TINY, "--device", "cpu", "-o", b])
    jcli.main(["render", *TINY, "-o", j])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with open(metrics) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["spp"] for r in rows] == [2] and rows[0]["rays"] > 0
    capsys.readouterr()
    cli.main(["compare", a, b])
    out = json.loads(capsys.readouterr().out)
    assert out["rmse"] == 0.0 and out["within_1e-2"] is True
    pa, pj = read_image(a), read_image(j)
    assert pa.shape == pj.shape == (16, 16, 3)
    assert np.abs(pa - pj).max() <= 1.0 / 255 + 1e-7
    assert rmse(pa, pj) <= 1e-2
    with pytest.raises(SystemExit, match="shape mismatch"):
        cli.main(["render", *TINY[:3], "8x8", *TINY[4:], "--device", "cpu",
                  "-o", b])
        cli.main(["compare", a, b])


def test_cli_missing_assets_message():
    with pytest.raises(SystemExit, match="scene assets not found"):
        cli.main([
            "render", "--obj", "/nonexistent.obj", "--mtl",
            "/nonexistent.mtl", "--size", "8x8", "--spp", "1",
            "--device", "cpu",
        ])


def test_cli_cuda_without_a_card_exits(monkeypatch):
    """--device cuda (the default) with no visible card is an error that
    names the card, never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["render", *TINY], ["bench", *TINY, "--device", "cuda"]):
        with pytest.raises(SystemExit, match="no CUDA card"):
            cli.main(argv)


@pytest.mark.parametrize("opt", ["mm_passes=3", "trace_gang=8"])
def test_cli_omitted_field_exits(opt):
    with pytest.raises(SystemExit, match=opt.split("=")[0]):
        cli.main(["render", *TINY, "--device", "cpu", "--opt", opt])


def test_cli_opt_overrides(tmp_path):
    out = str(tmp_path / "o.png")
    cli.main(["render", *TINY, "--device", "cpu", "--opt", "kernel_near=0",
              "--opt", "use_hit_predictor=true", "--opt",
              "resolution_scale=0.5", "-o", out])
    assert read_image(out).shape == (16, 16, 3)
    with pytest.raises(SystemExit, match="unknown field"):
        cli.main(["render", *TINY, "--device", "cpu", "--opt", "nope=1"])


def test_cli_profile_writes_a_chrome_trace(tmp_path):
    prof = str(tmp_path / "prof")
    cli.main(["render", *TINY[:3], "8x8", "--spp", "2", "--bounces", "2",
              "--device", "cpu", "--profile", prof,
              "-o", str(tmp_path / "p.png")])
    with open(os.path.join(prof, "trace.json")) as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_cli_config_presets(n, monkeypatch, capsys):
    """The milestone presets: JAX's argv plus the device; captured, not
    rendered."""
    seen = {}
    monkeypatch.setattr(cli, "main", lambda argv: seen.setdefault("t", argv))
    monkeypatch.setattr(jcli, "main", lambda argv: seen.setdefault("j", argv))
    extra = ["--spp", "3", "-o", "x.png"]
    for mod, key in ((cli, "t"), (jcli, "j")):
        args = mod.build_parser().parse_args(
            ["config", str(n), *extra]
            + (["--device", "cpu"] if mod is cli else [])
        )
        args.fn(args)
    assert seen["t"] == seen["j"] + ["--device", "cpu"]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed[0] == {"config": n, "argv": seen["t"]}
    assert "3" in seen["t"]


def test_cli_orbit(tmp_path):
    out = str(tmp_path / "orbit")
    cli.main(["orbit", *TINY[:3], "8x8", "--spp", "2", "--bounces", "2",
              "--frames", "2", "--device", "cpu", "-o", out])
    files = sorted(os.listdir(out))
    assert files == ["orbit_000.png", "orbit_001.png"]
    a, b = (read_image(os.path.join(out, f)) for f in files)
    assert a.shape == (8, 8, 3) and not np.array_equal(a, b)


def test_cli_checkpoint_resume_bit_identical(tmp_path):
    """Stopped after 2 frames and resumed to 4: the same PNG and buffers as
    a run that was never stopped (the checkpoint holds the host RNG)."""
    ck = str(tmp_path / "ck.npz")
    ref_ck = str(tmp_path / "ref.npz")
    base = [*TINY[:4], "--bounces", "2", "--device", "cpu", "--seed", "7"]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    cli.main(["render", *base, "--spp", "8", "--checkpoint", ref_ck,
              "-o", a])
    cli.main(["render", *base, "--spp", "4", "--checkpoint", ck, "-o", b])
    cli.main(["render", *base, "--spp", "8", "--resume", ck, "--checkpoint",
              ck, "-o", b])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    za, zb = np.load(ref_ck), np.load(ck)
    assert int(za["counter"]) == int(zb["counter"]) == 4
    for k in ("image", "geo_face", "prev_image", "rng_state"):
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_cli_bench_keys(capsys):
    cli.main(["bench", *TINY[:3], "8x8", "--bounces", "2", "--frames", "2",
              "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"metric", "value", "unit", "frames", "spp",
                        "wall_s_per_frame", "device"}
    assert row["metric"] == "Mrays/sec @8x8" and row["unit"] == "Mrays/s"
    assert row["frames"] == 2 and row["spp"] == 4
    assert row["device"] == "cpu" and row["value"] > 0
