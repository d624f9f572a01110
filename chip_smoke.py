"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 8] [--seed 0]

Phases (any failure exits non-zero; nothing is caught to carry on):

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
   fails when no CUDA device is visible. TF32 is switched off.
2. build: compiles the closest-hit kernel (csrc/cluster_trace.cu) from the
   checkout into build/kernels/.
3. kernel vs twin: on the 1080p primary rays of frame 0 and the first
   bounce set (with source-face exclusion codes) of ``stress_scene(44_556)``,
   the CUDA kernel and its plain-torch twin run on the same device tensors;
   face ids must agree on all but 1e-5 of the rays. Both are timed with
   CUDA events.
4. main path: ``Renderer`` at 1920x1080 with the default path settings and
   the procedural sky renders a warm-up frame and ``--frames`` timed frames
   on the card; the image must be finite, every pixel must hold 2 samples
   per frame, the kernel must have been launched 6 times per frame.
5. reference: the 32x32 mini scene rendered on the card must reproduce the
   JAX package's golden accumulation buffer (tests/golden/mini_scene_2f.npz)
   with RMSE < 1e-5.

Prints the per-kernel JSON line, then the ``nvidia-smi`` name/power line,
then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# face-id disagreement allowed between the kernel and its twin (per ray)
MISMATCH_LIMIT = 1e-5
SLICE = dict(
    width=1920, height=1080, sample_count=1, bounces_depth=4,
    environment="procedural",
)
N_TRIANGLES = 44_556


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def phase_environment(torch) -> str:
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from webgpu_raytracing_tpu_torch.ops._build import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    card = smi()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN", flush=True)
    return card


def phase_build():
    from webgpu_raytracing_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(so)}", flush=True)


def _time_cuda(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare_leg(torch, name, args, card):
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    n_rays = args["o"].shape[0]
    before = cc.trace_closest_tiles.launches
    t_k, code_k = cc.trace_closest_tiles(**args)
    torch.cuda.synchronize()
    if cc.trace_closest_tiles.launches != before + 1:
        fail(f"{name}: kernel launch was not counted")
    t_w, code_w = cc._trace_closest_torch(**args)
    torch.cuda.synchronize()
    bad = torch.nonzero(code_k != code_w).flatten()
    mismatch = int(bad.numel())
    for i in bad[:10].tolist():
        print(f"{name}: ray {i}: kernel code {int(code_k[i])} t "
              f"{float(t_k[i])!r}, twin code {int(code_w[i])} t "
              f"{float(t_w[i])!r}", flush=True)
    both = (code_k == code_w) & (code_k >= 0)
    max_abs = float((t_k[both] - t_w[both]).abs().max()) if bool(
        both.any()) else 0.0
    hits = int((code_k >= 0).sum())
    ms_k = _time_cuda(torch, lambda: cc.trace_closest_tiles(**args), 5)
    ms_w = _time_cuda(torch, lambda: cc._trace_closest_torch(**args), 1)
    print(f"{name}: {n_rays} rays, {hits} hits, face mismatches "
          f"{mismatch}, max |t_kernel - t_twin| {max_abs:g}; kernel "
          f"{ms_k:.3f} ms, twin {ms_w:.3f} ms ({card})", flush=True)
    if mismatch > MISMATCH_LIMIT * n_rays:
        fail(f"{name}: {mismatch} face mismatches > {MISMATCH_LIMIT:g} "
             "of the rays")
    if max_abs != 0.0:
        fail(f"{name}: kernel and twin t differ where faces agree")
    return dict(n=n_rays, mismatch=mismatch, max_abs=max_abs, ms=ms_k,
                plain_ms=ms_w)


def phase_kernel_vs_twin(torch, scene, seed, card):
    """Kernel vs twin on frame 0's primary rays and first bounce set, made
    exactly as Renderer.step / path_trace make them."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops import rng
    from webgpu_raytracing_tpu_torch.ops.cluster_cuda import (
        code_to_face, prepare_tiles, rederive_uv,
    )
    from webgpu_raytracing_tpu_torch.ops.integrator import (
        face_normal, face_point_offset,
    )
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    dev = torch.device("cuda")
    st = RenderSettings(**SLICE)
    tables = scene.tables(dev)
    w, h = st.render_width, st.render_height
    r = w * h
    frame_seed = int(
        np.random.default_rng(seed).integers(0, 2**32, dtype=np.uint64)
    )
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.int32, device=dev),
        torch.arange(w, dtype=torch.int32, device=dev), indexing="ij",
    )
    idx = (xs + ys * w).reshape(r)
    pos = torch.stack([xs, ys], -1).reshape(r, 2).to(torch.float32)
    view = torch.as_tensor(Camera().view_matrix(), device=dev)
    o, d, state = camera_rays(pos, view, rng.seed_state(frame_seed, idx), st)
    t_max = torch.full((r,), 3.4028234663852886e38, device=dev)
    legs = {}
    args = prepare_tiles(o, d, t_max, tables, tile=st.trace_tile)
    legs["primary"] = _compare_leg(torch, "primary", args, card)

    # first bounce set: path_trace's segment-0 epilogue on the kernel hits
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    t_k, code = cc.trace_closest_tiles(**args)
    face = code_to_face(code[:r], tables.clusters.face_id)
    hit = rederive_uv(o, d, t_k[:r], face, tables)
    h_mask = hit.face >= 0
    fi = hit.face.clamp(min=0).long()
    n = face_normal(tables.shade_normal[fi], hit.u, hit.v, st.shading_type)
    new_o = face_point_offset(tables.tri[fi], tables.shade_normal[fi],
                              hit.u, hit.v)
    excl = torch.where(h_mask, tables.clusters.partner_code[fi],
                       torch.full_like(hit.face, -1))
    t2, _ = rng.random_2(state)
    new_d = rng.sample_cosine_weighted_hemisphere(t2, n)
    args = prepare_tiles(new_o, new_d, t_max, tables, active=h_mask,
                         excl_code=excl, tile=st.trace_tile)
    legs["bounce"] = _compare_leg(torch, "bounce", args, card)
    return legs


def phase_main_path(torch, scene, seed, frames, card):
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    st = RenderSettings(**SLICE)
    t0 = time.perf_counter()
    r = Renderer(scene, st, base_seed=seed, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: tables on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    r.step()  # warm-up
    torch.cuda.synchronize()
    cc.trace_closest_tiles.launches = 0
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(frames):
        r.step()
        rays += r.last_rays
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = cc.trace_closest_tiles.launches
    img = r.buffers.image
    if not bool(torch.isfinite(img).all()):
        fail("main path: non-finite accumulation buffer")
    want = 2.0 * (frames + 1)
    if not bool((img[..., 3] == want).all()):
        fail(f"main path: sample counts differ from {want}")
    if launches != 6 * frames:
        fail(f"main path: {launches} kernel launches in {frames} frames, "
             f"expected {6 * frames}")
    if not r.last_rays > 0:
        fail("main path: no rays traced")
    disp = r.image()
    if disp.shape != (st.height, st.width, 3):
        fail(f"main path: display image shape {disp.shape}")
    ms = dt / frames * 1e3
    mrays = rays / dt / 1e6
    print(f"main path: {frames} frames of {st.width}x{st.height}, "
          f"{ms:.1f} ms/frame, {mrays:.3f} Mrays/s "
          f"({rays / frames:.0f} rays/frame), {launches} kernel launches "
          f"({card})", flush=True)
    return dict(launches=launches, ms_per_frame=ms, mrays=mrays)


def phase_reference(torch):
    import numpy as np

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
    from webgpu_raytracing_tpu_torch.models.test_models import (
        ground_plane, uv_sphere,
    )
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
        "mini_scene_2f.npz",
    )
    scene = scene_from_facesets(
        [
            ("light", uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                lon=6)),
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )
    st = RenderSettings(width=32, height=32, bounces_depth=3,
                        sample_count=1, environment="procedural")
    r = Renderer(scene, st, base_seed=77, device="cuda")
    r.step()
    r.step()
    got = r.buffers.image.cpu().numpy()
    golden = np.load(golden_path)["image"]
    rmse = float(np.sqrt(np.mean((got - golden) ** 2)))
    print(f"reference: mini scene on the card vs JAX golden, RMSE {rmse:.3g}",
          flush=True)
    if not rmse < 1e-5:
        fail(f"reference: RMSE {rmse} >= 1e-5")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()

    import torch

    card = phase_environment(torch)
    phase_build()
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    t0 = time.perf_counter()
    scene = stress_scene(N_TRIANGLES)
    print(f"scene: stress_scene({N_TRIANGLES}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    legs = phase_kernel_vs_twin(torch, scene, a.seed, card)
    main_path = phase_main_path(torch, scene, a.seed, a.frames, card)
    phase_reference(torch)

    worst = max(legs.values(), key=lambda x: x["mismatch"])
    print(json.dumps({"kernels": [{
        "name": "trace_closest_clustered",
        "route": "cuda",
        "source": "webgpu_raytracing_tpu_torch/csrc/cluster_trace.cu",
        "replaces": "webgpu_raytracing_tpu/ops/cluster_pallas.py:1141",
        "launches": main_path["launches"],
        "max_abs_err": max(x["max_abs"] for x in legs.values()),
        "face_mismatches": worst["mismatch"],
        "ms": legs["bounce"]["ms"],
        "plain_ms": legs["bounce"]["plain_ms"],
        "legs": legs,
        "ms_per_frame": main_path["ms_per_frame"],
        "mrays_per_s": main_path["mrays"],
    }]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
