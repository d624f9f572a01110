"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 4] [--seed 0]

Phases (any failure exits non-zero; nothing is caught to carry on):

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
   fails when no CUDA device is visible. TF32 is switched off.
2. build: compiles both entries of the cluster trace kernel
   (``wrt_trace_closest``, ``wrt_trace_any``; csrc/cluster_trace.cu) from
   the checkout into build/kernels/.
3. kernels vs twins: on 1080p ray sets of ``stress_scene(44_556)`` made
   from frame 0 exactly as ``path_trace`` makes them, each CUDA entry and
   its plain-torch twin run on the same device tensors. Closest-hit: the
   primary rays and the first bounce set (with source-face exclusion
   codes). Any-hit: the NEE shadow set (light samples, t_max = distance
   to the light point) and the env-NEE set (``sample_env`` directions on
   a 1024x2048 equirect of the procedural sky, t_max = F32_MAX, active =
   hit & facing). Codes must agree on all but 1e-5 of the rays. Both are
   timed with CUDA events.
4. the 1080p paths through ``Renderer`` (one warm-up frame, then
   ``--frames`` timed frames; launch counts zeroed just before the timed
   frames and read just after):
   default (procedural sky): finite image, 6 closest-hit launches/frame;
   NEE: 6 closest-hit + 6 any-hit launches/frame, no +-inf pixel (the
   y = 0 floor's shading points are NaN by the reference's own offset
   rule, so its NEE pixels are NaN; their share is printed);
   env-IS on the synthesized equirect: 6 + 6 launches/frame, no +-inf,
   plus the time of ``sample_env`` on 2,073,600 lanes.
   Every pixel must hold 2 samples per frame.
5. direct integrator (config #1): the analytic spheres-and-plane scene at
   256x256, ``bounces_depth=1``, perspective: 2 + 2 launches per frame.
6. reference: the 32x32 mini scene on the card reproduces the JAX
   package's golden (tests/golden/mini_scene_2f.npz, RMSE < 1e-5); and for
   NEE, ``bounces_depth=1`` and env-IS, the frame on the card equals the
   port's frame on the CPU (the twins the tier-1 tests hold against JAX):
   equal NaN masks, RMSE < 1e-5 over the other pixels.

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

# code disagreement allowed between a kernel and its twin (per ray)
MISMATCH_LIMIT = 1e-5
F32_MAX = 3.4028234663852886e38
SLICE = dict(
    width=1920, height=1080, sample_count=1, bounces_depth=4,
    environment="procedural",
)
N_TRIANGLES = 44_556
SKY_SHAPE = (1024, 2048)  # the synthesized equirect of the env-IS path


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
    _build.load()  # binds wrt_trace_closest and wrt_trace_any, or raises
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


def sky_equirect(torch, h: int, w: int, dev):
    """An (h, w, 3) equirect of the port's procedural sky, sampled at each
    texel's centre direction (the inverse of ``equirect_uv``, as
    ``sample_env`` maps texels to directions)."""
    import math

    from webgpu_raytracing_tpu_torch.ops.envmap import procedural_sky

    theta = math.pi * (
        1.0 - (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
    )
    phi = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
    phi = phi * 2.0 * math.pi - math.pi
    st, ct = torch.sin(theta)[:, None], torch.cos(theta)[:, None]
    d = torch.stack(
        [st * torch.cos(phi)[None], ct.expand(h, w),
         st * torch.sin(phi)[None]], dim=-1,
    )
    return procedural_sky(d.reshape(-1, 3)).reshape(h, w, 3)


def _compare_leg(torch, name, args, card, any_hit=False):
    """One leg through the kernel entry and its twin on the same device
    tensors: codes must agree; closest-hit t must be bit-equal where they
    do."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    wrapper = cc.trace_any_tiles if any_hit else cc.trace_closest_tiles
    twin = cc._trace_any_torch if any_hit else cc._trace_closest_torch
    n_rays = args["o"].shape[0]
    live = int((args["t_max"] > 0).sum())
    before = wrapper.launches
    out_k = wrapper(**args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"{name}: kernel launch was not counted")
    out_w = twin(**args)
    torch.cuda.synchronize()
    code_k, code_w = (out_k, out_w) if any_hit else (out_k[1], out_w[1])
    bad = torch.nonzero(code_k != code_w).flatten()
    mismatch = int(bad.numel())
    flag_mismatch = int(((code_k >= 0) != (code_w >= 0)).sum())
    for i in bad[:10].tolist():
        extra = "" if any_hit else (
            f" t kernel {float(out_k[0][i])!r} twin {float(out_w[0][i])!r}")
        print(f"{name}: ray {i}: kernel code {int(code_k[i])}, twin code "
              f"{int(code_w[i])}{extra}", flush=True)
    if any_hit:
        max_abs = float(flag_mismatch > 0)  # |flag_kernel - flag_twin|
    else:
        both = (code_k == code_w) & (code_k >= 0)
        max_abs = float((out_k[0][both] - out_w[0][both]).abs().max()) if (
            bool(both.any())) else 0.0
    hits = int((code_k >= 0).sum())
    ms_k = _time_cuda(torch, lambda: wrapper(**args), 5)
    ms_w = _time_cuda(torch, lambda: twin(**args), 1)
    what = "blocked" if any_hit else "hits"
    print(f"{name}: {n_rays} rays ({live} live), {hits} {what}, code "
          f"mismatches {mismatch}, flag mismatches {flag_mismatch}, max abs "
          f"err {max_abs:g}; kernel {ms_k:.3f} ms, twin {ms_w:.3f} ms "
          f"({card})", flush=True)
    if max(mismatch, flag_mismatch) > MISMATCH_LIMIT * n_rays:
        fail(f"{name}: {mismatch} code mismatches > {MISMATCH_LIMIT:g} of "
             "the rays")
    if not any_hit and max_abs != 0.0:
        fail(f"{name}: kernel and twin t differ where faces agree")
    return dict(n=n_rays, live=live, hits=hits, mismatch=mismatch,
                flag_mismatch=flag_mismatch, max_abs=max_abs, ms=ms_k,
                plain_ms=ms_w)


def phase_kernel_vs_twin(torch, scene, sky, seed, card):
    """Kernels vs twins on frame 0's legs, made exactly as Renderer.step /
    path_trace make them."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops import detmath, rng
    from webgpu_raytracing_tpu_torch.ops.cluster_cuda import (
        code_to_face, prepare_tiles, rederive_uv,
    )
    from webgpu_raytracing_tpu_torch.ops.env_sample import sample_env
    from webgpu_raytracing_tpu_torch.ops.integrator import (
        face_normal, face_point_offset, light_ray, sample_lights,
    )
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays
    from webgpu_raytracing_tpu_torch.ops.strictf import sdot3

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
    t_max = torch.full((r,), F32_MAX, device=dev)
    tile = st.trace_tile
    closest, anyhit = {}, {}
    args = prepare_tiles(o, d, t_max, tables, tile=tile)
    closest["primary"] = _compare_leg(torch, "primary", args, card)

    # path_trace's segment-0 vertex on the kernel's primary hits
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

    # NEE shadow set (direct_light, first light sample)
    ls, _ = sample_lights(state, tables, st)
    dirn, t_light, _ = light_ray(new_o, ls)
    args = prepare_tiles(new_o, dirn, t_light, tables, active=h_mask,
                         excl_code=excl, tile=tile)
    anyhit["nee"] = _compare_leg(torch, "nee shadow", args, card, True)

    # env-NEE set (path_trace's env-IS branch)
    ed, _, _, _ = sample_env(sky, state)
    facing = sdot3(ed, detmath.normalize(n)) > 0.0
    args = prepare_tiles(new_o, ed, t_max, tables, active=h_mask & facing,
                         excl_code=excl, tile=tile)
    anyhit["env"] = _compare_leg(torch, "env shadow", args, card, True)

    # first bounce set
    t2, _ = rng.random_2(state)
    new_d = rng.sample_cosine_weighted_hemisphere(t2, n)
    args = prepare_tiles(new_o, new_d, t_max, tables, active=h_mask,
                         excl_code=excl, tile=tile)
    closest["bounce"] = _compare_leg(torch, "bounce", args, card)
    return closest, anyhit


def drive_path(torch, name, scene, st, frames, seed, card, per_frame,
               env_data=None, finite=True):
    """Render one warm-up and ``frames`` timed frames through Renderer on
    the card; check sample counts, launch counts (closest, any-hit per
    frame) and the image; return the measured numbers."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    r = Renderer(scene, st, env_data=env_data, base_seed=seed,
                 device="cuda")
    r.step()  # warm-up
    torch.cuda.synchronize()
    cc.trace_closest_tiles.launches = 0
    cc.trace_any_tiles.launches = 0
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(frames):
        r.step()
        rays += r.last_rays
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (cc.trace_closest_tiles.launches, cc.trace_any_tiles.launches)
    img = r.buffers.image
    want = (1.0 + st.sample_count) * (frames + 1)
    if not bool((img[..., 3] == want).all()):
        fail(f"{name}: sample counts differ from {want}")
    expect = (per_frame[0] * frames, per_frame[1] * frames)
    if launches != expect:
        fail(f"{name}: (closest, any-hit) launches {launches} in {frames} "
             f"frames, expected {expect}")
    rgb = img[..., :3]
    if bool(torch.isinf(rgb).any()):
        fail(f"{name}: +-inf in the accumulation buffer")
    nan_share = float(torch.isnan(rgb).any(-1).float().mean())
    if finite and nan_share > 0.0:
        fail(f"{name}: NaN in the accumulation buffer")
    if not r.last_rays > 0:
        fail(f"{name}: no rays traced")
    disp = r.image()
    if disp.shape != (st.height, st.width, 3):
        fail(f"{name}: display image shape {disp.shape}")
    ms = dt / frames * 1e3
    mrays = rays / dt / 1e6
    print(f"{name}: {frames} frames of {st.width}x{st.height}, "
          f"{ms:.1f} ms/frame, {mrays:.3f} Mrays/s "
          f"({rays / frames:.0f} rays/frame), launches closest {launches[0]}"
          f" any-hit {launches[1]}, NaN pixels {nan_share:.4f} ({card})",
          flush=True)
    return dict(launches=launches, ms_per_frame=ms, mrays=mrays,
                nan_share=nan_share)


def phase_paths(torch, scene, sky, frames, seed, card):
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops.env_sample import sample_env
    from webgpu_raytracing_tpu_torch.ops import rng

    paths = {}
    base = RenderSettings(**SLICE)
    paths["default"] = drive_path(torch, "default path", scene, base, frames,
                                  seed, card, (6, 0))
    paths["nee"] = drive_path(
        torch, "NEE path", scene, base.replace(next_event_estimation=True),
        frames, seed, card, (6, 6), finite=False,
    )
    env_st = base.replace(environment="equirect", env_importance_sampling=True)
    paths["envis"] = drive_path(torch, "env-IS path", scene, env_st, frames,
                                seed, card, (6, 6), env_data=sky,
                                finite=False)
    lanes = 1920 * 1080
    state = rng.seed_state(
        12345, torch.arange(lanes, dtype=torch.int32, device="cuda")
    )
    ms = _time_cuda(torch, lambda: sample_env(sky, state), 5)
    print(f"sample_env: {lanes} lanes on a {SKY_SHAPE[0]}x{SKY_SHAPE[1]} "
          f"map, {ms:.3f} ms ({card})", flush=True)
    paths["envis"]["sample_env_ms"] = ms
    return paths


def analytic_scene():
    """BASELINE config #1's scene (frontend/cli.py, ``--scene analytic``)."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
    from webgpu_raytracing_tpu_torch.models.test_models import (
        ground_plane, uv_sphere,
    )

    return scene_from_facesets(
        [
            ("light", uv_sphere((0, 6, -6), 1.0, material_idx=0, lat=8,
                                lon=12)),
            ("sphere_a", uv_sphere((-1.4, 1.0, -6), 1.0, material_idx=1)),
            ("sphere_b", uv_sphere((1.4, 0.8, -7), 0.8, material_idx=2)),
            ("plane", ground_plane(0.0, 20.0, material_idx=3)),
        ],
        np.array([[0, 0, 0], [0.8, 0.3, 0.3], [0.3, 0.4, 0.8],
                  [0.7, 0.7, 0.7]], np.float32),
        np.array([[12, 12, 12], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                 np.float32),
    )


def phase_direct(torch, frames, seed, card):
    from webgpu_raytracing_tpu_torch.config import (
        ProjectionType, RenderSettings,
    )

    st = RenderSettings(width=256, height=256, sample_count=1,
                        bounces_depth=1,
                        projection_type=ProjectionType.PERSPECTIVE)
    return drive_path(torch, "direct path (config #1)", analytic_scene(), st,
                      frames, seed, card, (2, 2), finite=False)


def mini_scene():
    import numpy as np

    from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
    from webgpu_raytracing_tpu_torch.models.test_models import (
        ground_plane, uv_sphere,
    )

    return scene_from_facesets(
        [
            ("light", uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                lon=6)),
            ("sphere", uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def phase_reference(torch):
    import numpy as np

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
        "mini_scene_2f.npz",
    )
    scene = mini_scene()
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

    small_sky = sky_equirect(torch, 32, 64, "cpu").numpy()
    cases = {
        "NEE": (st.replace(next_event_estimation=True), None),
        "bounces_depth=1": (st.replace(bounces_depth=1), None),
        "env-IS": (st.replace(bounces_depth=4, environment="equirect",
                              env_importance_sampling=True),
                   build_env_distribution(small_sky)),
    }
    out = {}
    for name, (cst, env) in cases.items():
        imgs = []
        for dev in ("cuda", "cpu"):
            r = Renderer(scene, cst, env_data=env, base_seed=77, device=dev)
            r.step()
            r.step()
            imgs.append(r.buffers.image.cpu().numpy())
        card_img, cpu_img = imgs
        nan = np.isnan(cpu_img)
        if not (np.isnan(card_img) == nan).all():
            fail(f"reference {name}: NaN masks differ between card and CPU")
        rmse = float(np.sqrt(np.mean((card_img[~nan] - cpu_img[~nan]) ** 2)))
        print(f"reference {name}: 32x32 mini scene, card vs CPU twins, RMSE "
              f"{rmse:.3g}, NaN values {int(nan.sum())}", flush=True)
        if not rmse < 1e-5:
            fail(f"reference {name}: RMSE {rmse} >= 1e-5")
        out[name] = rmse
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()

    import torch

    card = phase_environment(torch)
    phase_build()
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )

    t0 = time.perf_counter()
    scene = stress_scene(N_TRIANGLES)
    sky = build_env_distribution(
        sky_equirect(torch, *SKY_SHAPE, "cuda").cpu().numpy(), "cuda"
    )
    print(f"scene: stress_scene({N_TRIANGLES}) and the {SKY_SHAPE[0]}x"
          f"{SKY_SHAPE[1]} sky distribution built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    closest, anyhit = phase_kernel_vs_twin(torch, scene, sky, a.seed, card)
    paths = phase_paths(torch, scene, sky, a.frames, a.seed, card)
    paths["direct"] = phase_direct(torch, a.frames, a.seed, card)
    reference = phase_reference(torch)

    def by_path(i):
        return {k: v["launches"][i] for k, v in paths.items()
                if v["launches"][i]}

    frame_ms = {k: v["ms_per_frame"] for k, v in paths.items()}
    mrays = {k: v["mrays"] for k, v in paths.items()}
    source = "webgpu_raytracing_tpu_torch/csrc/cluster_trace.cu"
    pallas = "webgpu_raytracing_tpu/ops/cluster_pallas.py"
    print(json.dumps({"kernels": [
        {
            "name": "trace_closest_clustered",
            "route": "cuda",
            "source": source,
            "replaces": f"{pallas}:1141",
            "launches": sum(by_path(0).values()),
            "launches_by_path": by_path(0),
            "max_abs_err": max(x["max_abs"] for x in closest.values()),
            "mismatches": max(x["mismatch"] for x in closest.values()),
            "ms": closest["bounce"]["ms"],
            "plain_ms": closest["bounce"]["plain_ms"],
            "legs": closest,
            "ms_per_frame": frame_ms,
            "mrays_per_s": mrays,
        },
        {
            "name": "trace_any_clustered",
            "route": "cuda",
            "source": source,
            "replaces": f"{pallas}:576 and :1243",
            "launches": sum(by_path(1).values()),
            "launches_by_path": by_path(1),
            "max_abs_err": max(x["max_abs"] for x in anyhit.values()),
            "mismatches": max(x["mismatch"] for x in anyhit.values()),
            "ms": anyhit["nee"]["ms"],
            "plain_ms": anyhit["nee"]["plain_ms"],
            "legs": anyhit,
            "sample_env_ms": paths["envis"]["sample_env_ms"],
            "reference_rmse": reference,
        },
    ]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
