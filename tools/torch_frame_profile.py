"""Where a frame of the PyTorch port goes on the GPU, by the port's own spans.

    python3 tools/torch_frame_profile.py [--frames 2] [--width 1920 --height 1080]
        [--trace-sched J] [--order-outside] [--pipeline-rounds] [--sort]
        [--binned] [--multipass-cap N] [--nee] [--envis] [--config5]
        [--analytic] [--orbit [--per-pose 512]]

Renders the main-path slice (``stress_scene(44_556)``, default path
settings, procedural sky) on the first CUDA device: one warm-up frame,
``--frames`` frames timed on the host clock alone (the frame's wall time
without the profiler, which slows a host-bound frame), then ``--frames``
frames under ``torch.profiler`` with the port's tracing on
(``utils/timing.tracing``), so that its ``wrt.*`` spans mark the frame's
layers: ``wrt.frame``, ``wrt.raygen``, ``wrt.shade`` (shading and
sampling), ``wrt.env`` (the environment: env-IS draws, pdfs and MIS
weights, the deferred fetch), ``wrt.light`` (NEE's light samples, its
shadow legs inside), ``wrt.trace`` (a leg), ``wrt.trace.prep``,
``wrt.trace.kernel`` (every trace kernel's launch), ``wrt.trace.rederive``,
``wrt.trace.sort`` (the ray sort's sort, gathers, count reads and
unsorts), ``wrt.trace.sort.key`` inside it (the sort's key kernel) and
``wrt.gc``. Each device operation is given to the innermost
span open at its launch, found by correlation id
(``bench_torch/spans.py``), so the port's ctypes launches count where
they were launched. The default frame orders every tile inside the
kernel (``kernel_near``); ``--order-outside`` turns that off (K1 / K3
over ``tile_nears_fused`` and ``torch.sort``; ``--multipass-cap`` needs it
to take effect). The other flags set ``trace_sched``,
``pipeline_rounds`` and ``sort_bounce_rays`` (with ``live_slice``);
``--binned`` and ``--multipass-cap`` (both imply ``--sort``) set
``binned_sort`` and ``multipass_cap``. ``--nee`` sets
``next_event_estimation``; ``--envis`` lights the frame by the
procedural sky written into a 4096x2048 equirect map
(``chip_smoke.sky_equirect``) under ``env_importance_sampling``, as
BASELINE config #3 lights its 4k HDR. ``--config5`` renders BASELINE
config #5 instead (``stress_scene(1_000_000)``, 3840x2160 in 8 slabs, two-level
tables); ``--analytic`` BASELINE config #1, the ``analytic_256.direct``
cell's frame (``cli.analytic_scene``, 256x256, pinhole, direct lighting
only); ``--orbit`` BASELINE config #4, the ``orbit44k_256.path`` cell's
frames (256x256, the same scene, ``cli orbit``'s 4 poses about (0, 1,
-6), a move every ``--per-pose`` frames with ``reset()`` before the
frame, as ``cli orbit`` does; the timed and the profiled frames each
start with a move). Prints, per frame, each span's self and inclusive busy time and
launches, host time and the idle time put down to it, the longest idle
gaps with the span each opened in, the device's busy share of its span,
the top CUDA kernels, the frame's counters
(``Renderer.last_counts``), shading's kernel launches a frame twice over
(the host counter ``shade.kernel_launches`` and, by kernel name, the
``shade_*_kernel`` operations on the device trace with their device
time: 2 a path segment), rederive's the same way
(``rederive.kernel_launches`` and ``rederive_uv_kernel``: 1 a
closest-hit leg), the lights' the same way (``light.kernel_launches``
and ``light_sample_kernel`` / ``light_add_kernel``: 2 a light sample,
so 2 a ``direct_light`` call at one sample a point; none without NEE or
the direct integrator), the restarts of accumulation (``renderer.restarts``)
of each profiled frame, with ``--sort`` the ray sort's key kernel
(``wrt.trace.sort.key``) apart from the rest of ``wrt.trace.sort`` and
its counters a frame (``trace.sort.legs``, ``.rays``, ``.traced``,
``.full_width``, ``.count_reads``), and one JSON line with the numbers. The
card's name and power limit (nvidia-smi) are printed beside them. Fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "bench_torch"))

# the ray sort's counters (ops/ray_sort.sorted_trace), trace.sort.<name>
SORT_COUNTS = ("legs", "rays", "traced", "full_width", "count_reads")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-sched", type=int, default=0)
    ap.add_argument("--order-outside", action="store_true")
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--pipeline-rounds", action="store_true")
    ap.add_argument("--sort", action="store_true")
    ap.add_argument("--binned", action="store_true")
    ap.add_argument("--multipass-cap", type=int, default=0)
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--envis", action="store_true")
    ap.add_argument("--analytic", action="store_true")
    ap.add_argument("--orbit", action="store_true")
    ap.add_argument("--per-pose", type=int, default=512)
    a = ap.parse_args()
    a.sort = a.sort or a.binned or a.multipass_cap > 0

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import spans

    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()

    from chip_smoke import sky_equirect
    from webgpu_raytracing_tpu_torch.camera import orbit_path
    from webgpu_raytracing_tpu_torch.config import (
        ProjectionType,
        RenderSettings,
    )
    from webgpu_raytracing_tpu_torch.frontend.cli import analytic_scene
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )
    from webgpu_raytracing_tpu_torch.renderer import Renderer
    from webgpu_raytracing_tpu_torch.utils.timing import tracing

    if a.config5:
        a.width, a.height = 3840, 2160
    if a.analytic or a.orbit:
        a.width = a.height = 256
    st = RenderSettings(width=a.width, height=a.height, sample_count=1,
                        bounces_depth=4,
                        environment="equirect" if a.envis else "procedural",
                        env_importance_sampling=a.envis,
                        frame_slabs=8 if a.config5 else 1,
                        trace_sched=a.trace_sched,
                        kernel_near=not a.order_outside,
                        pipeline_rounds=a.pipeline_rounds,
                        sort_bounce_rays=a.sort, live_slice=True,
                        binned_sort=a.binned, multipass_cap=a.multipass_cap,
                        next_event_estimation=a.nee)
    if a.analytic:
        st = st.replace(bounces_depth=1,
                        projection_type=ProjectionType.PERSPECTIVE)
    env = None
    if a.envis:
        env = build_env_distribution(
            sky_equirect(torch, 2048, 4096, "cuda").cpu().numpy(), "cuda")
    if a.analytic:
        scene = analytic_scene()
    else:
        scene = stress_scene(1_000_000 if a.config5 else 44_556)
    r = Renderer(scene, st, env_data=env, base_seed=a.seed, device="cuda")
    poses = list(orbit_path(np.array([0.0, 1.0, -6.0]), 6.0, 1.0, 4))
    at = {"pose": -1, "frames": 0}  # the orbit's pose, frames rendered at it

    def step(move=False):
        """One frame; on the orbit, first a move to the next pose with
        ``reset()`` where ``move`` or the pose has had its frames."""
        if a.orbit and (move or at["frames"] == a.per_pose):
            at["pose"] = (at["pose"] + 1) % len(poses)
            at["frames"] = 0
            r.camera = poses[at["pose"]]
            r.reset()
        r.step()
        at["frames"] += 1

    step(move=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(a.frames):
        step(move=k == 0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / a.frames * 1e3
    counts = collections.Counter()
    restarts = []
    with tracing(), profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(a.frames):
            step(move=k == 0)
            counts.update(r.last_counts)
            restarts.append(r.last_counts.get("renderer.restarts", 0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cpu, ops, launch_at = spans.device_view(prof.events())
    table = spans.span_table(cpu, ops, launch_at, a.frames)
    kernels = collections.Counter()
    launches = collections.Counter()
    for e in ops:
        kernels[e.name] += e.time_range.end - e.time_range.start
        launches[e.name] += 1
    shade = {}  # "shade_hit_kernel<true, false>" → (launches, ms) a frame
    for name, us in kernels.items():
        m = re.search(r"shade_\w+_kernel<[^>]*>", name)
        if m:
            shade[m.group(0)] = (launches[name] / a.frames,
                                 us / 1e3 / a.frames)
    rederive = [(launches[name] / a.frames, us / 1e3 / a.frames)
                for name, us in kernels.items()
                if "rederive_uv_kernel" in name]
    rederive = tuple(map(sum, zip(*rederive))) or (0.0, 0.0)
    light = {}  # "light_sample_kernel" → (launches, ms) a frame
    for name, us in kernels.items():
        m = re.search(r"light_(sample|add)_kernel", name)
        if m:
            light[m.group(0)] = (launches[name] / a.frames,
                                 us / 1e3 / a.frames)
    busy_ms = sum(kernels.values()) / 1e3 / a.frames
    starts = [e.time_range.start for e in ops]
    ends = [e.time_range.end for e in ops]
    span_ms = (max(ends) - min(starts)) / 1e3 / a.frames if ops else 0.0
    frame_ms = wall / a.frames * 1e3
    print(f"card: {card}")
    print(f"{a.frames} frames without the profiler: {plain_ms:.1f} ms/frame "
          "wall")
    print(f"{a.frames} frames of {a.width}x{a.height}: {frame_ms:.1f} ms/frame "
          f"wall, GPU span {span_ms:.1f} ms/frame, kernels busy "
          f"{busy_ms:.1f} ms/frame (idle share "
          f"{1 - busy_ms / max(span_ms, 1e-9):.3f} of the span), "
          f"{len(ops) / a.frames:.0f} device operations a frame")
    print("per frame: span, self busy ms / launches, inclusive busy ms / "
          "launches, host ms, idle ms put down to it:")
    for k in sorted(table):
        t = table[k]
        print(f"  {k:20s} {t['self_us'] / 1e3:9.2f} {t['self_launches']:8.0f}"
              f" {t['incl_us'] / 1e3:9.2f} {t['incl_launches']:8.0f}"
              f" {t['host_us'] / 1e3:9.2f} {t['idle_us'] / 1e3:9.2f}")
    print("longest idle gaps: " + "; ".join(
        f"{g / 1e3:.2f} ms in {name}"
        for g, _, name in spans.longest_gaps(cpu, ops)))
    print("top CUDA kernels (ms/frame):")
    for name, us in kernels.most_common(15):
        print(f"  {us / 1e3 / a.frames:9.2f}  {name[:110]}")
    print("counters per frame: " + ", ".join(
        f"{k} {v / a.frames:.1f}" for k, v in sorted(counts.items())))
    print("shading kernel launches per frame: "
          f"{counts.get('shade.kernel_launches', 0) / a.frames:.1f} by "
          "shade.kernel_launches; on the device trace " + (", ".join(
              f"{k} {n:.1f} ({ms:.2f} ms)" for k, (n, ms) in
              sorted(shade.items())) or "none"))
    print("rederive kernel launches per frame: "
          f"{counts.get('rederive.kernel_launches', 0) / a.frames:.1f} by "
          "rederive.kernel_launches; on the device trace "
          f"rederive_uv_kernel {rederive[0]:.1f} ({rederive[1]:.2f} ms)")
    print("light kernel launches per frame: "
          f"{counts.get('light.kernel_launches', 0) / a.frames:.1f} by "
          "light.kernel_launches; on the device trace " + (", ".join(
              f"{k} {n:.1f} ({ms:.2f} ms)" for k, (n, ms) in
              sorted(light.items())) or "none"))
    print("restarts of accumulation (renderer.restarts) by profiled frame: "
          + " ".join(str(n) for n in restarts))
    sort = {}
    if a.sort:
        none = {"self_us": 0.0, "self_launches": 0}
        key = table.get("wrt.trace.sort.key", none)
        rest = table.get("wrt.trace.sort", none)
        sort = {
            "key_ms": key["self_us"] / 1e3,
            "key_launches": key["self_launches"],
            "rest_ms": rest["self_us"] / 1e3,
            "rest_launches": rest["self_launches"],
            **{k: counts.get("trace.sort." + k, 0) / a.frames
               for k in SORT_COUNTS}}
        print(f"ray sort per frame: key kernel (wrt.trace.sort.key) "
              f"{sort['key_ms']:.2f} ms / {sort['key_launches']:.0f} "
              f"launches; the rest of wrt.trace.sort {sort['rest_ms']:.2f} "
              f"ms / {sort['rest_launches']:.0f} launches; " + ", ".join(
                  f"{k} {sort[k]:.1f}" for k in SORT_COUNTS))
    print(json.dumps({
        "card": card, "frames": a.frames, "width": a.width,
        "height": a.height, "trace_sched": a.trace_sched,
        "kernel_near": not a.order_outside, "config5": a.config5,
        "analytic": a.analytic, "orbit": a.orbit,
        "per_pose": a.per_pose if a.orbit else None,
        "restarts": restarts,
        "pipeline_rounds": a.pipeline_rounds,
        "sort": a.sort, "binned": a.binned,
        "multipass_cap": a.multipass_cap, "nee": a.nee, "envis": a.envis,
        "frame_ms_unprofiled": plain_ms, "frame_ms": frame_ms,
        "gpu_span_ms": span_ms, "gpu_busy_ms": busy_ms,
        "spans_ms": {k: {c.replace("_us", "_ms"): v / 1e3
                         if c.endswith("_us") else v
                         for c, v in t.items()} for k, t in table.items()},
        "counts": {k: v / a.frames for k, v in counts.items()},
        "shade_kernels": {k: {"launches": n, "ms": ms}
                          for k, (n, ms) in shade.items()},
        "rederive_kernel": {"launches": rederive[0], "ms": rederive[1]},
        "light_kernels": {k: {"launches": n, "ms": ms}
                          for k, (n, ms) in light.items()},
        "ray_sort": sort,
        "rays_per_frame": r.last_rays,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
