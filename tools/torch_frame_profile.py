"""Where a frame of the PyTorch port goes on the GPU.

    python3 tools/torch_frame_profile.py [--frames 2] [--width 1920 --height 1080]
        [--trace-sched J] [--order-outside] [--pipeline-rounds] [--sort]
        [--binned] [--multipass-cap N] [--nee] [--config5]

Renders the main-path slice (``stress_scene(44_556)``, default path
settings, procedural sky) on the first CUDA device: one warm-up frame,
``--frames`` frames timed on the host clock alone (the frame's wall time
without the profiler, which slows a host-bound frame), then ``--frames``
frames under ``torch.profiler`` with the frame's layers
marked as named ranges (raygen, trace prep = ray padding and, with the
order made outside the kernel, tile entry distances + sort; kernel,
rederive, environment, the ray sort = key, sort, gathers, live
count and unsort of ops/ray_sort.py, the rest of the integrator). The
default frame orders every tile inside the kernel (``kernel_near``);
``--order-outside`` turns that off (K1 / K3 over ``tile_nears_fused`` and
``torch.sort``; ``--multipass-cap`` needs it to take effect). The other
flags set ``trace_sched``, ``pipeline_rounds`` and
``sort_bounce_rays`` (with ``live_slice``), so those frames get the same
table; ``--binned`` and ``--multipass-cap`` (both imply ``--sort``) set
``binned_sort`` and ``multipass_cap``, whose keys, sorts, gathers, count
reads and unsorts fall into the ray sort's range and whose K4 launches
into the kernel's. ``--nee`` sets ``next_event_estimation`` (its shadow
legs' any-hit launches fall into the kernel's range). ``--config5``
renders BASELINE config #5 instead
(``stress_scene(1_000_000)``, 3840x2160 in 8 slabs, two-level tables).
Prints the
GPU span of each layer, the kernels' busy share of the frame's GPU span,
the top CUDA kernels, and one JSON line with the numbers. The card's name
and power limit (nvidia-smi) are printed beside them. Fails without a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYERS = ("raygen", "trace_prep", "kernel", "rederive", "environment",
          "ray_sort")
# the stages of sorted_trace that are the sort's own, and the function of
# ops/ray_sort.py that each is (the traced leg between them has the ranges
# of its own prep and kernel)
SORT_STAGES = {"key": "nearest_cluster_key", "key_top_n":
               "nearest_cluster_keys2", "sort": "sort_keys",
               "gather": "permute_rows", "count": "live_count",
               "survivor_count": "survivor_count", "unsort": "unsort"}


def _wrap(mod, name, label, record_function):
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    setattr(mod, name, wrapped)


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
    a = ap.parse_args()
    a.sort = a.sort or a.binned or a.multipass_cap > 0

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops import (
        cluster_cuda, integrator, ray_sort,
    )
    from webgpu_raytracing_tpu_torch.renderer import Renderer
    import webgpu_raytracing_tpu_torch.renderer as renderer_mod

    _wrap(renderer_mod, "camera_rays", "raygen", record_function)
    _wrap(cluster_cuda, "prepare_tiles", "trace_prep", record_function)
    # every entry of the hand-written kernels is launched through _run
    _wrap(cluster_cuda, "_run", "kernel", record_function)
    _wrap(cluster_cuda, "rederive_uv", "rederive", record_function)
    _wrap(integrator, "sample_environment", "environment", record_function)
    for stage, name in SORT_STAGES.items():
        _wrap(ray_sort, name, f"ray_sort.{stage}", record_function)

    if a.config5:
        a.width, a.height = 3840, 2160
    st = RenderSettings(width=a.width, height=a.height, sample_count=1,
                        bounces_depth=4, environment="procedural",
                        frame_slabs=8 if a.config5 else 1,
                        trace_sched=a.trace_sched,
                        kernel_near=not a.order_outside,
                        pipeline_rounds=a.pipeline_rounds,
                        sort_bounce_rays=a.sort, live_slice=True,
                        binned_sort=a.binned, multipass_cap=a.multipass_cap,
                        next_event_estimation=a.nee)
    r = Renderer(stress_scene(1_000_000 if a.config5 else 44_556), st,
                 base_seed=a.seed, device="cuda")
    r.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(a.frames):
        r.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / a.frames * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.frames):
            with record_function("frame"):
                r.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    by_name = {e.key: e for e in events}
    layer_ms = {
        k: dev_us(by_name[k]) / 1e3 / a.frames if k in by_name else 0.0
        for k in LAYERS + ("frame",)
    }
    sort_ranges = tuple(f"ray_sort.{k}" for k in SORT_STAGES)
    layer_ms["ray_sort"] = sum(
        dev_us(by_name[k]) for k in sort_ranges if k in by_name
    ) / 1e3 / a.frames
    # the named ranges also appear as device-side annotations spanning
    # their kernels; only real kernels count as busy time
    ranges = LAYERS + ("frame",) + sort_ranges
    kernels = collections.Counter()
    for e in events:
        if "CUDA" in str(e.device_type) and e.key not in ranges:
            kernels[e.key] += dev_us(e)
    busy_ms = sum(kernels.values()) / 1e3 / a.frames
    frame_ms = wall / a.frames * 1e3
    print(f"card: {card}")
    print(f"{a.frames} frames without the profiler: {plain_ms:.1f} ms/frame "
          "wall")
    print(f"{a.frames} frames of {a.width}x{a.height}: {frame_ms:.1f} ms/frame "
          f"wall, GPU span {layer_ms['frame']:.1f} ms/frame, kernels busy "
          f"{busy_ms:.1f} ms/frame (idle share "
          f"{1 - busy_ms / layer_ms['frame']:.3f} of the span)")
    print("GPU span of each layer's kernels:")
    for k in LAYERS:
        print(f"  {k:12s} {layer_ms[k]:9.2f} ms/frame")
    rest = layer_ms["frame"] - sum(layer_ms[k] for k in LAYERS)
    print(f"  {'other':12s} {rest:9.2f} ms/frame GPU (shading, RNG, "
          "accumulation)")
    print("top CUDA kernels (ms/frame):")
    for name, us in kernels.most_common(15):
        print(f"  {us / 1e3 / a.frames:9.2f}  {name[:110]}")
    print(json.dumps({
        "card": card, "frames": a.frames, "width": a.width,
        "height": a.height, "trace_sched": a.trace_sched,
        "kernel_near": not a.order_outside, "config5": a.config5,
        "pipeline_rounds": a.pipeline_rounds,
        "sort": a.sort, "binned": a.binned,
        "multipass_cap": a.multipass_cap, "nee": a.nee,
        "frame_ms_unprofiled": plain_ms, "frame_ms": frame_ms,
        "gpu_span_ms": layer_ms["frame"], "gpu_busy_ms": busy_ms,
        "layers_ms": {k: layer_ms[k] for k in LAYERS}, "other_ms": rest,
        "rays_per_frame": r.last_rays,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
