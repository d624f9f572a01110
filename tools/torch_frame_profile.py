"""Where a frame of the PyTorch port goes on the GPU.

    python3 tools/torch_frame_profile.py [--frames 2] [--width 1920 --height 1080]

Renders the main-path slice (``stress_scene(44_556)``, default path
settings, procedural sky) on the first CUDA device: one warm-up frame,
then ``--frames`` frames under ``torch.profiler`` with the frame's layers
marked as named ranges (raygen, trace prep = tile entry distances + sort,
kernel, rederive, environment, the rest of the integrator). Prints the
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

LAYERS = ("raygen", "trace_prep", "kernel", "rederive", "environment")


def _wrap(mod, name, label, record_function):
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    wrapped.__dict__.update(fn.__dict__)  # keeps the launch counter
    setattr(mod, name, wrapped)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()

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
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda, integrator
    from webgpu_raytracing_tpu_torch.renderer import Renderer
    import webgpu_raytracing_tpu_torch.renderer as renderer_mod

    _wrap(renderer_mod, "camera_rays", "raygen", record_function)
    _wrap(cluster_cuda, "prepare_tiles", "trace_prep", record_function)
    _wrap(cluster_cuda, "trace_closest_tiles", "kernel", record_function)
    _wrap(cluster_cuda, "rederive_uv", "rederive", record_function)
    _wrap(integrator, "sample_environment", "environment", record_function)

    st = RenderSettings(width=a.width, height=a.height, sample_count=1,
                        bounces_depth=4, environment="procedural")
    r = Renderer(stress_scene(44_556), st, base_seed=a.seed, device="cuda")
    r.step()
    torch.cuda.synchronize()
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
    # the named ranges also appear as device-side annotations spanning
    # their kernels; only real kernels count as busy time
    kernels = collections.Counter()
    for e in events:
        if ("CUDA" in str(e.device_type)
                and e.key not in LAYERS + ("frame",)):
            kernels[e.key] += dev_us(e)
    busy_ms = sum(kernels.values()) / 1e3 / a.frames
    frame_ms = wall / a.frames * 1e3
    print(f"card: {card}")
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
        "height": a.height, "frame_ms": frame_ms,
        "gpu_span_ms": layer_ms["frame"], "gpu_busy_ms": busy_ms,
        "layers_ms": {k: layer_ms[k] for k in LAYERS}, "other_ms": rest,
        "rays_per_frame": r.last_rays,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
