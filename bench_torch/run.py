"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` beside this
folder: a configuration (``configs/<config>.json``: the scene generator
and its arguments, the image size, the camera pose or the camera path
(motion.py) and the settings) and
a traffic mix (``traffic/<mix>.json``: the settings it overrides and the
environment map's generator and shape), with the limits of its
comparison in ``cells/<cell>.json``. Generators live in
``scenes/<generator>.py`` and the per-layer metrics' readers in
``metrics/<metric>.py``; the harness finds each by its name.

Set-up builds one ``Renderer`` of the port from the configuration's
scene, warms it up with two frames, and then drives ``Renderer.step()``
back to back for ``--seconds`` (a closed loop, as the viewer and
``cli render`` run frames). On a camera path, before each frame whose
pose differs from the last one's, the harness sets ``renderer.camera``
and calls ``renderer.reset()``, as ``cli orbit`` does, inside the
frame's time; such a frame starts its accumulation from zero. With
``--trace 0`` the last line of standard output holds the
end-to-end metrics; with ``--trace 1`` the frames of a shorter window
run under ``torch.profiler``, the layers marked by ranges put around the
port's functions from here, and the line holds the per-layer metrics.
After the window one frame drawn from the seed is rendered again by the
plain reference (reference.py), from that frame's own view, and compared
(compare.py). The run fails, and prints no result, without a CUDA
device, or when JAX or the JAX package has been loaded into the process.
A configuration with ``reprojection_rate`` > 0 is refused: the plain
reference has no temporal reprojection.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):  # the program at the checkout's root; this folder
    if _p not in sys.path:
        sys.path.insert(0, _p)

WARMUP_FRAMES = 2
TRACE_SECONDS = 4.0  # the traced window: at most this long,
TRACE_FRAMES = (2, 32)  # and between these many frames
# the program's modules and functions around which the traced run puts a
# range: (module, attribute, range)
RANGES = (
    ("webgpu_raytracing_tpu_torch.renderer", "camera_rays", "bench.raygen"),
    ("webgpu_raytracing_tpu_torch.ops.cluster_cuda", "prepare_tiles",
     "bench.trace_prep"),
    ("webgpu_raytracing_tpu_torch.ops.cluster_cuda", "_run",
     "bench.trace_kernels"),
    ("webgpu_raytracing_tpu_torch.ops.cluster_cuda", "rederive_uv",
     "bench.rederive"),
    ("webgpu_raytracing_tpu_torch.ops.integrator", "rederive_uv",
     "bench.rederive"),
    ("webgpu_raytracing_tpu_torch.ops.integrator", "trace_closest",
     "bench.closest"),
)
# the profiler's own host events, never what the host was doing
PROFILER_OWN = ("Activity Buffer Request",)
# the integrators whose per-sample colours the comparison reads
INTEGRATORS = ("path_trace", "trace_direct")
# top-level modules that a run may not have loaded when it reports
JAX_NAMES = ("jax", "jaxlib", "flax", "webgpu_raytracing_tpu")


class Patches:
    """Functions of the program replaced by wrappers for one run, put
    back by :meth:`restore`."""

    def __init__(self):
        self.saved = []

    def wrap(self, mod, attr, make):
        fn = getattr(mod, attr)
        self.saved.append((mod, attr, fn))
        setattr(mod, attr, make(fn))

    def restore(self):
        while self.saved:
            mod, attr, fn = self.saved.pop()
            setattr(mod, attr, fn)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_spec(name: str, root: str = ROOT) -> dict:
    """The cell's manifest entries and files, found by name."""
    manifest = read_json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "bench_torch")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{', '.join(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = read_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))
    limits = read_json(os.path.join(here, "cells", name + ".json"))

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(
        cell=cell, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)],
        here=here,
    )


def settings_of(spec: dict) -> dict:
    """The reference's settings: its defaults, the configuration's, then
    the traffic mix's."""
    from reference import DEFAULTS

    st = dict(DEFAULTS)
    st.update(spec["config"]["settings"])
    st.update(spec["traffic"].get("settings", {}))
    if st.get("reprojection_rate", 0):
        raise SystemExit("bench_torch: reprojection_rate > 0 is not "
                         "measured: the plain reference has no temporal "
                         "reprojection, and frame_inputs draws the jitter "
                         "every frame, as Renderer._step does at rate 0")
    return st


def program_settings(st: dict):
    """The port's RenderSettings for the same settings (enum values by
    their lower-case names)."""
    import dataclasses
    import enum

    from webgpu_raytracing_tpu_torch.config import RenderSettings

    fields = {f.name: f.default for f in dataclasses.fields(RenderSettings)}
    kw = {}
    for k, v in st.items():
        cur = fields[k]
        kw[k] = type(cur)[v.upper()] if isinstance(cur, enum.Enum) else v
    return RenderSettings(**kw)


def generate_scene(spec: dict, seed: int):
    sc = spec["config"]["scene"]
    gen = load_module(os.path.join(spec["here"], "scenes",
                                   sc["generator"] + ".py"),
                      "scene_" + sc["generator"])
    return gen.generate(seed, **sc.get("args", {}))


def generate_env(spec: dict, seed: int, device):
    env = spec["traffic"].get("env")
    if not env:
        return None
    gen = load_module(os.path.join(spec["here"], "scenes",
                                   env["generator"] + ".py"),
                      "env_" + env["generator"])
    return gen.generate(seed, **env.get("args", {}), device=device)


def program_scene(desc):
    from webgpu_raytracing_tpu_torch.models.face import FaceSet
    from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets

    from scenes._mesh import FIELDS

    models, mat_color, mat_emission = desc
    return scene_from_facesets(
        [(n, FaceSet(**{k: f[k] for k in FIELDS})) for n, f in models],
        mat_color, mat_emission)


def frame_inputs(seed: int, frames: int, jitter_strength: float):
    """The seed and jitter of each frame as the port's host generator
    draws them from ``base_seed`` (renderer.py ``Renderer.step``:
    a 32-bit seed, then the jitter pair, every frame without
    reprojection)."""
    import numpy as np

    gen = np.random.default_rng(seed)
    out = []
    for _ in range(frames):
        s = int(gen.integers(0, 2**32, dtype=np.uint64))
        j = (gen.random(2).astype(np.float32) - 0.5) * jitter_strength
        out.append((s, j))
    return out


class Capture:
    """Keeps the integrators' colours, call by call, of the frame being
    compared; for the others it only passes them on."""

    def __init__(self, renderer_mod, patches):
        self.on = False
        self.colors = []
        for name in INTEGRATORS:
            patches.wrap(renderer_mod, name, self._wrap)

    def _wrap(self, fn):
        def wrapped(*a, **k):
            res = fn(*a, **k)
            if self.on:
                self.colors.append(res.color)
            return res
        return wrapped

    def take(self):
        out, self.colors = self.colors, []
        return out


class Drive:
    """Steps the renderer along the configuration's camera path, frame by
    frame from the first warm-up frame: before a frame whose pose differs
    from the last one's it sets ``renderer.camera`` and calls
    ``renderer.reset()``, as ``cli orbit`` does."""

    def __init__(self, renderer, path, camera_cls):
        self.renderer, self.path, self.camera_cls = renderer, path, camera_cls
        self.frame = 0

    def step(self):
        r = self.renderer
        if self.path.moves_before(self.frame):
            position, orientation = self.path.pose(self.frame)
            r.camera = self.camera_cls(position=position,
                                       orientation=orientation)
            r.reset()
        r.step()
        self.frame += 1


def frame_colors(colors, slabs: int):
    """The frame's colours of each sample, (pixels, 3) in row order, from
    the integrator's calls: ``slabs`` slabs of rows one after another,
    each with its samples in turn."""
    import torch

    per = len(colors) // slabs
    if per * slabs != len(colors):
        return []
    return [torch.cat([colors[s * per + k] for s in range(slabs)])
            for k in range(per)]


class LegCapture:
    """Keeps each closest-hit leg's inputs and result while on."""

    def __init__(self, integrator_mod, patches):
        self.on = False
        self.legs = []
        patches.wrap(integrator_mod, "trace_closest", self._wrap)

    def _wrap(self, fn):
        def wrapped(o, d, t_max, tables, settings, active=None, *a, **k):
            hit = fn(o, d, t_max, tables, settings, active, *a, **k)
            if self.on:
                import torch
                act = (torch.ones_like(t_max, dtype=torch.bool)
                       if active is None else active)
                self.legs.append((o, d, t_max, act, hit.t, hit.face))
            return hit
        return wrapped


def install_ranges(record_function, patches):
    for mod_name, attr, label in RANGES:
        def make(fn, _label=label):
            def wrapped(*a, **k):
                with record_function(_label):
                    return fn(*a, **k)
            return wrapped

        patches.wrap(sys.modules[mod_name], attr, make)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def p95(values):
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def run(args, device: str = "cuda", cell_spec_=None, size=None,
        out=print, phases=None) -> dict:
    """One run of a cell → the result object. ``device`` "cpu" and
    ``size`` (width, height) serve the benchmark's own tests; ``phases``
    holds the set-up phases timed before the call."""
    patches = Patches()
    try:
        return _run(args, device, cell_spec_, size, out, patches,
                    dict(phases or {}))
    finally:
        patches.restore()


def _run(args, device, cell_spec_, size, out, patches, phases) -> dict:
    spec = cell_spec_ or cell_spec(args.workload)
    t = time.time()

    import numpy as np
    import torch

    import webgpu_raytracing_tpu_torch.ops.integrator as integrator_mod
    import webgpu_raytracing_tpu_torch.renderer as renderer_mod
    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )

    import compare
    import reference as ref
    from motion import CameraPath

    phases["import"] = time.time() - t
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = time.time()
    if cuda:
        from webgpu_raytracing_tpu_torch.ops._build import load
        load()
    phases["kernel_library"] = time.time() - t

    st = settings_of(spec)
    if size is not None:
        st["width"], st["height"] = size
    t = time.time()
    desc = generate_scene(spec, args.seed)
    scene = program_scene(desc)
    phases["scene"] = time.time() - t
    t = time.time()
    img = generate_env(spec, args.seed, dev)
    env_data = None
    if img is not None:
        env_data = (build_env_distribution(img.cpu().numpy(), dev)
                    if st["env_importance_sampling"] else img.cpu().numpy())
    phases["environment"] = time.time() - t

    path = CameraPath(spec["config"])
    position, orientation = path.pose(0)
    t = time.time()
    renderer = renderer_mod.Renderer(
        scene, program_settings(st), env_data=env_data,
        camera=Camera(position=position, orientation=orientation),
        base_seed=args.seed, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    phases["tables"] = time.time() - t
    drive = Drive(renderer, path, Camera)

    capture = Capture(renderer_mod, patches)
    legs = None
    prof_mod = None
    if args.trace:
        import torch.profiler as prof_mod
        install_ranges(prof_mod.record_function, patches)
        legs = LegCapture(integrator_mod, patches)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.time()
    warm_s = []
    for _ in range(WARMUP_FRAMES):
        t0 = time.perf_counter()
        drive.step()
        sync()
        warm_s.append(time.perf_counter() - t0)
    if args.trace:  # the profiler's own start-up, outside the window
        with prof_mod.profile(activities=_activities(prof_mod, cuda)):
            pass
    phases["warmup"] = time.time() - t

    window = args.seconds
    if args.trace:
        window = min(args.seconds, TRACE_SECONDS)
    # the compared frame is drawn from those that half the window holds
    # at the warm-up's pace, so that the window surely reaches it
    n_est = max(1, int(0.5 * window / max(warm_s[-1], 1e-6)))
    if args.trace:
        n_est = min(n_est, TRACE_FRAMES[0])
    pick = int(np.random.default_rng((args.seed, 0x5EED)).integers(n_est))

    compared = []
    frame_s = []
    rays_total = 0.0
    profiler = None
    if args.trace:
        profiler = prof_mod.profile(activities=_activities(prof_mod, cuda))
        profiler.__enter__()
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - T_START
    t_start = time.perf_counter()
    i = 0
    while True:
        last = args.trace and (
            i + 1 >= TRACE_FRAMES[1]
            or (i + 1 >= TRACE_FRAMES[0]
                and time.perf_counter() - t_start >= window))
        capture.on = i == pick
        if legs is not None:
            legs.on = bool(last)
        before = renderer.buffers.image
        # a frame after a move starts its accumulation from zero
        moved = path.moves_before(drive.frame)
        t0 = time.perf_counter()
        if args.trace:
            with prof_mod.record_function("bench.frame"):
                drive.step()
        else:
            drive.step()
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        rays_total += renderer.last_rays
        if capture.on:
            compared.append(dict(index=i, before=before, moved=moved,
                                 after=renderer.buffers.image,
                                 colors=capture.take(),
                                 rays=renderer.last_rays))
        i += 1
        if args.trace:
            if last:
                break
        elif t1 - t_start >= window:
            break
    sync()
    window_s = time.perf_counter() - t_start
    capture.on = False
    if profiler is not None:
        profiler.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    frames = len(frame_s)

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    out(f"card: {card_line() if cuda else 'cpu'}")
    out(f"frames in the window: {frames} over {window_s:.6f} s")
    ms = sorted(f * 1e3 for f in frame_s)
    med = statistics.median(ms)
    out(f"frame ms: median {med:.3f}, p95 {p95(ms):.3f}, max {ms[-1]:.3f}; "
        f"{sum(f > 1.25 * med for f in ms)} frames over 1.25 x the median")
    out(f"rays per frame: {rays_total / frames:.1f}")
    out(f"peak device memory: {memory_peak} bytes in the window, "
        f"{setup_peak} bytes in set-up")
    out("set-up phases (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in phases.items())
        + f"; process start to the first timed frame {setup_s:.6f}")

    # the per-layer readings need the program's state; then free it
    ctx = None
    if args.trace:
        ctx = trace_context(profiler, frames, window_s, legs, renderer,
                            kind)
    del renderer, drive, scene, env_data, capture, legs, profiler
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window and the memory reading
    t = time.time()
    inputs = frame_inputs(args.seed, WARMUP_FRAMES + frames,
                          st["jitter_strength"])
    rscene = ref.Scene(desc, dev)
    renv = ref.Environment(st["environment"], img,
                           st["env_importance_sampling"])
    tally = compare.Tally()
    for c in compared:
        frame = WARMUP_FRAMES + c["index"]
        seed, jitter = inputs[frame]
        colors, rays = ref.render_frame(rscene, renv, st, path.view(frame),
                                        seed, jitter)
        before = c["before"]
        if c["moved"]:
            before = torch.zeros_like(before)
        tally.add(frame_colors(c["colors"], st.get("frame_slabs", 1)), colors,
                  c["rays"], rays, before, c["after"])
    numbers = tally.numbers()
    limits = spec["limits"]["limits"]
    correct = compare.verdict(numbers, limits)
    out(f"reference: frame {[c['index'] for c in compared]} compared in "
        f"{time.time() - t:.6f} s")

    result = dict(correct=correct, attempted=frames,
                  failed=0 if correct else 1)
    if args.trace:
        result["metrics"] = per_layer(spec, ctx)
        for note in ctx["notes"]:
            out(note)
        busy = ctx["busy_us"] / 1e6
        result["device"] = dict(platform="gpu" if cuda else "cpu",
                                kind=kind, count=1,
                                memory_peak_bytes=memory_peak,
                                busy_s=busy, window_s=ctx["window_s"])
        result["breakdown"] = ctx["breakdown"]
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            if m["name"] == "mrays_per_s":
                v = rays_total / window_s / 1e6
            elif m["name"] == "frame_ms_p95":
                v = p95([s * 1e3 for s in frame_s])
            elif m["name"] == "setup_s":
                v = setup_s
            else:
                raise SystemExit(f"no definition of {m['name']}")
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
        result["metrics"] = metrics
        result["device"] = dict(platform="gpu" if cuda else "cpu",
                                kind=kind, count=1,
                                memory_peak_bytes=memory_peak)
    result["compared"] = {
        k: dict(value=numbers.get(k), limit=limits[k]) for k in limits}
    return result


def _activities(prof_mod, cuda):
    acts = [prof_mod.ProfilerActivity.CPU]
    if cuda:
        acts.append(prof_mod.ProfilerActivity.CUDA)
    return acts


def trace_context(profiler, frames, window_s, legs, renderer,
                  kind) -> dict:
    """What the metric readers read: the device busy time of the
    operations launched inside each range, the device operations of the
    traced frames, the legs of the last frame with the time of the trace
    kernels launched inside them, and the program's cluster tables.

    A device operation belongs to every range open on the host when it
    was launched: its launch is the runtime call with the same
    correlation id, so the kernels that the port launches itself through
    ctypes count where they were launched, like PyTorch's."""
    import bisect

    from torch.autograd import DeviceType

    events = profiler.events()
    cpu = [e for e in events
           if e.device_type == DeviceType.CPU and not e.is_async]
    device_ops = [e for e in events
                  if e.device_type != DeviceType.CPU
                  and not e.is_user_annotation
                  and not e.name.startswith("bench.")]
    launch_at = {e.id: e.time_range.start for e in cpu
                 if e.name.startswith("cu")}
    spans = {}
    for e in cpu:
        if e.name.startswith("bench."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    for v in spans.values():
        v.sort()
    starts = {k: [s for s, _ in v] for k, v in spans.items()}

    def within(name, t):
        i = bisect.bisect_right(starts.get(name, []), t) - 1
        return i >= 0 and spans[name][i][0] <= t <= spans[name][i][1]

    last_frame = spans.get("bench.frame", [(0.0, -1.0)])[-1]
    range_us = {k: 0.0 for k in spans}
    closest_us = 0.0
    unlinked = 0
    for e in device_ops:
        dur = e.time_range.end - e.time_range.start
        t = launch_at.get(e.id)
        if t is None:
            unlinked += 1
            continue
        for name in spans:
            if within(name, t):
                range_us[name] += dur
        if (last_frame[0] <= t <= last_frame[1]
                and within("bench.closest", t)
                and within("bench.trace_kernels", t)):
            closest_us += dur

    intervals = sorted((e.time_range.start, e.time_range.end)
                       for e in device_ops)
    busy_us = 0.0
    cur_s = cur_e = None
    for s, en in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, en
        else:
            cur_e = max(cur_e, en)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    gpu_span_us = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0

    totals = {}
    for e in device_ops:
        totals[e.name] = totals.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in
                   zip(intervals, intervals[1:]) if s1 > e0),
                  reverse=True)[:10]
    idle = [[_host_at(cpu, at), g / 1e6] for g, at in gaps]

    ct = renderer.tables.clusters
    return dict(
        frames=frames, window_s=window_s, kind=kind,
        range_us=range_us, busy_us=busy_us, gpu_span_us=gpu_span_us,
        launches=len(device_ops) - unlinked, unlinked=unlinked,
        legs=legs.legs, closest_kernel_us=closest_us,
        box=ct.box, face_id=ct.face_id, notes=[
            f"device operations: {len(device_ops)}, {unlinked} without "
            f"a launch found; busy {busy_us / 1e3:.6f} ms, launched in "
            f"the frames {range_us.get('bench.frame', 0.0) / 1e3:.6f} ms"],
        breakdown=dict(device_ops=[[k, v / 1e6] for k, v in top_ops],
                       idle_gaps=idle),
    )


def _host_at(cpu_events, at_us) -> str:
    """The innermost benchmark range, and the innermost operation, open
    on the host at a time."""
    rng = op = None
    best_r = best_o = None
    for e in cpu_events:
        s, en = e.time_range.start, e.time_range.end
        if (s <= at_us <= en and not e.name.startswith("cu")
                and e.name not in PROFILER_OWN):
            if e.name.startswith("bench."):
                if best_r is None or s >= best_r:
                    rng, best_r = e.name, s
            elif best_o is None or s >= best_o:
                op, best_o = e.name, s
    return f"{rng or 'outside the ranges'}: {op or 'no operation'}"


def per_layer(spec, ctx) -> dict:
    out = {}
    for m in spec["per_layer"]:
        reader = load_module(
            os.path.join(spec["here"], "metrics", m["name"] + ".py"),
            "metric_" + m["name"].replace(".", "_"))
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    t = time.time()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "False); this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"bench_torch: the cell needs {spec['cell']['chips']} "
              f"CUDA devices, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    phases = {"torch_and_cuda": time.time() - t}
    result = run(args, "cuda", spec, out=lambda s: print(s, flush=True),
                 phases=phases)
    return report(result)


def jax_loaded() -> list:
    """The loaded modules of JAX, its companions and the JAX package,
    by whole top-level name (the port's name begins with the JAX
    package's)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in JAX_NAMES)


def report(result) -> int:
    """Print the result of a run, each compared number beside its limit
    last on standard error and the result's line last on standard output;
    print no result, and fail, where the process has loaded JAX or the
    JAX package by now, the window closed."""
    found = jax_loaded()
    if found:
        print("bench_torch: no result: the process has loaded "
              + ", ".join(found), file=sys.stderr, flush=True)
        return 3
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
