"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 2] [--config5-frames 2] [--seed 0]

Phases (any failure exits non-zero; nothing is caught to carry on):

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
   fails when no CUDA device is visible. TF32 is switched off.
2. build: compiles the eighteen entries of the cluster trace kernels
   (``wrt_trace_closest``, ``wrt_trace_any``: K1; ``wrt_trace_binned``: K4;
   ``wrt_trace_closest_two_level``, ``wrt_trace_any_two_level``: K3;
   ``wrt_trace_pairs``: K2p; ``wrt_trace_pairs_two_level``: K3p;
   ``wrt_trace_sched``: K5; ``wrt_trace_near_closest`` / ``_any`` /
   ``_pairs``: K2n; ``wrt_trace_pipelined_closest`` / ``_any`` /
   ``_pairs``: K2pl; ``wrt_trace_near_closest_two_level`` / ``_any_`` /
   ``_pairs_two_level``: K3 and K3p ordering their supers themselves;
   ``wrt_top_keys``: the ray sort's coherence key; csrc/cluster_trace.cu)
   and ``wrt_camera_rays`` (csrc/raygen.cu) from the checkout into
   build/kernels/.
2b. camera rays (``phase_raygen``): the kernel ``wrt_camera_rays``
   (csrc/raygen.cu) on a config #5 slab (3840x270 = 1,036,800 rays,
   Panini, circle lens, the last slab's rows) and on a 256x256 call
   (pinhole, config #1): o, d and the state bit for bit against the
   plain twin on the CPU, one launch a call; the kernel (on the device
   trace, and back to back by CUDA events) and the twin on the card
   (CUDA events) timed beside the kernel's bound (the twin's
   f32 operations a ray, counted on one ray, over 67 TFLOP/s, or 48
   bytes a ray over 3.35 TB/s, the larger).
2c. shading (``phase_shade``): the kernels ``wrt_shade_hit`` and
   ``wrt_shade_bounce`` (csrc/shade.cu) on the first bounce segment of
   a 1080p env-IS frame of ``stress_scene(44_556)`` (after the scene
   build) and of a config #5 slab (after phase 7's tables; alone:
   ``python -c "import torch, chip_smoke as c;
   c.phase_shade_alone(torch, c.smi())"``): every output bit for bit
   against the plain twins on the CPU; a call dispatches nothing but
   its outputs' allocations; each kernel timed on the device (20 calls
   queued behind a spinning kernel, CUDA events), back to back, and its
   twin on the card, beside its bound (the bytes its lanes need over
   3.35 TB/s, or the twin's f32 operations a lane over 67 TFLOP/s, the
   larger). ``drive_path`` checks two launches a segment on every path.
2d. rederive (``phase_rederive``): the kernel ``wrt_rederive_uv``
   (csrc/rederive.cu) timed on the primary and first-bounce legs of a
   config #5 slab (the last of 8, faces from K3; after phase 7's tables)
   and of the 1080p slice (faces from K2n; alone: ``python -c "import
   torch, chip_smoke as c; c.phase_rederive_alone(torch, c.smi())"``):
   on the device with L2 emptied before each call (a 128 MiB read
   between calls, outside CUDA events around each call), so that its
   time and its bound are both of HBM; back to back (the leg stays in
   L2); and the twin on the card, beside its bound (the bytes its lanes
   need over 3.35 TB/s, or the twin's f32 operations a hit over 67
   TFLOP/s, the larger). Its bits are the card tests'
   (``test_rederive_kernel_matches_twin_on_card``); ``drive_path``
   checks one launch a closest-hit leg on every path.
2e. lights (``phase_light``): the kernels ``wrt_light_sample`` and
   ``wrt_light_add`` (csrc/light.cu) on the 256² direct frame's lanes
   (config #1, after the build) and on a config #5 slab's first-bounce
   lanes under NEE (after phase 7's tables; alone: ``python -c "import
   torch, chip_smoke as c; c.phase_light_alone(torch, c.smi())"``): two
   samples chained around their shadow legs as ``direct_light`` chains
   them, every output bit for bit against the CPU twins, one launch a
   call and nothing dispatched but its outputs' allocations; each kernel
   timed from HBM, back to back, and as the twin on the card, beside its
   bound (bytes over 3.35 TB/s, or the twin's f32 operations a lane over
   67 TFLOP/s, the larger). ``drive_path`` checks two launches a light
   sample on every path (none without NEE).
3. K1 vs twins: on 1080p ray sets of ``stress_scene(44_556)`` made
   from frame 0 exactly as ``path_trace`` makes them, each CUDA entry and
   its plain-torch twin run on the same device tensors. Closest-hit: the
   primary rays and the first bounce set (with source-face exclusion
   codes). Any-hit: the NEE shadow set (light samples, t_max = distance
   to the light point) and the env-NEE set (``sample_env`` directions on
   a 1024x2048 equirect of the procedural sky, t_max = F32_MAX, active =
   hit & facing). Codes must agree on every ray. Both are
   timed with CUDA events; the twin also counts the leg's work, which
   gives the kernel's bound (f32 operations over 67 TFLOP/s, bytes over
   3.35 TB/s, the larger).
   K2p vs twin on the primary and first-bounce sets: t1, the three codes
   and the flag agree on every ray; after
   ``adjudicate_compact`` the faces equal K1's on the same rays (each
   exception printed, with whether it is an exact tie; fail above 1e-5);
   the flag rate; kernel, twin and adjudication timed with CUDA events;
   the bound from the twin's pairs work counts.
   K5 (rounds of 1, 4 and 8 clusters; primary and bounce), K2n, K2pl and
   K2n's pipelined walk (closest-hit on primary and bounce, any-hit on
   the two shadow sets, pairs on primary and bounce) vs their twins on
   the same sets, as above, and vs K1's codes (pairs: K2p's five outputs)
   on the same rays; and K2n's whole leg against the whole K1 route (the
   tile entry distances and the sort as plain torch, then K1), both
   timed. K5 and K2pl return K1's (K2p's) results from K1's inputs, so
   their bound is K1's (K2p's) on the same leg, and K2n's is the bound of
   its pipelined walk; what their twins count beyond that (speculative
   slot and box tests, rounds fetched and not tested; the slots past the
   first hit that a warp's shared any-hit scan tests) is printed as
   ``extra_*``. The entries that order their tiles themselves (K2n; K3
   and K3p with their own super order) must equal their twins and the
   kernels over the order sorted outside on every ray. A pairs bound
   counts what the slot test needs gate by gate (``walk_stats``), and is
   printed beside the bound with every estimate and magnitude counted.
   K4 vs its twin on the bounce leg and the two shadow legs, each sorted
   by nearest cluster with its block schedules as ``binned_trace`` makes
   them, as above (bound from the twin's counts); K1 capped at 4 clusters
   with its stop, and K1 and K2n (closest-hit with ``t_start`` and the
   carried code on the capped pass's survivors; any-hit with ``t_start``
   on K4's survivors) vs their twins. Then the whole binned leg
   (``binned_trace`` on the bounce rays, ``binned_trace_any`` on the
   shadow rays) against ``sorted_trace`` and the unsorted K1 route on the
   same rays: faces (blocked flags) identical, any exception printed with
   whether it is an exact tie; ms per stage (top-3 key, sort, gathers, K4,
   mid pass, drain, unsort), the device-to-host reads counted, and the
   survivor share after pass 1 and after the mid pass; and
   ``sorted_trace_multipass`` (cap 4) the same way.
   The key kernel vs its twin (every int32 key equal, both timed; bound:
   every ray-box slab test, or the bytes) on the bounce leg (top 3), the
   two shadow legs (top 2) and the bounce rays K1 capped at 4 leaves
   unfinished, with ``t_start`` (a multipass leg).
4. the 1080p paths through ``Renderer`` (one warm-up frame, then
   ``--frames`` timed frames; every launch count zeroed just before the
   timed frames and read just after). The default order is made inside
   the kernel (``kernel_near``, K2n), so every default path is driven
   twice: as it is (``tile_nears_fused`` must not be called once) and
   with ``kernel_near=False`` (K1 / K2p over the order sorted outside),
   and the two frames must be equal: same NaN mask, RMSE 0.
   default (procedural sky): finite image, 6 K2n closest-hit launches per
   frame; order outside: 6 K1;
   NEE: 6 closest-hit + 6 any-hit launches/frame of K2n (outside: K1), no
   +-inf pixel (the y = 0 floor's shading points are NaN by the
   reference's own offset rule, so its NEE pixels are NaN; their share is
   printed);
   env-IS on the synthesized equirect: 6 + 6 launches/frame, no +-inf,
   plus the time of ``sample_env`` on 2,073,600 lanes;
   exact pairs (``exact_pairs`` and ``exact_pairs_bounce``): 6 K2n pairs
   launches (outside: 6 K2p) and no closest-hit one per frame; its image
   against the default path's (same seed and frame count): equal NaN
   masks, RMSE < 1e-5.
   The other scheduling kernels walk an order sorted outside, so their
   paths set ``kernel_near=False``: ``trace_sched=4``: 6 K5 launches and
   no K1 closest-hit one per frame; ``pipeline_rounds``: 6 K2pl launches;
   the sorted frame (``sort_bounce_rays`` and ``live_slice``): 6 K1
   launches, and one more frame profiled leg by leg (live count, traced
   width, branch, ms of key, sort, gathers, count read, trace and
   unsort); each against the default path's image: equal NaN masks, RMSE
   < 1e-5.
   NEE with the sort (sliced shadow legs, K1), and NEE with
   ``exact_pairs`` under ``kernel_near``, under ``pipeline_rounds`` and
   under both (2 pairs + 4 closest-hit + 6 any-hit launches of K2n / K2pl
   / K2n per frame), each against the NEE path's image.
   The per-ray-scheduled traces, all with ``sort_bounce_rays`` and, but
   for the last, ``kernel_near=False``: ``binned_sort`` (8 K4 + 6 K1
   launches per frame: two K4 passes and one drain per sorted leg); NEE
   with ``binned_any_sort`` (4 K4, 6 + 6 K1); ``multipass_cap=4`` (10 K1:
   two passes per sorted leg; only K1 can cap); ``binned_sort`` under
   ``kernel_near`` (8 K4 + 6 K2n); each against the default or NEE
   frame: equal NaN masks, RMSE < 1e-5. Every sorted leg computes its
   keys with the key kernel: 4 launches per sorted frame, 8 per NEE
   sorted, binned, binned any-hit or multipass frame.
   Every pixel must hold 2 samples per frame.
5. direct integrator (config #1): the analytic spheres-and-plane scene at
   256x256, ``bounces_depth=1``, perspective: 2 + 2 launches per frame of
   K2n, and of K1 with the order outside, the frames equal.
6. reference: the 32x32 mini scene on the card reproduces the JAX
   package's golden (tests/golden/mini_scene_2f.npz, RMSE < 1e-5); and for
   NEE, ``bounces_depth=1`` and env-IS, the frame on the card equals the
   port's frame on the CPU (the twins the tier-1 tests hold against JAX):
   equal NaN masks, RMSE < 1e-5 over the other pixels.
6b. the rest of the package (``phase_port_completion``, its own JSON line
   ``{"port_completion": ...}``): 1080p sorted frames (``sort_bounce_rays``,
   the order in the kernel) with and without ``chained_sort``, plain and
   NEE, equal bit for bit (6 K2n closest-hit launches a frame, + 6 any-hit
   with NEE), ms/frame of each; ``render_sharded`` over every visible card
   (two slabs on cuda:0 when there is one) against ``render_frame``: one
   1080p frame, and 3 frames with reprojection every 2nd frame, jitter 0.5,
   the hit predictor and a moving camera, image and ``prev_image`` bit for
   bit, ms/frame of both; the threaded and clustered oracles
   (ops/traverse.py, ops/cluster_trace.py) against K2n on 65,536 rays of
   frame 0's primary, bounce and NEE shadow legs: faces (blocked sets)
   equal, each exception classified by exact t (K2n's face never farther;
   the threaded walk's only at an exact tie), ms of each; 256x256 frames
   with ``traversal`` ``"pallas"`` (6 K2n launches) and
   ``"pallas_interpret"`` (the twins, none) equal to the default frame bit
   for bit; the card's 12x12 frame against the WGSL-semantics simulator
   (validation/wgsl_sim.py, seed 777): equal spp, RMSE <= 1e-2.
7. config #5 (BASELINE.md): ``stress_scene(1_000_000)``, two-level tables
   (G = 64), set-up time printed.
   a. K3 vs twins on the rays of one 4K slab (rows 1080-1349 of
      3840x2160, 1,036,800 rays) of frame 0: primary and first bounce
      (closest-hit), NEE shadow (any-hit); as phase 3; and K3p vs twin
      on the primary and bounce rays, its adjudicated faces against K3's.
      The same legs through the entries that order the supers inside the
      kernel, against their twins and against K3 / K3p over the order
      sorted outside: every output bit-equal on every ray.
   The key kernel vs its twin on the slab's bounce rays over the supers.
   b. K3 route vs K1 route on the same primary and bounce rays: the tile
      entry distances over the 227 supers + K3 against those over all
      14,528 clusters + K1; face ids must be identical; both timed, and
      the whole route of K3 with its own order beside them.
   c. the config #5 frame: 3840x2160, ``RenderSettings`` defaults,
      procedural sky, ``frame_slabs=8``, one warm-up and
      ``--config5-frames`` timed frames: 48 launches per frame of K3
      ordering its supers itself and no other, ``tile_nears_fused`` never
      called, 2 samples per pixel per frame, finite image; ms/frame,
      Mrays/s, peak device memory; then the same with
      ``kernel_near=False`` (48 K3 launches over the order sorted
      outside): the frames equal, RMSE 0.
   d. slabs and resume at 960x544 on the same tables: 8 slabs equal 1
      slab bit for bit; a run saved after one frame and resumed in a fresh
      Renderer equals the uninterrupted run bit for bit.
   e. NEE on the 1M scene at 1920x1080 in 4 slabs, one warm-up and one
      timed frame: 24 closest-hit + 24 any-hit launches of K3 with its
      own order, then of K3 with the order outside; frames equal.
   f. the config #5 frame with ``exact_pairs`` (primary legs only, the
      JAX meaning), one warm-up and one timed frame: 16 K3p + 32 K3
      closest-hit launches, with the order inside and outside; finite
      images, equal.

8. the front door (``phase_frontend``): an OBJ/MTL scene written into a
   temporary directory under build/ (a Cornell-style room with a
   ``Light`` material around the spheres of ``stress_scene(22_278)``,
   ten ``o`` groups in the reference's load order: 22,093 triangles,
   44,180 faces two-sided in the eight models of REFERENCE_SUBSET),
   loaded with the native loader (built with g++ from
   webgpu_raytracing_tpu_torch/runtime/loader.cpp; the path it took is
   printed and must be native) and with ``WRT_NO_NATIVE=1``: equal
   tables. ``cli render`` at 1080p, 4 spp, on the card: 12 K2n launches,
   and its PNG byte for byte the PNG of a Renderer built from
   ``load_scene`` on the same files and seed; ``cli bench`` (1 + 4 frames,
   30 launches; its line printed). Each per-pixel feature at 1080p
   (``reprojection_rate=4`` with the camera moved before each frame,
   ``use_hit_predictor``, ``debug_bvh``, ``resolution_scale=0.5``,
   ``geometry_buffer_scale=0.5``) beside the default frame: one warm-up
   and two timed frames, 6 K2n launches a frame, finite accumulation and
   display images, ms/frame, Mrays/s and the display image's ms; at
   64x64 the card's frames against the CPU twins' (equal NaN masks, RMSE
   < 1e-5 on accumulation and display). The predictor-bounded primary
   leg (``t_max`` from the quads of the previous G-buffer) through K2n
   against its twin (0 mismatches) and against the same rays unbounded:
   equal faces wherever the candidate re-hits; both timed. The viewer's
   serve loop on a card Renderer at 1080p in a thread for 40 frames:
   /frame.png and /stats.json over HTTP, a look input that restarts the
   accumulation, a ``set`` of ``resolution_scale``; 240 K2n launches;
   the smoothed ms/frame and Mrays/s printed.

Prints the per-kernel JSON line (twenty entries, camera rays and shading
last;
K2n's entries hold the predictor-bounded leg, the front door's numbers
and the oracle checks), then the ``nvidia-smi`` name/power line, then ``{"ok": true, "device": {...}}`` as
the last line.
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
CONFIG5_TRIANGLES = 1_000_000
CONFIG5 = dict(width=3840, height=2160, frame_slabs=8)
CONFIG5_SLAB = 4  # the slab (of 8) whose frame-0 rays phase 7 compares
CONFIG5_CHECK = (960, 544)  # width, height of the slabs and resume checks
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


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
    _build.load()  # binds every entry, or raises
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(so)}", flush=True)


def _time_cuda(torch, fn, reps: int, warm: bool = True) -> float:
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _f32_ops(torch, fn) -> int:
    """The f32 arithmetic of ``fn()`` run on one lane (each add, subtract,
    multiply, divide, square root, round, negation, clamp and max counted
    once per element)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "sqrt", "round", "neg",
             "clamp", "clamp_min", "amax"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__.rstrip("_") in arith
                    and isinstance(out, torch.Tensor)
                    and out.dtype == torch.float32):
                Count.ops += out.numel()
            return out

    with Count():
        fn()
    return Count.ops


def _raygen_ops(torch, st) -> int:
    """The plain twin's f32 arithmetic on one ray of ``st``: the camera
    rays kernel's operations a ray."""
    from webgpu_raytracing_tpu_torch.ops import rng
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    return _f32_ops(torch, lambda: camera_rays.twin(
        torch.tensor([[10.5, 20.25]]), torch.eye(4),
        rng.seed_state(5, torch.arange(1)), st))


def _queued_ms(torch, fn, reps: int):
    """The device's time for one ``fn()``, ``reps`` calls queued behind a
    spinning kernel of some 50 ms so that the host's enqueue is out of the
    measure (the device runs them back to back once it wakes), by CUDA
    events → (ms a call, the host's ms to queue one)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def _cold_ms(torch, fn, reps: int) -> float:
    """The device's time for one ``fn()`` whose inputs come from HBM:
    before each of ``reps`` calls a 128 MiB read (more than the card's 50
    MB L2) evicts them, and CUDA events around each call leave the read
    out; all queued behind a spinning kernel so that the host's enqueue
    is out of the measure too → ms a call (the mean)."""
    junk = torch.zeros(2**25, dtype=torch.float32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        junk.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def _Dispatched(torch):
    """A dispatch mode that records the name of every PyTorch operation
    run inside it (``.names``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Dispatched(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    return Dispatched()


def _shade_segment(torch, tables, st, row0, rows, seed):
    """The shading steps' arguments of a real bounce segment: camera rays
    of ``rows`` rows of ``st``'s frame from ``row0``, their closest hits,
    the first segment's shading and bounce, and the hits of the bounce
    rays → (the arguments of ``shade_hit`` at segment 1, the state words,
    the origins) on the card."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.ops import integrator as ti
    from webgpu_raytracing_tpu_torch.ops import rng
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    dev = torch.device(DEVICE)
    w = st.render_width
    ys, xs = np.meshgrid(np.arange(row0, row0 + rows), np.arange(w),
                         indexing="ij")
    pos = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    pos += np.random.default_rng(seed).uniform(0, 1, pos.shape).astype(
        np.float32)
    idx = torch.from_numpy((xs + ys * w).reshape(-1)).to(dev)
    o, d, state = camera_rays(torch.from_numpy(pos).to(dev),
                              torch.as_tensor(Camera().view_matrix(),
                                              device=dev),
                              rng.seed_state(seed, idx), st)
    r = o.shape[0]
    env_is = st.env_importance_sampling
    t_max = torch.full((r,), F32_MAX, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    zeros3 = torch.zeros((r, 3), device=dev)
    prev = torch.zeros((r,), device=dev)
    hit = ti.trace_closest(o, d, t_max, tables, st, alive, primary=True)
    sh = ti.shade_hit(hit, alive, d, zeros3, torch.ones((r, 3), device=dev),
                      zeros3, zeros3, torch.full((r,), -1.0, device=dev),
                      prev, tables, st.shading_type, False)
    b = ti.shade_bounce(state, sh.h, sh.n, sh.new_o, sh.throughput, o, d,
                        prev, env_is, env_is)
    hit = ti.trace_closest(b.o, b.d, t_max, tables, st, b.alive, sh.excl,
                           seg=1)
    return (hit, b.alive, b.d, sh.color, b.throughput, sh.env_dir, sh.env_w,
            sh.env_mis_pdf, b.prev_bsdf_pdf, tables, st.shading_type,
            env_is), b.state, b.o


def phase_shade(torch, card, name, tables, st, row0, rows, seed=27182818):
    """Phase 2c: shading's two kernels on the bounce segment of ``rows``
    rows of ``st``'s frame (``_shade_segment``): every output bit for bit
    against the CPU twin; a call dispatches no PyTorch operation but its
    outputs' allocations, so its one launch is the kernel; each kernel
    timed on the device (``_queued_ms``) and back to back, and its twin
    on the card,
    beside the bound (the bytes these lanes need, as ``csrc/shade.cu``
    counts them, over 3.35 TB/s, or the twin's f32 operations a lane over
    67 TFLOP/s, the larger) → the call's entry."""
    from webgpu_raytracing_tpu_torch.config import ShadingType
    from webgpu_raytracing_tpu_torch.ops import integrator as ti
    from webgpu_raytracing_tpu_torch.ops.intersect import Hit

    hit_args, state, o = _shade_segment(torch, tables, st, row0, rows, seed)
    r = state.shape[0]
    phong = st.shading_type == ShadingType.PHONG
    env_is = st.env_importance_sampling
    sh = ti.shade_hit(*hit_args)

    def bounce(fn=ti.shade_bounce):
        return fn(state, sh.h, sh.n, sh.new_o, sh.throughput, o,
                  hit_args[2], hit_args[8], env_is, env_is)

    b = bounce()
    torch.cuda.synchronize()

    cpu_tables = tables.to("cpu")
    cpu_args = [Hit(*[v.cpu() for v in hit_args[0]])] + [
        a.cpu() if isinstance(a, torch.Tensor) else a for a in hit_args[1:]]
    cpu_args[9] = cpu_tables
    want = ti.shade_hit.twin(*cpu_args)
    want_b = ti.shade_bounce.twin(state.cpu(), want.h, want.n, want.new_o,
                                  want.throughput, o.cpu(), cpu_args[2],
                                  cpu_args[8], env_is, env_is)
    for what, got_t, want_t in (("hit", sh, want), ("bounce", b, want_b)):
        for field, g, w in zip(type(got_t)._fields, got_t, want_t):
            if w is None:
                continue
            g = g.cpu()
            if g.dtype == torch.float32:
                nan = torch.isnan(w)
                same = torch.equal(torch.isnan(g), nan) and torch.equal(
                    g.masked_fill(nan, 0).view(torch.int32),
                    w.masked_fill(nan, 0).view(torch.int32))
            else:
                same = torch.equal(g, w)
            if not same:
                fail(f"shade {name}: {what}.{field} differs from the CPU "
                     "twin")

    calls = {"hit": lambda: ti.shade_hit(*hit_args), "bounce": bounce}
    plain = {"hit": lambda: ti.shade_hit.twin(*hit_args),
             "bounce": lambda: bounce(ti.shade_bounce.twin)}
    # the bytes these lanes need (csrc/shade.cu), each read or written once
    n_h = int(sh.h.sum())
    n_miss = int((hit_args[1] & (hit_args[0].face < 0)).sum())
    n_end = r - int(b.alive.sum())
    pc = tables.clusters.partner_code is not None
    env_mis = hit_args[11]
    nbytes = {
        "hit": r * (49 + 4 * env_mis) + 12 * (r - n_miss)
        + n_h * (4 + 36 + (48 if phong else 12) + 4 * pc)
        + 24 * tables.mat_color.shape[0] + r * (73 + 4 * pc + 4 * env_mis),
        # n only where the path goes on, or on every hit lane for env-IS's
        # BSDF pdf; d only where it ends
        "bounce": r * 33 + 12 * (n_h if env_is else r - n_end) + 12 * n_end
        + 4 * env_is * (r - n_h) + r * (45 + 4 * env_is),
    }
    one = [Hit(*[v[:1] for v in cpu_args[0]])] + [
        a[:1] if isinstance(a, torch.Tensor) else a for a in cpu_args[1:]]
    one[9] = cpu_tables
    ops = {"hit": _f32_ops(torch, lambda: ti.shade_hit.twin(*one)),
           "bounce": _f32_ops(torch, lambda: ti.shade_bounce.twin(
               state[:1].cpu(), want.h[:1], want.n[:1], want.new_o[:1],
               want.throughput[:1], o[:1].cpu(), cpu_args[2][:1],
               cpu_args[8][:1], env_is, env_is))}
    out = dict(lanes=r, hit_lanes=n_h, missed_lanes=n_miss,
               ended_lanes=n_end, shading=st.shading_type.name,
               env_is=env_is, mismatch=0)
    for k in ("hit", "bounce"):
        ms = _time_cuda(torch, calls[k], 50)
        with _Dispatched(torch) as seen:
            calls[k]()
        if set(seen.names) != {"empty"}:
            fail(f"shade {name}: a {k} call dispatches {seen.names}, not "
                 "only its outputs' allocations")
        device_ms, host_ms = _queued_ms(torch, calls[k], 20)
        plain_ms = _time_cuda(torch, plain[k], 3)
        ops_ms = ops[k] * r / PEAK_F32 * 1e3
        bytes_ms = nbytes[k] / PEAK_BYTES * 1e3
        out[k] = dict(ms=device_ms, ms_back_to_back=ms,
                      host_ms_to_queue=host_ms, plain_ms=plain_ms,
                      bound_ms=max(ops_ms, bytes_ms),
                      bound_by="operations" if ops_ms >= bytes_ms
                      else "bytes", ops_per_lane=ops[k], bytes=nbytes[k])
        print(f"shade {name} {k}: {r} lanes ({n_h} hit, {n_miss} missed, "
              f"{n_end} ended) bit for bit against "
              f"the CPU twin; kernel {device_ms:.4f} ms on the device, queued "
              f"behind a sleep ({ms:.4f} ms a call back to back, "
              f"{host_ms:.4f} ms of host to queue one), twin on the card "
              f"{plain_ms:.3f} ms, bound {out[k]['bound_ms']:.4f} ms by "
              f"{out[k]['bound_by']} ({nbytes[k]} B, {ops[k]} f32 ops a "
              f"lane) ({card})", flush=True)
    out["ms"] = out["hit"]["ms"] + out["bounce"]["ms"]
    out["plain_ms"] = out["hit"]["plain_ms"] + out["bounce"]["plain_ms"]
    out["bound_ms"] = out["hit"]["bound_ms"] + out["bounce"]["bound_ms"]
    out["bound_by"] = out["hit"]["bound_by"]
    return out


def phase_shade_alone(torch, card):
    """Phase 2c by itself: the config #5 slab (the last of 8, Panini) and
    the 1080p env-IS frame of ``stress_scene(44_556)`` (config #3's
    settings; the kernels never read the sky)."""
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    dev = torch.device(DEVICE)
    return {
        "config5_slab": phase_shade(
            torch, card, "config5_slab",
            stress_scene(CONFIG5_TRIANGLES).tables(dev),
            RenderSettings(**CONFIG5), 1890, 270),
        "envis_1080p": phase_shade(
            torch, card, "envis_1080p", stress_scene(N_TRIANGLES).tables(dev),
            RenderSettings(**SLICE).replace(
                environment="equirect", env_importance_sampling=True),
            0, 1080),
    }


def phase_rederive(torch, card, name, tables, st, row0, rows, seed=0):
    """Phase 2d: the rederive kernel on frame 0's primary and first-bounce
    legs of ``rows`` rows of ``st``'s frame from ``row0``
    (:func:`frame0_legs`), each ray's face from the closest-hit kernel of
    the frame's route (K3 or K2n): timed on the device from HBM
    (:func:`_cold_ms`), back to back from L2, and as the twin on the
    card, beside the bound → the legs' entries and the bounce leg's
    times."""
    import types

    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops.cluster_trace import rederive_uv

    legs = frame0_legs(torch, tables, st, seed, row0=row0, rows=rows)
    out = {}
    for leg_name in ("primary", "bounce"):
        leg = legs[leg_name]
        t, face = cc.trace_closest_clustered_cuda(
            tables=tables, tile=st.trace_tile, kernel_near=True, raw=True,
            **leg)
        args = (leg["o"], leg["d"], t, face, tables)
        r = face.shape[0]
        n_hit = int((face >= 0).sum())
        # a hit reads face, o, d and its triangle row; a miss face and t;
        # each writes t, u, v (csrc/rederive.cu)
        nbytes = n_hit * (4 + 24 + 36 + 12) + (r - n_hit) * (4 + 4 + 12)
        i = int(torch.nonzero(face >= 0)[0])
        cpu_one = [a[i:i + 1].cpu() for a in args[:4]]
        ops = _f32_ops(torch, lambda: rederive_uv.twin(
            *cpu_one, types.SimpleNamespace(tri=tables.tri.cpu())))

        def call():
            return rederive_uv(*args)

        ms = _cold_ms(torch, call, 20)
        warm_ms, host_ms = _queued_ms(torch, call, 20)
        plain_ms = _time_cuda(torch, lambda: rederive_uv.twin(*args), 3)
        ops_ms = ops * n_hit / PEAK_F32 * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        out[leg_name] = dict(
            rays=r, hits=n_hit, ms=ms, ms_l2_warm=warm_ms,
            host_ms_to_queue=host_ms, plain_ms=plain_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            ops_per_hit=ops, bytes=nbytes)
        print(f"rederive {name} {leg_name}: {r} rays ({n_hit} hits); "
              f"kernel {ms:.4f} ms from HBM (L2 emptied before each call), "
              f"{warm_ms:.4f} ms a call back to back from L2, "
              f"{host_ms:.4f} ms of host to queue one; twin on the card "
              f"{plain_ms:.3f} ms; bound {out[leg_name]['bound_ms']:.4f} ms "
              f"by {out[leg_name]['bound_by']} ({nbytes} B, {ops} f32 ops "
              f"a hit) ({card})", flush=True)
    out.update({k: out["bounce"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")})
    return out


def phase_rederive_alone(torch, card):
    """Phase 2d by itself: the config #5 slab (the last of 8) and the
    1080p slice."""
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    dev = torch.device(DEVICE)
    return {
        "config5_slab": phase_rederive(
            torch, card, "config5_slab",
            stress_scene(CONFIG5_TRIANGLES).tables(dev),
            RenderSettings(**CONFIG5), 1890, 270),
        "slice_1080p": phase_rederive(
            torch, card, "slice_1080p", stress_scene(N_TRIANGLES).tables(dev),
            RenderSettings(**SLICE), 0, 1080),
    }


def _nee_lanes(torch, tables, st, row0, rows, seed):
    """A config #5-like bounce segment under NEE (``_shade_segment`` and
    its ``shade_hit``): the shading points, normals, RNG states, hit
    lanes and exclusion codes ``direct_light`` takes there."""
    from webgpu_raytracing_tpu_torch.ops import integrator as ti

    hit_args, state, _ = _shade_segment(torch, tables, st, row0, rows, seed)
    sh = ti.shade_hit(*hit_args)
    return sh.new_o, sh.n, state, sh.h, sh.excl


def _direct_lanes(torch, tables, st, seed):
    """``trace_direct``'s first sample of ``st``'s frame: camera rays,
    their closest hits, and the shading points, normals, RNG states, hit
    lanes and exclusion codes its ``direct_light`` takes."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.ops import integrator as ti
    from webgpu_raytracing_tpu_torch.ops import rng
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    dev = torch.device(DEVICE)
    w, h = st.render_width, st.render_height
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    pos += np.random.default_rng(seed).uniform(0, 1, pos.shape).astype(
        np.float32)
    idx = torch.from_numpy((xs + ys * w).reshape(-1)).to(dev)
    o, d, state = camera_rays(torch.from_numpy(pos).to(dev),
                              torch.as_tensor(Camera().view_matrix(),
                                              device=dev),
                              rng.seed_state(seed, idx), st)
    hit = ti.trace_closest(o, d, torch.full((o.shape[0],), F32_MAX,
                                            device=dev), tables, st,
                           primary=True)
    found = hit.face >= 0
    face = hit.face.clamp(min=0).long()
    shade = tables.shade_normal[face]
    n = ti.face_normal(shade, hit.u, hit.v, st.shading_type)
    point = ti.face_point_offset(tables.tri[face], shade, hit.u, hit.v)
    pc = tables.clusters.partner_code
    excl = None if pc is None else torch.where(
        found, pc[face], torch.full_like(hit.face, -1))
    return point, n, state, found, excl


def phase_light(torch, card, name, tables, st, lanes):
    """Phase 2e: the lights' two kernels on ``lanes`` (``_nee_lanes`` or
    ``_direct_lanes``), two samples chained as ``direct_light`` chains
    them around their shadow legs: every output bit for bit against the
    CPU twins; one launch a call and nothing dispatched but its outputs'
    allocations; each kernel (the add as at one sample a point: no colour
    in, the division) timed on the device from HBM (:func:`_cold_ms`),
    back to back from L2 (:func:`_queued_ms`), and as the twin on the
    card, beside its bound (the bytes its lanes need over 3.35 TB/s, or
    the twin's f32 operations a lane over 67 TFLOP/s, the larger) → the
    call's entry."""
    from webgpu_raytracing_tpu_torch.ops import integrator as ti

    point, normal, state, active, excl = lanes
    r = point.shape[0]
    cpu_tables = tables.to("cpu")
    cpu = [x.cpu() for x in (point, normal)]
    state_cpu, color, color_cpu = state.cpu(), None, None
    n_shadowed = 0
    for k in range(2):
        before = ti.light_sample.launches, ti.light_add.launches
        with _Dispatched(torch) as seen:
            ray = ti.light_sample(point, state, tables)
        shadowed = ti.trace_any(point, ray.d, ray.t_max, tables, st, active,
                                excl)
        with _Dispatched(torch) as seen_add:
            color = ti.light_add(shadowed, ray.d, normal, ray.carry, color,
                                 tables, 2, k == 1)
        torch.cuda.synchronize()
        if (ti.light_sample.launches - before[0],
                ti.light_add.launches - before[1]) != (1, 1):
            fail(f"light {name}: not one launch a call")
        if set(seen.names) != {"empty"} or set(seen_add.names) != {"empty"}:
            fail(f"light {name}: a call dispatches {seen.names} / "
                 f"{seen_add.names}, not only its outputs' allocations")
        want = ti.light_sample.twin(cpu[0], state_cpu, cpu_tables)
        shadowed_cpu = shadowed.cpu()
        want_c = ti.light_add.twin(shadowed_cpu, want.d, cpu[1], want.carry,
                                   color_cpu, cpu_tables, 2, k == 1)
        for field, g, w in [*zip(ti.LightRay._fields, ray, want),
                            ("color", color, want_c)]:
            g = g.cpu()
            if g.dtype == torch.float32:
                nan = torch.isnan(w)
                same = torch.equal(torch.isnan(g), nan) and torch.equal(
                    g.masked_fill(nan, 0).view(torch.int32),
                    w.masked_fill(nan, 0).view(torch.int32))
            else:
                same = torch.equal(g, w)
            if not same:
                fail(f"light {name}: sample {k}'s {field} differs from the "
                     "CPU twin")
        n_shadowed += int(shadowed.sum())
        state, state_cpu, color_cpu = ray.state, want.state, want_c

    ray = ti.light_sample(point, state, tables)
    shadowed = ti.trace_any(point, ray.d, ray.t_max, tables, st, active,
                            excl)
    calls = {"sample": lambda: ti.light_sample(point, state, tables),
             "add": lambda: ti.light_add(shadowed, ray.d, normal, ray.carry,
                                         None, tables, 1, True)}
    plain = {"sample": lambda: ti.light_sample.twin(point, state, tables),
             "add": lambda: ti.light_add.twin(shadowed, ray.d, normal,
                                              ray.carry, None, tables, 1,
                                              True)}
    one = [x[:1].cpu() for x in (point, normal, state, shadowed)]
    one_ray = ti.light_sample.twin(one[0], one[2], cpu_tables)
    ops = {"sample": _f32_ops(torch, lambda: ti.light_sample.twin(
               one[0], one[2], cpu_tables)),
           "add": _f32_ops(torch, lambda: ti.light_add.twin(
               one[3], one_ray.d, one[1], one_ray.carry, None, cpu_tables,
               1, True))}
    # the bytes each lane reads and writes once (csrc/light.cu), and the
    # light's rows (triangle, face normal, material) and the emissions
    n_light = int(tables.model_face_count[0])
    nbytes = {"sample": r * (20 + 36) + n_light * (36 + 12 + 4),
              "add": r * (37 + 12) + 12 * tables.mat_emission.shape[0]}
    out = dict(lanes=r, active_lanes=int(active.sum()),
               shadowed_per_sample=n_shadowed / 2, light_faces=n_light,
               mismatch=0)
    for k in ("sample", "add"):
        ms = _cold_ms(torch, calls[k], 20)
        warm_ms, host_ms = _queued_ms(torch, calls[k], 20)
        plain_ms = _time_cuda(torch, plain[k], 3)
        ops_ms = ops[k] * r / PEAK_F32 * 1e3
        bytes_ms = nbytes[k] / PEAK_BYTES * 1e3
        out[k] = dict(ms=ms, ms_l2_warm=warm_ms, host_ms_to_queue=host_ms,
                      plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                      bound_by="operations" if ops_ms >= bytes_ms
                      else "bytes", ops_per_lane=ops[k], bytes=nbytes[k])
        print(f"light {name} {k}: {r} lanes ({out['active_lanes']} active, "
              f"{n_shadowed / 2:.0f} shadowed a sample, {n_light} light "
              "faces) bit for bit against the CPU twin over two samples; "
              f"kernel {ms:.4f} ms from HBM (L2 emptied before each call), "
              f"{warm_ms:.4f} ms a call back to back from L2, "
              f"{host_ms:.4f} ms of host to queue one; twin on the card "
              f"{plain_ms:.3f} ms; bound {out[k]['bound_ms']:.4f} ms by "
              f"{out[k]['bound_by']} ({nbytes[k]} B, {ops[k]} f32 ops a "
              f"lane) ({card})", flush=True)
    for k in ("ms", "plain_ms", "bound_ms"):
        out[k] = out["sample"][k] + out["add"][k]
    out["bound_by"] = out["sample"]["bound_by"]
    return out


def phase_light_alone(torch, card):
    """Phase 2e by itself: a config #5 slab's first-bounce lanes under NEE
    (the last of 8) and the 256² direct frame's lanes (config #1)."""
    from webgpu_raytracing_tpu_torch.config import (
        ProjectionType, RenderSettings,
    )
    from webgpu_raytracing_tpu_torch.frontend.cli import analytic_scene
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    dev = torch.device(DEVICE)
    st = RenderSettings(width=256, height=256, bounces_depth=1,
                        projection_type=ProjectionType.PERSPECTIVE)
    tables = analytic_scene().tables(dev)
    out = {"direct_256": phase_light(torch, card, "direct_256", tables, st,
                                     _direct_lanes(torch, tables, st, 0))}
    tables = stress_scene(CONFIG5_TRIANGLES).tables(dev)
    st = RenderSettings(next_event_estimation=True, **CONFIG5)
    out["config5_slab_nee"] = phase_light(
        torch, card, "config5_slab_nee", tables, st,
        _nee_lanes(torch, tables, st, 1890, 270, 27182818))
    return out


def phase_raygen(torch, card):
    """Phase 2b: the camera rays kernel against the CPU twin, timed beside
    its bound and the twin on the card → its ``kernels`` entry."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.config import (
        ProjectionType, RenderSettings,
    )
    from webgpu_raytracing_tpu_torch.ops import rng
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    dev = torch.device(DEVICE)
    calls = {
        "config5_slab": (RenderSettings(**CONFIG5), 1890, 270),
        "analytic_256": (RenderSettings(
            width=256, height=256,
            projection_type=ProjectionType.PERSPECTIVE), 0, 256),
    }
    out = {}
    for name, (st, row0, rows) in calls.items():
        w = st.render_width
        gen = np.random.default_rng(7)
        ys, xs = np.meshgrid(np.arange(row0, row0 + rows), np.arange(w),
                             indexing="ij")
        pos = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
        pos += gen.uniform(0.0, 1.0, pos.shape).astype(np.float32)
        pos = torch.from_numpy(pos).to(dev)
        view = torch.as_tensor(Camera().view_matrix(), device=dev)
        idx = torch.from_numpy((xs + ys * w).reshape(-1)).to(dev)
        state = rng.seed_state(3141592653, idx)
        r = pos.shape[0]
        before = camera_rays.launches
        got = camera_rays(pos, view, state, st)
        torch.cuda.synchronize()
        if camera_rays.launches != before + 1:
            fail(f"camera rays {name}: {camera_rays.launches - before} "
                 "launches for one call")
        want = camera_rays.twin(pos.cpu(), view.cpu(), state.cpu(), st)
        for what, g, x in zip(("o", "d", "state"), got, want):
            if not torch.equal(g.cpu().contiguous().view(torch.int32),
                               x.contiguous().view(torch.int32)):
                fail(f"camera rays {name}: {what} differs from the CPU twin")
        ms = _time_cuda(torch, lambda: camera_rays(pos, view, state, st), 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                camera_rays(pos, view, state, st)
            torch.cuda.synchronize()
        kern = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(kern) != 20:
            fail(f"camera rays {name}: {len(kern)} device operations for 20 "
                 "calls")
        device_ms = sum(kern) / len(kern) / 1e3
        plain_ms = _time_cuda(
            torch, lambda: camera_rays.twin(pos, view, state, st), 3)
        ops = _raygen_ops(torch, st) * r
        nbytes = 48 * r + 64
        ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = dict(
            rays=r, projection=st.projection_type.name, ms=device_ms,
            ms_back_to_back=ms, plain_ms=plain_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            ops=ops, bytes=nbytes, mismatch=0)
        print(f"camera rays {name}: {r} rays bit for bit against the CPU "
              f"twin; kernel {device_ms:.4f} ms on the device trace "
              f"({ms:.4f} ms a call back to back), twin on the card "
              f"{plain_ms:.3f} ms, bound {out[name]['bound_ms']:.4f} ms by "
              f"{out[name]['bound_by']} ({card})", flush=True)
    return out


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


def _bound(name, work, needs=None):
    """The least time the card could take for a leg → the ``bound_*``,
    ``ops``, ``bytes`` and test counts of its result. ``work`` is what the
    kernel's twin counted. A kernel that returns another's results from
    the same inputs by a route with speculative work (K5, K2pl: K1's or
    K2p's; K2n's pipelined walk: K2n's) is bound by that other leg's
    counts, ``needs`` (its result); so is a kernel whose warps share
    any-hit scans (K2n, K3) by the sequential scan's counts on its own
    leg. What the twin counted beyond them is reported as ``extra_*``: the
    kernel's cost, not its function's."""
    need = work if needs is None else needs
    extra = {}
    if needs is not None:
        extra = {f"extra_{k}": work[k] - needs[k]
                 for k in ("slot_tests", "box_tests", "ops", "bytes")}
        if min(extra.values()) < 0:
            fail(f"{name}: the twin counted less work than the leg that "
                 f"bounds it: {extra}")
    ops_ms = need["ops"] / PEAK_F32 * 1e3
    bytes_ms = need["bytes"] / PEAK_BYTES * 1e3
    out = dict(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops=need["ops"], bytes=need["bytes"],
               box_tests=need["box_tests"], slot_tests=need["slot_tests"],
               **extra)
    if "ops_full_test" in need:  # pairs: also with every term counted
        out["ops_full_test"] = need["ops_full_test"]
        out["bound_ms_full_test"] = max(
            need["ops_full_test"] / PEAK_F32 * 1e3, bytes_ms)
    return out


def _compare_leg(torch, name, args, card, any_hit=False, ref_code=None,
                 needs=None, wrapper=None, ref_out=None):
    """One leg through the kernel entry that ``args`` is for (its
    ``variant``) and its twin on the same device tensors: codes (any-hit:
    flags too) must agree on every ray; closest-hit t must be bit-equal
    where they do. The twin counts
    the leg's work, which bounds the kernel, unless ``needs`` names the
    leg whose counts do (:func:`_bound`). ``ref_code``: K1's codes on the
    same rays, which the kernel's must equal. ``ref_out``: (its name, the
    outputs of the kernel that walks the order sorted outside on the same
    rays), which this kernel's must equal bit for bit, t included, on
    every ray. ``wrapper``: the kernel, where ``args`` is no
    ``prepare_tiles`` dict (K4). A capped leg (``return_stop``) also
    returns its stop, which must be equal too."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    if wrapper is None:
        wrapper = (cc.trace_any_args if any_hit
                   else cc.trace_closest_args)(args)[0]
    twin = wrapper.twin
    n_rays = args["o"].shape[0]
    live = int((args["t_max"] > 0).sum())
    before = wrapper.launches
    out_k = wrapper(**args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"{name}: kernel launch was not counted")
    stats = {}
    t0 = time.perf_counter()
    out_w = twin(**args, stats=stats)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    code_k, code_w = (out_k, out_w) if any_hit else (out_k[1], out_w[1])
    if not any_hit and len(out_k) == 3 and not torch.equal(out_k[2],
                                                          out_w[2]):
        fail(f"{name}: kernel and twin stops differ on "
             f"{int((out_k[2] != out_w[2]).sum())} rays")
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
    ms_w = _time_cuda(torch, lambda: twin(**args), 1, warm=False)
    work = cc.walk_stats(stats, args["face_id"], any_hit, kernel=True)
    if needs is None and "kernel_slot_tests" in stats:
        needs = cc.walk_stats(stats, args["face_id"], any_hit)
    bound = _bound(name, work, needs)
    extra = {k: v for k, v in bound.items() if k.startswith("extra_")}
    what = "blocked" if any_hit else "hits"
    print(f"{name}: {n_rays} rays ({live} live), {hits} {what}, code "
          f"mismatches {mismatch}, flag mismatches {flag_mismatch}, max abs "
          f"err {max_abs:g}; kernel {ms_k:.3f} ms, twin {ms_w:.3f} ms "
          f"(counting run {counted_s:.1f} s); work {work['box_tests']} box "
          f"tests, {work['slot_tests']} slot tests, {work['ops']} f32 ops, "
          f"{work['bytes']} bytes"
          + (f", beyond what the function needs {extra}" if extra else "")
          + f" -> bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"({card})", flush=True)
    if max(mismatch, flag_mismatch):
        fail(f"{name}: {mismatch} code mismatches, {flag_mismatch} flag "
             "mismatches against the twin")
    if not any_hit and max_abs != 0.0:
        fail(f"{name}: kernel and twin t differ where faces agree")
    vs_k1 = None
    if ref_code is not None:
        vs_k1 = int((code_k != ref_code).sum())
        print(f"{name}: codes that differ from K1's on the same rays: "
              f"{vs_k1}", flush=True)
        if vs_k1:
            fail(f"{name}: {vs_k1} codes differ from K1's")
    if ref_out is not None:
        ref_name, ref = ref_out
        mine = (out_k,) if any_hit else tuple(out_k)
        ref = (ref,) if any_hit else tuple(ref)
        vs_k1 = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                    for a, b in zip(mine, ref))
        print(f"{name}: outputs that differ from {ref_name}'s over the order "
              f"sorted outside, bit for bit: {vs_k1}", flush=True)
        if vs_k1:
            fail(f"{name}: {vs_k1} outputs differ from {ref_name}'s")
    return dict(n=n_rays, live=live, hits=hits, mismatch=mismatch,
                vs_k1=vs_k1, staged_rounds=stats.get("staged_rounds"),
                flag_mismatch=flag_mismatch, max_abs=max_abs, ms=ms_k,
                plain_ms=ms_w, **bound)


def _compare_pairs_leg(torch, name, leg, tables, card, tile, needs=None,
                       **prep_kw):
    """One closest-hit leg through its pairs entry (K3p for two-level
    tables, K2n or K2pl with ``prep_kw``, else K2p) and its twin on the
    same device tensors: t1, c1, c2, c3 and the flag must agree bit for
    bit on every ray (with ``prep_kw`` also with K2p's, or K3p's over the
    order sorted outside); then ``adjudicate_compact`` on the
    kernel's candidates, whose faces must equal the K1/K3 route's on the
    same rays (each exception printed, with its exact t for both faces).
    ``needs``: the leg whose counts bound this one (:func:`_bound`)."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops.adjudicate import adjudicate_compact
    from webgpu_raytracing_tpu_torch.ops.cluster_trace import exact_face_eval

    args = cc.prepare_tiles(tables=tables, tile=tile, pairs=True, **leg,
                            **prep_kw)
    wrapper, twin = cc.trace_pairs_args(args)
    n_rays = args["a"].shape[0]
    if n_rays != leg["o"].shape[0]:
        fail(f"{name}: the leg is not a whole number of tiles")
    live = args["t_max"] > 0
    before = wrapper.launches
    out_k = wrapper(**args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"{name}: pairs kernel launch was not counted")
    stats = {}
    t0 = time.perf_counter()
    out_w = twin(**args, stats=stats)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    t_k, t_w = out_k[0].view(torch.int32), out_w[0].view(torch.int32)
    differ = t_k != t_w
    for x, y in zip(out_k[1:], out_w[1:]):
        differ |= x != y
    mismatch = int(differ.sum())
    for i in torch.nonzero(differ).flatten()[:10].tolist():
        print(f"{name}: ray {i}: kernel (t1, c1, c2, c3, amb) "
              f"{[float(out_k[0][i])] + [int(x[i]) for x in out_k[1:]]}, "
              f"twin {[float(out_w[0][i])] + [int(x[i]) for x in out_w[1:]]}",
              flush=True)
    both = (out_k[1] == out_w[1]) & (out_k[1] >= 0)
    max_abs = float((out_k[0][both] - out_w[0][both]).abs().max()) if (
        bool(both.any())) else 0.0
    amb_rate = float(out_k[4][live].float().mean())
    vs_k2p = None
    if prep_kw:
        ref_args = cc.prepare_tiles(tables=tables, tile=tile, pairs=True,
                                    **leg)
        ref_wrapper = cc.trace_pairs_args(ref_args)[0]  # K2p, or K3p
        ref = ref_wrapper(**ref_args)
        off = out_k[0].view(torch.int32) != ref[0].view(torch.int32)
        for x, y in zip(out_k[1:], ref[1:]):
            off |= x != y
        vs_k2p = int(off.sum())
        del ref, off, ref_args
        print(f"{name}: outputs that differ from {ref_wrapper.__name__}'s "
              f"on the same rays: {vs_k2p}", flush=True)
        if vs_k2p:
            fail(f"{name}: {vs_k2p} outputs differ from "
                 f"{ref_wrapper.__name__}'s")

    fid = tables.clusters.face_id
    faces = tuple(cc.code_to_face(c, fid) for c in out_k[1:4])
    tfb = args["t_max"]

    def adjudicate():
        return adjudicate_compact(leg["o"], leg["d"], tfb, out_k[0], faces,
                                  out_k[4], tables)

    hit = adjudicate()
    plain_args = cc.prepare_tiles(tables=tables, tile=tile, **leg)
    route = cc.trace_closest_args(plain_args)[0]
    ref_face = cc.code_to_face(route(**plain_args)[1], fid)
    bad = torch.nonzero(hit.face != ref_face).flatten()
    ties = 0
    for n_shown, i in enumerate(bad[:1000].tolist()):
        o_i, d_i = leg["o"][i : i + 1], leg["d"][i : i + 1]
        ts = []
        for f in (int(hit.face[i]), int(ref_face[i])):
            ok, t, _, _ = exact_face_eval(
                o_i, d_i, tables.tri[max(f, 0) : max(f, 0) + 1],
                torch.tensor([f >= 0], device=o_i.device), tfb[i : i + 1])
            ts.append(float(t[0]) if bool(ok[0]) else None)
        tie = ts[0] is not None and ts[0] == ts[1]
        ties += tie
        if n_shown < 10:
            print(f"{name}: ray {i}: adjudicated face {int(hit.face[i])} "
                  f"(exact t {ts[0]}), plain route face {int(ref_face[i])} "
                  f"(exact t {ts[1]}){', an exact tie' if tie else ''}",
                  flush=True)
    ms_k = _time_cuda(torch, lambda: wrapper(**args), 5)
    ms_w = _time_cuda(torch, lambda: twin(**args), 1, warm=False)
    ms_adj = _time_cuda(torch, adjudicate, 5)
    work = cc.walk_stats(stats, fid, any_hit=False, pairs=True)
    bound = _bound(name, work, needs)
    steps = {k: stats.get(k, 0) for k in cc.PAIRS_STEP_OPS}
    extra = {k: v for k, v in bound.items() if k.startswith("extra_")}
    print(f"{name}: {n_rays} rays ({int(live.sum())} live), "
          f"{int((out_k[1] >= 0).sum())} first candidates, flag rate "
          f"{amb_rate:.6f}, output mismatches {mismatch}, max abs err "
          f"{max_abs:g}; adjudicated faces vs the plain route: {bad.numel()} "
          f"differ ({ties} exact ties among the first 1000); kernel "
          f"{ms_k:.3f} ms, twin "
          f"{ms_w:.3f} ms (counting run {counted_s:.1f} s), "
          f"adjudicate_compact {ms_adj:.3f} ms; work {work['box_tests']} box "
          f"tests, {work['slot_tests']} slot tests, {work['estimate_terms']} "
          f"estimate + {work['magnitude_terms']} magnitude terms, "
          f"{work['ops']} f32 ops ({work['ops_full_test']} with every "
          f"estimate and magnitude), {work['bytes']} bytes"
          + (f", beyond what the function needs {extra}" if extra else "")
          + f" -> bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"(with every estimate and magnitude "
          f"{bound['bound_ms_full_test']:.4f} ms); slot test steps {steps} "
          f"({card})", flush=True)
    if mismatch:
        fail(f"{name}: {mismatch} pairs output mismatches against the twin")
    if max_abs != 0.0:
        fail(f"{name}: kernel and twin t1 differ where c1 agrees")
    if bad.numel() > MISMATCH_LIMIT * n_rays:
        fail(f"{name}: {bad.numel()} adjudicated faces differ from the "
             f"plain route's")
    return dict(n=n_rays, live=int(live.sum()), mismatch=mismatch,
                vs_k2p=vs_k2p, staged_rounds=stats.get("staged_rounds"),
                max_abs=max_abs, amb_rate=amb_rate, slot_steps=steps,
                face_mismatch=int(bad.numel()), exact_ties=ties, ms=ms_k,
                plain_ms=ms_w, adjudicate_ms=ms_adj, **bound,
                estimate_terms=work["estimate_terms"],
                magnitude_terms=work["magnitude_terms"])


def compare_pairs_legs(torch, tables, legs, card, tile, label="",
                       needs=None, **prep_kw):
    """The primary and bounce legs through the pairs entry → dict.
    ``needs``: the legs whose counts bound these (:func:`_bound`)."""
    return {key: _compare_pairs_leg(torch, f"{label}{key} (pairs)", legs[key],
                                    tables, card, tile,
                                    needs=needs and needs[key], **prep_kw)
            for key in ("primary", "bounce")}


LEG_NAMES = {"primary": "primary", "bounce": "bounce", "nee": "nee shadow",
             "env": "env shadow"}
SHADOW_LEGS = ("nee", "env")


def compare_scheduling_legs(torch, tables, legs, card, tile, k1, k2p):
    """K5 (rounds of 1, 4 and 8 clusters), K2n, K2pl and K2n's pipelined
    walk on frame 0's 1080p legs, each against its twin and against K1
    (pairs: K2p) on the same rays; and K2n's whole leg against the whole
    K1 route (the tile entry distances and the sort as plain torch, then
    K1), both timed → dict of the results by kernel. ``k1`` and ``k2p``:
    K1's and K2p's results on the same legs, whose work counts bound K5
    and K2pl (:func:`_bound`); K2n's own bound its pipelined walk."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    refs = {}
    for key in legs:
        args = cc.prepare_tiles(tables=tables, tile=tile, **legs[key])
        refs[key] = (cc.trace_any_tiles(**args) if key in SHADOW_LEGS
                     else cc.trace_closest_tiles(**args)[1])
        del args
    variants = [(f"K5 rounds of {j}", dict(sched_rounds=j),
                 ("primary", "bounce"), k1) for j in (1, 4, 8)]
    variants += [
        ("K2n", dict(near="kernel"), tuple(legs), None),
        ("K2pl", dict(pipelined=True), tuple(legs), k1),
        ("K2n pipelined", dict(near="kernel", pipelined=True), tuple(legs),
         "K2n"),
    ]
    out = {}
    for label, kw, keys, needs in variants:
        needs = out[needs] if isinstance(needs, str) else needs
        out[label] = {}
        for key in keys:
            args = cc.prepare_tiles(tables=tables, tile=tile, **legs[key],
                                    **kw)
            out[label][key] = _compare_leg(
                torch, f"{label} {LEG_NAMES[key]}", args, card,
                key in SHADOW_LEGS, ref_code=refs[key],
                needs=needs and needs[key])
            del args
    del refs
    for key in ("primary", "bounce"):
        extra = out["K5 rounds of 1"][key]["extra_ops"]
        if extra:
            fail(f"K5 in rounds of 1 counted {extra} operations more than "
                 f"K1 on the {key} leg")
    out["K2n pairs"] = compare_pairs_legs(torch, tables, legs, card, tile,
                                          label="K2n ", near="kernel")
    out["K2pl pairs"] = compare_pairs_legs(
        torch, tables, legs, card, tile, label="K2pl ", needs=k2p,
        pipelined=True)
    out["K2n pipelined pairs"] = compare_pairs_legs(
        torch, tables, legs, card, tile, label="K2n pipelined ",
        needs=out["K2n pairs"], near="kernel", pipelined=True)
    routes = {}
    for key in ("primary", "bounce"):
        def k1_route():
            args = cc.prepare_tiles(tables=tables, tile=tile, **legs[key])
            return cc.trace_closest_tiles(**args)

        def k2n_route():
            args = cc.prepare_tiles(tables=tables, tile=tile, near="kernel",
                                    **legs[key])
            return cc.trace_near_closest_tiles(**args)

        routes[key] = dict(k1_route_ms=_time_cuda(torch, k1_route, 3),
                           k2n_route_ms=_time_cuda(torch, k2n_route, 3))
        print(f"{key}: whole K1 route (entry distances, sort, K1) "
              f"{routes[key]['k1_route_ms']:.3f} ms, whole K2n route "
              f"{routes[key]['k2n_route_ms']:.3f} ms ({card})", flush=True)
    out["routes"] = routes
    return out


def frame0_legs(torch, tables, st, seed, row0=0, rows=None, sky=None):
    """Frame 0's trace legs over image rows [row0, row0 + rows), made
    exactly as Renderer.step / path_trace make them (global pixel indices
    and RNG streams): name → keyword arguments of ``prepare_tiles``.
    Primary, first bounce (exclusion codes), NEE shadow (the first light
    sample) and, given ``sky``, the env-NEE shadow set."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops import detmath, rng
    from webgpu_raytracing_tpu_torch.ops.env_sample import sample_env
    from webgpu_raytracing_tpu_torch.ops.integrator import (
        face_normal, face_point_offset, light_sample,
    )
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays
    from webgpu_raytracing_tpu_torch.ops.strictf import sdot3

    dev = torch.device(DEVICE)
    w = st.render_width
    h = st.render_height if rows is None else rows
    r = w * h
    frame_seed = int(
        np.random.default_rng(seed).integers(0, 2**32, dtype=np.uint64)
    )
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.int32, device=dev) + row0,
        torch.arange(w, dtype=torch.int32, device=dev), indexing="ij",
    )
    idx = (xs + ys * w).reshape(r)
    pos = torch.stack([xs, ys], -1).reshape(r, 2).to(torch.float32)
    view = torch.as_tensor(Camera().view_matrix(), device=dev)
    o, d, state = camera_rays(pos, view, rng.seed_state(frame_seed, idx), st)
    t_max = torch.full((r,), F32_MAX, device=dev)
    legs = {"primary": dict(o=o, d=d, t_max=t_max)}

    # path_trace's segment-0 vertex on the kernel's primary hits
    hit = cc.trace_closest_clustered_cuda(o, d, t_max, tables,
                                          tile=st.trace_tile)
    h_mask = hit.face >= 0
    fi = hit.face.clamp(min=0).long()
    n = face_normal(tables.shade_normal[fi], hit.u, hit.v, st.shading_type)
    new_o = face_point_offset(tables.tri[fi], tables.shade_normal[fi],
                              hit.u, hit.v)
    excl = torch.where(h_mask, tables.clusters.partner_code[fi],
                       torch.full_like(hit.face, -1))
    ray = light_sample(new_o, state, tables)
    legs["nee"] = dict(o=new_o, d=ray.d, t_max=ray.t_max, active=h_mask,
                       excl_code=excl)
    if sky is not None:
        ed, _, _, _ = sample_env(sky, state)
        facing = sdot3(ed, detmath.normalize(n)) > 0.0
        legs["env"] = dict(o=new_o, d=ed, t_max=t_max,
                           active=h_mask & facing, excl_code=excl)
    t2, _ = rng.random_2(state)
    new_d = rng.sample_cosine_weighted_hemisphere(t2, n)
    legs["bounce"] = dict(o=new_o, d=new_d, t_max=t_max, active=h_mask,
                          excl_code=excl)
    return legs


def compare_legs(torch, tables, legs, card, tile, label=""):
    """Each leg of ``legs`` through its kernel and twin → (closest,
    any-hit) dicts of _compare_leg results."""
    from webgpu_raytracing_tpu_torch.ops.cluster_cuda import prepare_tiles

    closest, anyhit = {}, {}
    names = {"primary": "primary", "bounce": "bounce", "nee": "nee shadow",
             "env": "env shadow"}
    for key in ("primary", "nee", "env", "bounce"):
        if key not in legs:
            continue
        args = prepare_tiles(tables=tables, tile=tile, **legs[key])
        any_hit = key in ("nee", "env")
        out = _compare_leg(torch, label + names[key], args, card, any_hit)
        (anyhit if any_hit else closest)[key] = out
    return closest, anyhit


def phase_kernel_vs_twin(torch, scene, sky, seed, card):
    """K1, K2p, K5, K2n, K2pl, K4 and the key vs twins on frame 0's 1080p
    legs of the slice scene → (closest, any-hit, pairs, scheduling kernels,
    K4, the hooked drain entries, the whole per-ray-scheduled legs, the
    key)."""
    from webgpu_raytracing_tpu_torch.config import RenderSettings

    st = RenderSettings(**SLICE)
    tables = scene.tables(torch.device(DEVICE))
    legs = frame0_legs(torch, tables, st, seed, sky=sky)
    closest, anyhit = compare_legs(torch, tables, legs, card, st.trace_tile)
    pairs = compare_pairs_legs(torch, tables, legs, card, st.trace_tile)
    sched = compare_scheduling_legs(torch, tables, legs, card, st.trace_tile,
                                    {**closest, **anyhit}, pairs)
    k4, hooked = compare_binned_legs(torch, tables, legs, card, st.trace_tile)
    keys = compare_key_legs(torch, tables, legs, card, st.trace_tile)
    binned = profile_binned_legs(torch, tables, legs, card, st.trace_tile)
    return closest, anyhit, pairs, sched, k4, hooked, binned, keys


def _fold(torch, leg):
    """A leg's rays with ``active`` folded into t_max → (o, d, t_max,
    exclusion codes or None)."""
    tm = leg["t_max"]
    if leg.get("active") is not None:
        tm = torch.where(leg["active"], tm, torch.zeros_like(tm))
    return leg["o"], leg["d"], tm, leg.get("excl_code")


def compare_binned_legs(torch, tables, legs, card, tile):
    """K4 and the hooked drain entries vs their twins on frame 0's legs →
    (K4 results by leg, hooked-entry results by name).

    K4: the bounce leg and the two shadow legs, each sorted by nearest
    cluster with its block schedules, as ``binned_trace`` makes them. The
    hooks: K1 capped at 4 clusters (with its stop) on the unsorted bounce
    leg; on that pass's survivors K1 and K2n with ``t_start`` and the
    carried code; on K4's shadow survivors the any-hit entries of K1 and
    K2n with ``t_start``."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops import ray_sort as rs

    boxes = tables.clusters.box
    c = boxes.shape[0]
    kmask, miss_th = rs._key_masks(c)
    k4, hooked = {}, {}
    for key in ("bounce",) + SHADOW_LEGS:
        o, d, tm, ex = _fold(torch, legs[key])
        if o.shape[0] % tile:
            fail(f"K4 {key}: the leg is not a whole number of blocks")
        k1, k2 = rs.nearest_cluster_keys2(o, d, tm, boxes)
        cid_s, perm = rs.sort_keys(rs._cid_of(k1, c))
        o_s, d_s, tm_s, k2_s, ex_s = rs.permute_rows(perm, (o, d, tm, k2, ex))
        del k1, k2, perm
        sched, flag = rs._block_schedules(cid_s, o.shape[0] // tile, tile, c)
        args = cc.binned_args(o_s, d_s, tm_s, tables, sched, ex_s, tile=tile)
        k4[key] = _compare_leg(torch, f"K4 {LEG_NAMES[key]}", args, card,
                               wrapper=cc.trace_binned_tiles)
        scheduled = int((sched >= 0).sum())
        k4[key].update(blocks=sched.shape[0], clusters_scheduled=scheduled,
                       unscheduled_rays=int((~flag & (tm_s > 0)).sum()))
        print(f"K4 {LEG_NAMES[key]}: {sched.shape[0]} blocks, {scheduled} "
              f"scheduled clusters ({scheduled / sched.shape[0]:.4f} per "
              f"block), {k4[key]['unscheduled_rays']} live rays whose "
              "nearest cluster made no schedule", flush=True)
        if key not in SHADOW_LEGS:
            continue
        # K4's shadow survivors through the any-hit drains with t_start
        hit = cc.trace_binned_tiles(**args)[1] >= 0
        entered2 = (k2_s & ~kmask) < miss_th
        surv = (tm_s > 0) & ~hit & torch.where(
            flag, entered2, cid_s < c)
        ts = torch.where(flag & entered2, (k2_s & ~kmask).view(torch.float32),
                         torch.zeros_like(tm_s))
        tm3 = torch.where(surv, tm_s, torch.zeros_like(tm_s))
        del args, hit, entered2
        for label, kw in (("K1", {}), ("K2n", dict(near="kernel"))):
            name = f"{label} any-hit with t_start, {LEG_NAMES[key]} survivors"
            hooked[name] = _compare_leg(
                torch, name, cc.prepare_tiles(o_s, d_s, tm3, tables, None,
                                              ex_s, tile, t_start=ts, **kw),
                card, any_hit=True)
            hooked[name]["survivors"] = int(surv.sum())
    o, d, tm, ex = _fold(torch, legs["bounce"])
    name = "K1 capped at 4 clusters, bounce"
    capped = cc.prepare_tiles(o, d, tm, tables, None, ex, tile, cap=4,
                              return_stop=True)
    hooked[name] = _compare_leg(torch, name, capped, card)
    t1, c1, stop = cc.trace_closest_tiles(**capped)
    del capped
    surv = t1.view(torch.int32) > stop
    hooked[name]["survivors"] = int(surv.sum())
    print(f"{name}: {int(surv.sum())} of {int((tm > 0).sum())} live rays "
          "survive the capped pass", flush=True)
    tm2 = torch.where(surv, t1, torch.zeros_like(t1))
    for label, kw in (("K1", {}), ("K2n", dict(near="kernel"))):
        name = f"{label} with t_start and start_code, bounce survivors"
        hooked[name] = _compare_leg(
            torch, name, cc.prepare_tiles(
                o, d, tm2, tables, None, ex, tile,
                t_start=stop.view(torch.float32), start_code=c1, **kw), card)
    return k4, hooked


def _compare_keys(torch, name, o, d, tm, boxes, n, card, t_start=None):
    """The key kernel against its twin on one leg's rays: every key equal
    (int32), both timed (CUDA events) → its record. The bound: every
    ray-box slab test (cluster_cuda.BOX_TEST_OPS f32 operations) over 67
    TFLOP/s, or each ray's o, inv_d, t_max (and t_start) read once, the
    boxes read once and its n keys written once over 3.35 TB/s."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir

    wrapper = cc.top_keys_tiles
    args = (o.contiguous(), safe_inv_dir(d).contiguous(), tm.contiguous(),
            boxes.contiguous(), n)
    kw = dict(t_start=None if t_start is None else t_start.contiguous())
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"{name}: kernel launch was not counted")
    want = wrapper.twin(*args, **kw)
    mismatch = sum(int((g != w).sum()) for g, w in zip(got, want))
    max_abs = max(float((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
    ms_k = _time_cuda(torch, lambda: wrapper(*args, **kw), 5)
    ms_w = _time_cuda(torch, lambda: wrapper.twin(*args, **kw), 1,
                      warm=False)
    r, c = o.shape[0], boxes.shape[0]
    kmask, miss_th = cc.key_masks(c)
    entered = [int(((k & ~kmask) < miss_th).sum()) for k in want]
    ops = r * c * cc.BOX_TEST_OPS
    nbytes = 4 * r * (7 + (t_start is not None) + n) + 24 * c
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    out = dict(n=r, live=int((tm > 0).sum()), boxes=c, keys=n,
               mismatch=mismatch, max_abs=max_abs, ms=ms_k, plain_ms=ms_w,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops=ops, bytes=nbytes, rays_entering=entered)
    print(f"{name}: {r} rays ({out['live']} live) over {c} boxes, top {n} "
          f"keys, rays entering 1..{n} boxes {entered}, key mismatches "
          f"{mismatch}, max abs err {max_abs:g}; kernel {ms_k:.3f} ms, twin "
          f"{ms_w:.3f} ms; {ops} f32 ops, {nbytes} bytes -> bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']} ({card})",
          flush=True)
    if mismatch:
        fail(f"{name}: {mismatch} keys differ from the twin's")
    return out


def compare_key_legs(torch, tables, legs, card, tile):
    """The key kernel against its twin on frame 0's legs of the slice: the
    bounce leg's top 3 (``binned_trace``), the two shadow legs' top 2
    (``binned_trace_any``; the sorted trace's key takes the same two), and
    a multipass leg: the bounce rays that K1 capped at 4 clusters leaves
    unfinished, with ``t_start`` = its stop (``_recompact_final_pass``'s
    key, at the full width) → records by leg."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    boxes = tables.clusters.sort_box
    out = {}
    for key, n in (("bounce", 3), ("nee", 2), ("env", 2)):
        o, d, tm, _ = _fold(torch, legs[key])
        out[key] = _compare_keys(torch, f"key, {LEG_NAMES[key]}", o, d, tm,
                                 boxes, n, card)
    o, d, tm, ex = _fold(torch, legs["bounce"])
    t1, _, stop = cc.trace_closest_tiles(**cc.prepare_tiles(
        o, d, tm, tables, None, ex, tile, cap=4, return_stop=True))
    surv = t1.view(torch.int32) > stop
    out["multipass"] = _compare_keys(
        torch, "key, bounce survivors of K1 capped at 4, t_start", o, d,
        torch.where(surv, t1, torch.zeros_like(t1)), boxes, 2, card,
        t_start=stop.view(torch.float32))
    return out


def _face_exceptions(torch, name, leg, tables, face, ref_face, what):
    """Rays on which ``face`` differs from ``ref_face``, each printed with
    the exact t of both faces and whether they tie → (count, exact ties).
    Fails on a difference that is no exact tie, or on more than
    MISMATCH_LIMIT of the rays."""
    from webgpu_raytracing_tpu_torch.ops.cluster_trace import exact_face_eval

    bad = torch.nonzero(face != ref_face).flatten()
    ties = 0
    inf = torch.tensor([float("inf")], device=face.device)
    for i in bad[:1000].tolist():
        ts = []
        for f in (int(face[i]), int(ref_face[i])):
            ok, t, _, _ = exact_face_eval(
                leg["o"][i : i + 1], leg["d"][i : i + 1],
                tables.tri[max(f, 0) : max(f, 0) + 1],
                torch.tensor([f >= 0], device=face.device), inf)
            ts.append(float(t[0]) if bool(ok[0]) else None)
        tie = ts[0] is not None and ts[0] == ts[1]
        ties += tie
        print(f"{name}: ray {i}: face {int(face[i])} (exact t {ts[0]}), "
              f"{what} face {int(ref_face[i])} (exact t {ts[1]})"
              f"{', an exact tie' if tie else ''}", flush=True)
    if ties != min(int(bad.numel()), 1000):
        fail(f"{name}: faces differ from the {what}'s where t does not tie")
    if bad.numel() > MISMATCH_LIMIT * face.numel():
        fail(f"{name}: {bad.numel()} faces differ from the {what}'s")
    return int(bad.numel()), ties


BINNED_STAGES = ("nearest_cluster_keys2", "nearest_cluster_key", "sort_keys",
                 "permute_rows", "trace_binned_pass", "_mid_pass",
                 "_recompact_final_pass", "survivor_count", "unsort")


def _staged(torch, run, drain):
    """``run(drain)`` with every stage of ``ops/ray_sort.py`` it goes
    through, and the drain it is given, timed on the host's clock between
    device synchronizes → (its result, the events in the order they
    ended: (stage, nesting depth, ms, the count a read returned))."""
    from webgpu_raytracing_tpu_torch.ops import ray_sort as rs

    events, depth = [], [0]

    def timed(stage, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*a, **kw)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            events.append((stage, depth[0],
                           (time.perf_counter() - t0) * 1e3,
                           out if stage == "survivor_count" else None))
            return out
        return call

    real = {stage: getattr(rs, stage) for stage in BINNED_STAGES}
    for stage, fn in real.items():
        setattr(rs, stage, timed(stage, fn))
    try:
        out = timed("leg", run)(timed("drain", drain))
    finally:
        for stage, fn in real.items():
            setattr(rs, stage, fn)
    return out, events


def _stage_summary(events):
    """Events → ms of the leg, ms by top-level stage in order (a stage
    that another one calls is counted inside that one; the drain kernel's
    own call, prep and launch, is listed as ``drain``), and the counts
    read from the device."""
    top = {}
    for stage, depth, ms, _ in events:
        if depth == 1 or stage == "drain":
            n = sum(k.split("#")[0] == stage for k in top)
            top[f"{stage}#{n + 1}"] = round(ms, 3)
    reads = [count for stage, _, _, count in events
             if stage == "survivor_count"]
    leg_ms = next(ms for stage, _, ms, _ in events if stage == "leg")
    return leg_ms, top, reads


def profile_binned_legs(torch, tables, legs, card, tile):
    """The whole per-ray-scheduled legs on frame 0's rays, staged
    (:func:`_staged`): ``binned_trace`` and ``sorted_trace_multipass`` (cap
    4) on the bounce rays against ``sorted_trace`` and the unsorted K1
    route (faces identical but for printed exact ties), and
    ``binned_trace_any`` on the two shadow sets against the sorted and
    unsorted any-hit routes (blocked flags identical) → dict by leg."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops import ray_sort as rs

    fid = tables.clusters.face_id
    out = {}

    def drain(o, d, tm, tb, act, excl_code=None, **hooks):
        return cc.trace_closest_clustered_cuda(
            o, d, tm, tb, act, excl_code=excl_code, tile=tile, raw="code",
            **hooks)

    def drain_any(o, d, tm, tb, act, excl_code=None, t_start=None):
        return cc.trace_any_clustered_cuda(
            o, d, tm, tb, act, excl_code=excl_code, tile=tile,
            t_start=t_start)

    def plain(o, d, tm, tb, act, ex=None):
        return cc.trace_closest_clustered_cuda(o, d, tm, tb, act,
                                               excl_code=ex, tile=tile,
                                               raw=True)

    def plain_any(o, d, tm, tb, act, ex=None):
        return cc.trace_any_clustered_cuda(o, d, tm, tb, act, excl_code=ex,
                                           tile=tile)

    def report(name, events, n_rays, live, extra):
        leg_ms, top, reads = _stage_summary(events)
        shares = [round(x / live, 4) for x in reads]
        print(f"{name}: {n_rays} rays ({live} live), {leg_ms:.1f} ms; "
              f"top-level stages in order, ms: {top}; {len(reads)} "
              f"device-to-host reads of a count: {reads} (of the live rays: "
              f"{shares}); {extra} ({card})", flush=True)
        return dict(ms=leg_ms, stages=top, reads=reads,
                    survivor_share_of_live=shares, n=n_rays, live=live)

    leg = legs["bounce"]
    o, d, tm, ex = _fold(torch, leg)
    live = int((tm > 0).sum())
    ref_t, ref_face = plain(o, d, tm, tables, None, ex)
    s_t, s_face = rs.sorted_trace(plain, o, d, tm, tables, extra=ex)
    sorted_ms = _time_cuda(
        torch, lambda: rs.sorted_trace(plain, o, d, tm, tables, extra=ex), 2)
    unsorted_ms = _time_cuda(
        torch, lambda: plain(o, d, tm, tables, None, ex), 2)
    n_sorted, _ = _face_exceptions(torch, "sorted_trace, bounce", leg,
                                   tables, s_face, ref_face,
                                   "unsorted K1 route")
    traces = {
        "binned_trace": lambda fn: rs.binned_trace(
            fn, o, d, tm, tables, extra=ex, tile=tile),
        "sorted_trace_multipass": lambda fn: rs.sorted_trace_multipass(
            fn, o, d, tm, tables, extra=ex, cap=4),
    }
    for label, run in traces.items():
        run(drain)  # warm-up
        before = cc.trace_binned_tiles.launches
        (t, face), events = _staged(torch, run, drain)
        k4_launches = cc.trace_binned_tiles.launches - before
        n_bad, ties = _face_exceptions(torch, f"{label}, bounce", leg, tables,
                                       face, ref_face, "unsorted K1 route")
        same_t = torch.equal(t[face == ref_face].view(torch.int32),
                             ref_t[face == ref_face].view(torch.int32))
        if not same_t:
            fail(f"{label}: t differs from the unsorted route's where the "
                 "faces agree")
        out[label] = report(
            f"{label}, bounce", events, o.shape[0], live,
            f"{k4_launches} K4 launches; faces that differ from the unsorted "
            f"K1 route's: {n_bad} ({ties} exact ties), from sorted_trace's: "
            f"{int((face != s_face).sum())} (sorted_trace's own: {n_sorted}); "
            f"sorted_trace {sorted_ms:.1f} ms, unsorted K1 route "
            f"{unsorted_ms:.1f} ms on the same rays")
        out[label].update(k4_launches=k4_launches, face_mismatch=n_bad,
                          exact_ties=ties, sorted_trace_ms=sorted_ms,
                          unsorted_route_ms=unsorted_ms)
    for key in SHADOW_LEGS:
        o, d, tm, ex = _fold(torch, legs[key])
        live = int((tm > 0).sum())
        ref = plain_any(o, d, tm, tables, None, ex)
        if not torch.equal(rs.sorted_trace(plain_any, o, d, tm, tables,
                                           extra=ex), ref):
            fail(f"sorted any-hit trace, {key}: blocked set differs from the "
                 "unsorted route's")
        sorted_ms = _time_cuda(torch, lambda: rs.sorted_trace(
            plain_any, o, d, tm, tables, extra=ex), 2)
        unsorted_ms = _time_cuda(
            torch, lambda: plain_any(o, d, tm, tables, None, ex), 2)
        for mid in (False, True):
            def run(fn):
                return rs.binned_trace_any(fn, o, d, tm, tables, extra=ex,
                                           tile=tile, mid=mid)

            run(drain_any)  # warm-up
            blocked, events = _staged(torch, run, drain_any)
            n_bad = int((blocked != ref).sum())
            label = f"binned_trace_any{' with mid pass' if mid else ''}"
            out[f"{label}, {key}"] = report(
                f"{label}, {LEG_NAMES[key]}", events, o.shape[0], live,
                f"{int(ref.sum())} blocked; flags that differ from the "
                f"unsorted route's: {n_bad}; sorted any-hit trace "
                f"{sorted_ms:.1f} ms, unsorted K1 route {unsorted_ms:.1f} ms "
                "on the same rays")
            if n_bad:
                fail(f"{label}, {key}: {n_bad} blocked flags differ from the "
                     "unsorted route's")
    return out


WRAPPERS = ("trace_closest_tiles", "trace_any_tiles",
            "trace_closest_two_level_tiles", "trace_any_two_level_tiles",
            "trace_pairs_tiles", "trace_pairs_two_level_tiles",
            "trace_sched_tiles", "trace_near_closest_tiles",
            "trace_near_any_tiles", "trace_near_pairs_tiles",
            "trace_pipelined_closest_tiles", "trace_pipelined_any_tiles",
            "trace_pipelined_pairs_tiles", "trace_binned_tiles",
            "trace_near_closest_two_level_tiles",
            "trace_near_any_two_level_tiles",
            "trace_near_pairs_two_level_tiles", "top_keys_tiles")


def launches_per_frame(**counts):
    """Launches per frame in the order of WRAPPERS, from
    ``<wrapper without trace_ and _tiles>=n`` keywords; the rest 0."""
    names = [w.removeprefix("trace_").removesuffix("_tiles")
             for w in WRAPPERS]
    unknown = set(counts) - set(names)
    if unknown:
        raise KeyError(unknown)
    return tuple(counts.get(n, 0) for n in names)


def _launch_counts():
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    return tuple(getattr(cc, w).launches for w in WRAPPERS)


def _zero_launch_counts():
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    for w in WRAPPERS:
        getattr(cc, w).launches = 0


class Prebuilt:
    """A scene whose tables are already on the card: the Renderers of the
    later config #5 checks share the tables of the config #5 frame instead
    of rebuilding 1M faces each."""

    def __init__(self, tables):
        self._tables = tables

    def tables(self, device):
        return self._tables


def drive_path(torch, name, scene, st, frames, seed, card, per_frame,
               env_data=None, finite=True):
    """Render one warm-up and ``frames`` timed frames through Renderer on
    the card; check sample counts, launch counts (per frame, in the order
    of WRAPPERS; the camera rays kernel once a sample and slab, each
    shading kernel once a segment, the rederive kernel once a closest-hit
    leg) and the image; return (the measured numbers, the Renderer)."""
    from webgpu_raytracing_tpu_torch.ops import integrator as ti
    from webgpu_raytracing_tpu_torch.ops.cluster_trace import rederive_uv
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    t0 = time.perf_counter()
    r = Renderer(scene, st, env_data=env_data, base_seed=seed,
                 device=DEVICE)
    setup_s = time.perf_counter() - t0
    r.step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    camera_rays.launches = 0
    ti.shade_hit.launches = ti.shade_bounce.launches = 0
    rederive_uv.launches = 0
    ti.light_sample.launches = ti.light_add.launches = 0
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(frames):
        r.step()
        rays += r.last_rays
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _launch_counts()
    raygen = camera_rays.launches
    shade = (ti.shade_hit.launches, ti.shade_bounce.launches)
    rederive = rederive_uv.launches
    light = (ti.light_sample.launches, ti.light_add.launches)
    peak = torch.cuda.max_memory_allocated()
    img = r.buffers.image
    want = (1.0 + st.sample_count) * (frames + 1)
    if not bool((img[..., 3] == want).all()):
        fail(f"{name}: sample counts differ from {want}")
    per_frame = tuple(per_frame) + (0,) * (len(WRAPPERS) - len(per_frame))
    expect = tuple(n * frames for n in per_frame)
    if launches != expect:
        fail(f"{name}: launches {launches} of {WRAPPERS} in {frames} "
             f"frames, expected {expect}")
    raygen_per_frame = st.frame_slabs * (1 + st.sample_count)
    if raygen != raygen_per_frame * frames:
        fail(f"{name}: {raygen} camera rays kernel launches in {frames} "
             f"frames, expected {raygen_per_frame * frames}")
    # each shading kernel once a segment of the path integrator
    shade_per_frame = raygen_per_frame * max(st.bounces_depth - 1, 0)
    if st.bounces_depth <= 1:  # trace_direct
        shade_per_frame = 0
    if shade != (shade_per_frame * frames,) * 2:
        fail(f"{name}: shading kernel launches {shade} in {frames} frames, "
             f"expected {shade_per_frame * frames} each")
    # rederive once a closest-hit leg (one a sample and slab in
    # trace_direct), but not on an exact-pairs leg whose flagged rays
    # outnumber adjudicate_compact's batch: that leg adjudicates densely
    legs = raygen_per_frame * max(st.bounces_depth - 1, 1)
    exact = 0
    if st.exact_pairs:
        exact = legs if st.exact_pairs_bounce else raygen_per_frame
    if not (legs - exact) * frames <= rederive <= legs * frames:
        want = (f"{legs * frames}" if not exact else
                f"{(legs - exact) * frames} to {legs * frames}")
        fail(f"{name}: {rederive} rederive kernel launches in {frames} "
             f"frames, expected {want}")
    # each light kernel once a light sample: samples_per_point at every
    # segment under NEE, and at every sample and slab of trace_direct
    light_per_frame = 0
    if st.bounces_depth <= 1:
        light_per_frame = raygen_per_frame * st.samples_per_point
    elif st.next_event_estimation:
        light_per_frame = shade_per_frame * st.samples_per_point
    if light != (light_per_frame * frames,) * 2:
        fail(f"{name}: light kernel launches {light} in {frames} frames, "
             f"expected {light_per_frame * frames} each")
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
    print(f"{name}: {frames} frames of {st.width}x{st.height} "
          f"(frame_slabs {st.frame_slabs}), {ms:.1f} ms/frame, "
          f"{mrays:.3f} Mrays/s ({rays / frames:.0f} rays/frame), launches "
          f"{ {w: n for w, n in zip(WRAPPERS, launches) if n} }, camera "
          f"rays kernel {raygen}, shading kernels {shade}, rederive kernel "
          f"{rederive}, light kernels {light}, NaN pixels "
          f"{nan_share:.4f}, peak memory {peak / 2**30:.2f} GiB, Renderer set-up "
          f"{setup_s:.1f} s ({card})", flush=True)
    return dict(launches=launches, raygen_per_frame=raygen / frames,
                shade_per_frame=sum(shade) / frames,
                rederive_per_frame=rederive / frames,
                light_per_frame=sum(light) / frames, ms_per_frame=ms, mrays=mrays, nan_share=nan_share, peak_gib=peak / 2**30,
                rays_per_frame=rays / frames), r


def _same_frame(torch, name, img, ref_img, what):
    """``img`` against ``ref_img`` (same seed and frame count): equal NaN
    masks, RMSE < 1e-5 over the other values → (RMSE, pixels that
    differ)."""
    nan = torch.isnan(ref_img)
    if not torch.equal(torch.isnan(img), nan):
        fail(f"{name}: NaN mask differs from the {what}'s")
    rmse = float(((img - ref_img)[~nan] ** 2).mean().sqrt())
    n_diff = int(((img != ref_img) & ~nan).any(-1).sum())
    print(f"{name} vs {what}, same seed and frames: RMSE {rmse:.3g}, "
          f"{n_diff} pixels differ", flush=True)
    if not rmse < 1e-5:
        fail(f"{name}: RMSE {rmse} >= 1e-5 against the {what}")
    return dict(rmse_vs_reference=rmse, pixels_differ=n_diff)


def profile_sorted_legs(torch, r):
    """One more frame of Renderer ``r`` with every stage of
    ``ops/ray_sort.py`` (the functions ``sorted_trace`` calls through its
    module) timed on the host's clock between device synchronizes → one
    record per sorted leg: ray count, live count (where it was read),
    traced width, branch, ms per stage and of the traced leg itself."""
    from webgpu_raytracing_tpu_torch.ops import integrator, ray_sort

    stages = {"key": "nearest_cluster_key", "sort": "sort_keys",
              "gather": "permute_rows", "count": "live_count",
              "unsort": "unsort"}
    legs, rec = [], {}

    def timed(fn, stage):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec[stage + "_ms"] = (time.perf_counter() - t0) * 1e3
            if stage == "count":
                rec["live"] = out
            if stage == "unsort":
                rec.update(rays=a[0].shape[0], width=a[1][0].shape[0])
            return out
        return run

    def leg(*a, **kw):
        rec.clear()
        rec["live"] = None
        out = timed(real["sorted_trace"], "leg")(*a, **kw)
        rec["trace_ms"] = rec["leg_ms"] - sum(
            rec.get(k + "_ms", 0.0) for k in stages)
        rec["branch"] = "sliced" if rec["width"] < rec["rays"] else "full"
        legs.append(dict(rec))
        return out

    real = {name: getattr(ray_sort, name) for name in stages.values()}
    real["sorted_trace"] = integrator.sorted_trace
    for stage, name in stages.items():
        setattr(ray_sort, name, timed(real[name], stage))
    integrator.sorted_trace = leg
    try:
        r.step()
        torch.cuda.synchronize()
    finally:
        integrator.sorted_trace = real.pop("sorted_trace")
        for name, fn in real.items():
            setattr(ray_sort, name, fn)
    return legs


def _count_calls(module, name):
    """Replace ``module.name`` by a counting pass-through → (the list that
    holds the count, a function that puts the real one back)."""
    real, calls = getattr(module, name), [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    setattr(module, name, counted)
    return calls, lambda: setattr(module, name, real)


def drive_pair(torch, paths, key, name, scene, st, frames, seed, card,
               counts, outside_counts, ref_img=None, what="", **kw):
    """A path through the default order (every tile orders itself inside
    the kernel: ``tile_nears_fused`` must not be called once) and the same
    path with ``kernel_near=False`` (the order sorted outside, K1 / K3):
    exact launch counts for both, and the two frames equal, RMSE 0 and the
    same NaN mask → the default frame's image. ``ref_img``: a frame the
    default one must equal too."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    if not st.kernel_near:
        fail(f"{name}: kernel_near is not the default")
    calls, restore = _count_calls(cc, "tile_nears_fused")
    try:
        paths[key], r = drive_path(torch, name, scene, st, frames, seed, card,
                                   launches_per_frame(**counts), **kw)
    finally:
        restore()
    print(f"{name}: tile_nears_fused was called {calls[0]} times", flush=True)
    if calls[0]:
        fail(f"{name}: the tile entry distances were also computed outside "
             "the kernel")
    paths[key]["tile_nears_fused_calls"] = calls[0]
    img = r.buffers.image.clone()
    del r
    if ref_img is not None:
        paths[key].update(_same_frame(torch, name, img, ref_img, what))
    out_key, out_name = key + "_outside", name + ", order outside"
    paths[out_key], r = drive_path(
        torch, out_name, scene, st.replace(kernel_near=False), frames, seed,
        card, launches_per_frame(**outside_counts), **kw)
    same = _same_frame(torch, out_name, r.buffers.image, img, name)
    del r
    if same["rmse_vs_reference"] != 0.0:
        fail(f"{out_name}: RMSE {same['rmse_vs_reference']} against the "
             "default order's frame, expected 0")
    paths[out_key].update(same)
    return img


def phase_scheduling_paths(torch, scene, base, default_img, nee_st, nee_img,
                           frames, seed, card):
    """The 1080p paths of the other tile-scheduling kernels and the ray
    sort, each held to the default frame (or the NEE frame) of the same
    seed and frame count. All but the two K2n ones set ``kernel_near=False``
    (K5, K2pl and the capped K1 walk an order sorted outside):
    ``trace_sched=4`` (6 K5 launches per frame, no K1
    closest-hit one), ``pipeline_rounds`` (6 K2pl), the sorted frame
    (``sort_bounce_rays`` and ``live_slice``; one more frame is profiled
    leg by leg), NEE with the sort (sliced shadow legs), and NEE with
    ``exact_pairs`` under ``kernel_near``, under ``pipeline_rounds`` and
    under both (the any-hit and pairs entries of K2n, of K2pl and of
    K2n's pipelined walk)."""
    paths = {}

    def run(key, name, st, counts, ref_img, what, finite=True):
        paths[key], r = drive_path(torch, name, scene, st, frames, seed, card,
                                   launches_per_frame(**counts),
                                   finite=finite)
        paths[key].update(_same_frame(torch, name, r.buffers.image, ref_img,
                                      what))
        return r

    outside = base.replace(sort_bounce_rays=False, kernel_near=False)
    nee_outside = nee_st.replace(kernel_near=False)
    run("sched", "trace_sched=4 path", outside.replace(trace_sched=4),
        dict(sched=6), default_img, "default frame")
    run("pipelined", "pipeline_rounds path",
        outside.replace(pipeline_rounds=True), dict(pipelined_closest=6),
        default_img, "default frame")
    sorted_st = outside.replace(sort_bounce_rays=True, live_slice=True)
    r = run("sorted", "sorted path", sorted_st, dict(closest=6, top_keys=4),
            default_img, "default frame")
    legs = profile_sorted_legs(torch, r)
    del r
    for i, rec in enumerate(legs):
        ms = {k[:-3]: round(v, 3) for k, v in rec.items() if k.endswith("_ms")}
        print(f"sorted path, profiled frame, sorted leg {i}: {rec['rays']} "
              f"rays, live {rec['live']}, traced width {rec['width']} "
              f"({rec['branch']} branch), ms {ms} ({card})", flush=True)
    if len(legs) != 4:
        fail(f"sorted path: {len(legs)} sorted legs in a frame, expected 4")
    paths["sorted"]["legs"] = legs
    run("nee_sorted", "NEE path, sorted",
        nee_outside.replace(sort_bounce_rays=True, live_slice=True),
        dict(closest=6, any=6, top_keys=8), nee_img, "NEE frame",
        finite=False)
    exact_nee = nee_st.replace(sort_bounce_rays=False, exact_pairs=True)
    run("near_nee_exact", "kernel_near path, NEE and exact primary legs",
        exact_nee.replace(kernel_near=True),
        dict(near_pairs=2, near_closest=4, near_any=6), nee_img, "NEE frame",
        finite=False)
    run("pipelined_nee_exact",
        "pipeline_rounds path, NEE and exact primary legs",
        exact_nee.replace(pipeline_rounds=True, kernel_near=False),
        dict(pipelined_pairs=2, pipelined_closest=4, pipelined_any=6),
        nee_img, "NEE frame", finite=False)
    run("near_pipelined_nee_exact",
        "kernel_near and pipeline_rounds path, NEE and exact primary legs",
        exact_nee.replace(kernel_near=True, pipeline_rounds=True),
        dict(near_pairs=2, near_closest=4, near_any=6), nee_img, "NEE frame",
        finite=False)
    # the per-ray-scheduled traces: per sorted leg (4 a frame) two K4
    # passes and one drain, and two keys (top 3, then the drain's with
    # t_start); any-hit one K4 pass and one drain after one key; multipass
    # a capped and a final pass, a key before each
    run("binned", "binned_sort path", sorted_st.replace(binned_sort=True),
        dict(closest=6, binned=8, top_keys=8), default_img, "default frame")
    run("binned_any_nee", "NEE path, sorted, binned_any_sort",
        nee_outside.replace(sort_bounce_rays=True, binned_any_sort=True),
        dict(closest=6, any=6, binned=4, top_keys=8), nee_img, "NEE frame",
        finite=False)
    run("multipass", "multipass_cap=4 path",
        sorted_st.replace(multipass_cap=4), dict(closest=10, top_keys=8),
        default_img, "default frame")
    run("binned_near", "binned_sort path under kernel_near",
        sorted_st.replace(binned_sort=True, kernel_near=True),
        dict(near_closest=6, binned=8, top_keys=8), default_img,
        "default frame")
    return paths


def phase_paths(torch, scene, sky, frames, seed, card):
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops.env_sample import sample_env
    from webgpu_raytracing_tpu_torch.ops import rng

    paths = {}
    base = RenderSettings(**SLICE)
    default_img = drive_pair(
        torch, paths, "default", "default path", scene, base, frames, seed,
        card, dict(near_closest=6), dict(closest=6))
    drive_pair(
        torch, paths, "exact", "exact-pairs path", scene,
        base.replace(exact_pairs=True, exact_pairs_bounce=True), frames,
        seed, card, dict(near_pairs=6), dict(pairs=6), ref_img=default_img,
        what="default frame")
    nee_st = base.replace(next_event_estimation=True)
    nee_img = drive_pair(
        torch, paths, "nee", "NEE path", scene, nee_st, frames, seed, card,
        dict(near_closest=6, near_any=6), dict(closest=6, any=6),
        finite=False)
    paths.update(phase_scheduling_paths(torch, scene, base, default_img,
                                        nee_st, nee_img, frames, seed, card))
    del default_img, nee_img
    env_st = base.replace(environment="equirect", env_importance_sampling=True)
    drive_pair(torch, paths, "envis", "env-IS path", scene, env_st, frames,
               seed, card, dict(near_closest=6, near_any=6),
               dict(closest=6, any=6), env_data=sky, finite=False)
    lanes = 1920 * 1080
    state = rng.seed_state(
        12345, torch.arange(lanes, dtype=torch.int32, device="cuda")
    )
    ms = _time_cuda(torch, lambda: sample_env(sky, state), 5)
    print(f"sample_env: {lanes} lanes on a {SKY_SHAPE[0]}x{SKY_SHAPE[1]} "
          f"map, {ms:.3f} ms ({card})", flush=True)
    paths["envis"]["sample_env_ms"] = ms
    return paths


def phase_direct(torch, paths, frames, seed, card):
    from webgpu_raytracing_tpu_torch.config import (
        ProjectionType, RenderSettings,
    )
    from webgpu_raytracing_tpu_torch.frontend.cli import analytic_scene

    st = RenderSettings(width=256, height=256, sample_count=1,
                        bounces_depth=1,
                        projection_type=ProjectionType.PERSPECTIVE)
    drive_pair(torch, paths, "direct", "direct path (config #1)",
               analytic_scene(), st, frames, seed, card,
               dict(near_closest=2, near_any=2), dict(closest=2, any=2),
               finite=False)


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


ORACLE_RAYS = 65_536  # rays of each leg the oracles walk on the card
SHARD_FRAMES = 3  # reprojection frames through render_sharded
COMPLETION_SIZE = 256  # side of the traversal-route frames
WGSL_SIZE, WGSL_SEED = 12, 777


def _exact_t(torch, leg, tables, face):
    """The exact t of ``face`` on each ray of ``leg`` (inf for -1)."""
    from webgpu_raytracing_tpu_torch.ops.cluster_trace import exact_face_eval

    tri = tables.tri[face.clamp(min=0).long()]
    big = torch.full_like(leg["t_max"], F32_MAX)
    valid, t, _, _ = exact_face_eval(leg["o"], leg["d"], tri, face >= 0, big)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def _oracle_exceptions(torch, name, leg, tables, face, ref_face, strict):
    """Rays where an oracle's face differs from K2n's, by class: exact
    ties (equal exact t), K2n's face nearer (the oracle missed the nearest
    hit), the oracle's face nearer (K2n missed it: always a failure).
    ``strict``: any class but ties fails."""
    diff = (face != ref_face).nonzero()[:, 0]
    if diff.numel() == 0:
        return dict(mismatch=0)
    sub = {k: leg[k][diff] for k in ("o", "d", "t_max")}
    t_or = _exact_t(torch, sub, tables, face[diff])
    t_k = _exact_t(torch, sub, tables, ref_face[diff])
    out = dict(mismatch=int(diff.numel()), ties=int((t_or == t_k).sum()),
               k2n_nearer=int((t_k < t_or).sum()),
               oracle_nearer=int((t_or < t_k).sum()))
    for i in range(min(int(diff.numel()), 8)):
        print(f"{name}: ray {int(diff[i])}: oracle face "
              f"{int(face[diff[i]])} t {float(t_or[i])!r}, K2n face "
              f"{int(ref_face[diff[i]])} t {float(t_k[i])!r}", flush=True)
    if out["oracle_nearer"] or (strict and out["k2n_nearer"]):
        fail(f"{name}: K2n's face is not the nearest: {out}")
    return out


def compare_oracles(torch, tables, legs, card):
    """``ORACLE_RAYS`` consecutive rays from the middle of frame 0's
    primary, bounce and NEE shadow legs through K2n and through the two
    oracles that share none of its code: the threaded BVH walk
    (ops/traverse.py) and the clustered trace (ops/cluster_trace.py).
    Closest hit: faces equal, else each exception classified; the
    threaded walk is exact, so only exact ties may differ from it, and
    the clustered oracle may also miss a nearest hit its bilinear estimate
    prunes (the JAX oracle's behaviour), never find a nearer one. Any
    hit: blocked sets equal to the threaded walk's; the clustered one may
    only miss blockers. Each timed once after a warm-up."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops import traverse
    from webgpu_raytracing_tpu_torch.ops.cluster_trace import (
        trace_any_clustered, trace_closest_clustered,
    )

    out = {}
    for name in ("primary", "bounce", "nee"):
        full = legs[name]
        r = full["o"].shape[0]
        s0 = (r // 2 - ORACLE_RAYS // 2) // 128 * 128
        leg = {k: v[s0:s0 + ORACLE_RAYS] for k, v in full.items()}
        o, d, tm = leg["o"], leg["d"], leg["t_max"]
        act, ex = leg.get("active"), leg.get("excl_code")
        if name == "nee":
            runs = {
                "K2n": lambda: cc.trace_any_clustered_cuda(
                    o, d, tm, tables, act, excl_code=ex, kernel_near=True),
                "threaded": lambda: traverse.trace_any(o, d, tm, tables, act),
                "clustered": lambda: trace_any_clustered(o, d, tm, tables,
                                                         act, tile=128),
            }
        else:
            runs = {
                "K2n": lambda: cc.trace_closest_clustered_cuda(
                    o, d, tm, tables, act, excl_code=ex,
                    kernel_near=True).face,
                "threaded": lambda: traverse.trace_closest(o, d, tm, tables,
                                                           act).face,
                "clustered": lambda: trace_closest_clustered(
                    o, d, tm, tables, act, tile=128).face,
            }
        res, ms = {}, {}
        for k, fn in runs.items():
            res[k] = fn()
            ms[k] = _time_cuda(torch, fn, 1, warm=False)
        rec = dict(rays=ORACLE_RAYS, first_ray=s0, ms=ms,
                   hits=int((res["K2n"] >= 0).sum() if name != "nee"
                            else res["K2n"].sum()))
        for k in ("threaded", "clustered"):
            label = f"oracles, {LEG_NAMES[name]} leg, {k}"
            if name == "nee":
                extra = int((res[k] & ~res["K2n"]).sum())
                missed = int((res["K2n"] & ~res[k]).sum())
                rec[k] = dict(mismatch=extra + missed,
                              blocked_only_by_oracle=extra,
                              blocked_only_by_k2n=missed)
                if extra or (k == "threaded" and missed):
                    fail(f"{label}: blocked sets differ: {rec[k]}")
            else:
                rec[k] = _oracle_exceptions(torch, label, leg, tables,
                                            res[k], res["K2n"],
                                            strict=k == "threaded")
        print(f"oracles, {LEG_NAMES[name]} leg: {ORACLE_RAYS} rays from "
              f"{s0}, {rec['hits']} hit/blocked by K2n; threaded "
              f"{rec['threaded']}, clustered {rec['clustered']}; ms "
              f"{ {k: round(v, 3) for k, v in ms.items()} } ({card})",
              flush=True)
        out[name] = rec
    return out


def _shard_inputs(torch, st, seed, frames, moving):
    """FrameInputs of ``frames`` frames as Renderer.step makes them from
    ``seed`` (the host generator's seeds and jitter), the camera moved
    between frames when ``moving``."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.ops.reproject import (
        reprojection_frustum,
    )
    from webgpu_raytracing_tpu_torch.renderer import FrameInputs

    g = np.random.default_rng(seed)
    cam, prev, out, fc = Camera(), np.eye(4, dtype=np.float32), [], 0
    jitter = None
    for k in range(frames):
        frame_seed = int(g.integers(0, 2**32, dtype=np.uint64))
        rate = st.reprojection_rate
        update = rate == 0 or fc % rate == 0
        if rate:
            fc = (fc + 1) % rate
        if update or jitter is None:
            jitter = (g.random(2).astype(np.float32) - 0.5) * (
                st.jitter_strength)
        view = cam.view_matrix()
        out.append((FrameInputs(
            view=torch.as_tensor(view, device=DEVICE), seed=frame_seed,
            counter=k, jitter=torch.as_tensor(jitter, device=DEVICE),
            frustum=torch.as_tensor(reprojection_frustum(
                prev, st.render_width, st.render_height, st.fov),
                device=DEVICE),
            prev_origin=torch.as_tensor(np.asarray(prev[:3, 3], np.float32),
                                        device=DEVICE)), update))
        if update:
            prev = view
        if moving:
            cam.move(np.array([0.05, 0.0, -0.1], np.float32))
    return out


def compare_sharded(torch, tables, paths, seed, card):
    """``render_sharded`` over every visible card, or two slabs on cuda:0
    when there is one, against ``render_frame`` on one device: one 1080p
    frame, and ``SHARD_FRAMES`` frames with reprojection every 2nd frame,
    jitter 0.5, the hit predictor and a moving camera (``prev_image``
    too), bit for bit; both timed, the sharded frames' launches counted
    from 0. The single-device run rotates the prev buffers on
    render_sharded's schedule."""
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.parallel.shard import (
        make_mesh, render_sharded,
    )
    from webgpu_raytracing_tpu_torch.renderer import (
        FrameBuffers, render_frame,
    )

    n_cards = torch.cuda.device_count()
    mesh = make_mesh() if n_cards > 1 else [DEVICE, DEVICE]
    env = torch.zeros((1, 1, 3), device=DEVICE)
    out = dict(mesh=[str(m) for m in mesh])
    base = RenderSettings(**SLICE)
    cases = {
        "sharded": (base, 1, False),
        "sharded_reprojection": (
            base.replace(reprojection_rate=2, jitter_strength=0.5,
                         use_hit_predictor=True), SHARD_FRAMES, True),
    }
    for key, (st, frames, moving) in cases.items():
        inputs = _shard_inputs(torch, st, seed, frames, moving)

        def single():
            bufs = FrameBuffers.create(st.render_width, st.render_height,
                                       DEVICE)
            rays = 0.0
            for inp, update in inputs:
                bufs, r = render_frame(bufs, tables, env, inp, st)
                rays += float(r)
                if update and (st.reproject or st.use_hit_predictor):
                    bufs = bufs.rotated()
            return bufs, rays

        def sharded():
            return render_sharded(tables, env, st, frames, mesh=mesh,
                                  inputs_fn=lambda k: inputs[k][0])

        single()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, rays = single()
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) / frames * 1e3
        _zero_launch_counts()
        t0 = time.perf_counter()
        got, s_rays = sharded()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / frames * 1e3
        launches = _launch_counts()
        expect = launches_per_frame(near_closest=6 * len(mesh) * frames)
        if launches != expect:
            fail(f"{key}: launches {launches}, expected {expect}")
        for f in ("image", "prev_image", "geo_face", "geo_position"):
            if not _bits_equal(torch, getattr(got, f), getattr(want, f)):
                fail(f"{key}: {f} differs from the single-device frames")
        if s_rays != rays or not rays > 0:
            fail(f"{key}: {s_rays} rays sharded, {rays} single")
        print(f"{key}: {frames} frame(s) of {st.width}x{st.height} over "
              f"{out['mesh']}: {ms:.1f} ms/frame sharded, {single_ms:.1f} "
              f"ms/frame on one device, bit for bit equal (image, "
              f"prev_image, G-buffer), launches "
              f"{ {w: n for w, n in zip(WRAPPERS, launches) if n} } "
              f"({card})", flush=True)
        paths[key] = dict(launches=launches, ms_per_frame=ms,
                          mrays=rays / frames / ms / 1e3,
                          single_device_ms_per_frame=single_ms,
                          frames=frames)
        out[key] = paths[key]
        del want, got
    return out


def wgsl_scene():
    """The scene of tests/test_torch_validation.py: a light, a sphere off
    the optical axis, the floor and a cube."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.models import test_models as tm
    from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets

    return scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0.35, 0.2, -4), 1.0, lat=8, lon=10)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def synthetic_equirect(h=64, w=128):
    """tests/test_reference_parity.py's stand-in sky: a gradient with a
    bright sun patch."""
    import numpy as np

    ys = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xs = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    r = 0.4 + 0.5 * ys + 0.05 * np.sin(xs * 12.0)
    g = 0.5 + 0.4 * ys + 0.05 * np.cos(xs * 7.0)
    b = 0.8 + 0.2 * ys
    img = np.stack([np.broadcast_to(c, (h, w)) for c in (r, g, b)],
                   axis=-1).astype(np.float32)
    sun = np.exp(-(((ys - 0.75) * 8.0) ** 2 + ((xs - 0.3) * 8.0) ** 2))
    return img + 20.0 * sun.astype(np.float32)[..., None] * np.array(
        [1.0, 0.9, 0.7], np.float32)


def compare_wgsl(torch, card):
    """The card's 12x12 frame against the WGSL-semantics simulator
    (validation/wgsl_sim.py) at seed 777, one sample and three bounces
    per path: equal spp, RMSE <= 1e-2 (BASELINE.md)."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.camera import Camera
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.renderer import Renderer
    from webgpu_raytracing_tpu_torch.validation.wgsl_sim import (
        WGSLReference,
    )

    st = RenderSettings(width=WGSL_SIZE, height=WGSL_SIZE,
                        environment="equirect", sample_count=1,
                        bounces_depth=4)
    env = synthetic_equirect()
    scene = wgsl_scene()
    t0 = time.perf_counter()
    sim = WGSLReference(scene, st, env)
    sim.step(WGSL_SEED, Camera().view_matrix())
    sim_s = time.perf_counter() - t0
    r = Renderer(scene, st, env_data=env, device=DEVICE)
    r.step(seed=WGSL_SEED)
    ours = r.buffers.image.cpu().numpy()
    if not (ours[..., 3] == sim.image[..., 3]).all():
        fail("WGSL semantics: sample counts differ from the simulator's")

    def norm(img):
        return img[..., :3] / np.maximum(img[..., 3:4], 1e-20)

    rmse = float(np.sqrt(np.mean((norm(ours) - norm(sim.image)) ** 2)))
    n_diff = int((ours[..., :3] != sim.image[..., :3]).any(-1).sum())
    print(f"WGSL semantics: {WGSL_SIZE}x{WGSL_SIZE} frame on the card vs "
          f"the simulator (seed {WGSL_SEED}, {sim_s:.1f} s): RMSE {rmse!r}, "
          f"{n_diff} pixels differ ({card})", flush=True)
    if not rmse <= 1e-2:
        fail(f"WGSL semantics: RMSE {rmse} > 1e-2")
    return dict(rmse=rmse, pixels_differ=n_diff, size=WGSL_SIZE)


def phase_port_completion(torch, scene, paths, frames, seed, card):
    """6b. What the rest of the package adds, at the slice's width:
    ``chained_sort`` (sorted 1080p frames, plain and NEE, equal bit for
    bit with and without the chain, 6 (+ 6) K2n launches a frame each);
    ``render_sharded`` against ``render_frame`` (:func:`compare_sharded`);
    the oracles against K2n on frame 0's legs (:func:`compare_oracles`);
    ``traversal`` ``"pallas"`` (the kernels, 6 K2n launches a frame) and
    ``"pallas_interpret"`` (the twins, none) at 256x256, equal to the
    default frame bit for bit; the WGSL-semantics frame
    (:func:`compare_wgsl`). → its JSON record."""
    from webgpu_raytracing_tpu_torch.config import RenderSettings

    t_phase = time.perf_counter()
    out = {}
    srt = RenderSettings(**SLICE).replace(sort_bounce_rays=True)
    imgs = {}
    # a key per sorted leg (4 closest-hit, 4 shadow a frame); chained, a
    # key per segment past the first (4 a frame)
    for key, st, counts in (
        ("sorted_near", srt, dict(near_closest=6, top_keys=4)),
        ("chained", srt.replace(chained_sort=True),
         dict(near_closest=6, top_keys=4)),
        ("sorted_near_nee", srt.replace(next_event_estimation=True),
         dict(near_closest=6, near_any=6, top_keys=8)),
        ("chained_nee", srt.replace(next_event_estimation=True,
                                    chained_sort=True),
         dict(near_closest=6, near_any=6, top_keys=4)),
    ):
        paths[key], r = drive_path(
            torch, key.replace("_", " ") + " path", scene, st, frames, seed,
            card, launches_per_frame(**counts),
            finite=not st.next_event_estimation)
        imgs[key] = r.buffers.image.clone()
        del r
    for a, b in (("chained", "sorted_near"), ("chained_nee",
                                              "sorted_near_nee")):
        if not _bits_equal(torch, imgs[a], imgs[b]):
            fail(f"{a}: the frame differs from the {b} frame")
        print(f"{a} vs {b}: equal bit for bit, "
              f"{paths[a]['ms_per_frame']:.1f} vs "
              f"{paths[b]['ms_per_frame']:.1f} ms/frame ({card})",
              flush=True)
    for a, b in (("sorted_near", "default"), ("chained", "default"),
                 ("sorted_near_nee", "nee"), ("chained_nee", "nee")):
        faster = paths[a]["ms_per_frame"] < paths[b]["ms_per_frame"]
        print(f"{a} path {paths[a]['ms_per_frame']:.1f} ms/frame, peak "
              f"{paths[a]['peak_gib']:.2f} GiB, against the {b} path's "
              f"{paths[b]['ms_per_frame']:.1f} ms/frame, peak "
              f"{paths[b]['peak_gib']:.2f} GiB: "
              f"{'faster' if faster else 'not faster'} ({card})", flush=True)
    out["chained"] = {k: paths[k] for k in imgs}
    del imgs

    tables = scene.tables(torch.device(DEVICE))
    out["sharded"] = compare_sharded(torch, tables, paths, seed, card)
    legs = frame0_legs(torch, tables, RenderSettings(**SLICE), seed)
    out["oracles"] = compare_oracles(torch, tables, legs, card)
    del legs, tables

    small = RenderSettings(**{**SLICE, "width": COMPLETION_SIZE,
                              "height": COMPLETION_SIZE})
    routes = {}
    for trav, counts in (("auto", dict(near_closest=6)),
                         ("pallas", dict(near_closest=6)),
                         ("pallas_interpret", {})):
        key = f"traversal_{trav}"
        paths[key], r = drive_path(
            torch, f"traversal={trav} path", scene,
            small.replace(traversal=trav), 1, seed, card,
            launches_per_frame(**counts))
        routes[trav] = r.buffers.image.clone()
        del r
    for trav in ("pallas", "pallas_interpret"):
        if not _bits_equal(torch, routes[trav], routes["auto"]):
            fail(f"traversal={trav}: the frame differs from the default")
    print(f"traversal pallas and pallas_interpret at {COMPLETION_SIZE}^2: "
          "equal to the default frame bit for bit", flush=True)
    out["traversal"] = {k: paths[f"traversal_{k}"] for k in routes}
    out["wgsl"] = compare_wgsl(torch, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"port_completion": out}), flush=True)
    return out


def phase_config5_kernels(torch, tables, seed, card):
    """7a/7b: K3 vs twins on one 4K slab's frame-0 legs of the 1M scene,
    then the K3 route (super entry distances + K3) against the K1 route
    (entry distances over every cluster + K1) on the primary and bounce
    rays: identical face ids, both timed; the key kernel against its twin
    on the bounce rays over the 227 supers."""
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    st = RenderSettings(**CONFIG5)
    rows = st.render_height // st.frame_slabs
    legs = frame0_legs(torch, tables, st, seed, row0=CONFIG5_SLAB * rows,
                       rows=rows)
    closest, anyhit = compare_legs(torch, tables, legs, card, st.trace_tile,
                                   label="config #5 slab ")
    pairs = compare_pairs_legs(torch, tables, legs, card, st.trace_tile,
                               label="config #5 slab ")
    # K3 / K3p ordering their supers themselves: against their twins, and
    # bit for bit against K3 / K3p over the order sorted outside
    near = {}
    for key in ("primary", "bounce", "nee"):
        any_hit = key in SHADOW_LEGS
        select = cc.trace_any_args if any_hit else cc.trace_closest_args
        ref_args = cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                    **legs[key])
        ref_wrapper = select(ref_args)[0]
        ref = ref_wrapper(**ref_args)
        del ref_args
        args = cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                near="kernel", **legs[key])
        if args.variant != "near_two_level" or "snear" in args:
            fail("config #5: near='kernel' did not select the in-kernel "
                 "super order")
        near[key] = _compare_leg(
            torch, f"config #5 slab {LEG_NAMES[key]}, order in the kernel",
            args, card, any_hit, ref_out=(ref_wrapper.__name__, ref))
        del args, ref
    near_pairs = compare_pairs_legs(
        torch, tables, legs, card, st.trace_tile,
        label="config #5 slab, order in the kernel, ", near="kernel")
    routes = {}
    for key in ("primary", "bounce"):
        leg = legs[key]

        def prep(two_level):
            return cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                    two_level=two_level, **leg)

        def route(two_level):
            args = prep(two_level)
            return cc.trace_closest_args(args)[0](**args)[1]

        faces = {tl: cc.code_to_face(route(tl), tables.clusters.face_id)
                 for tl in (True, False)}
        torch.cuda.synchronize()
        mismatch = int((faces[True] != faces[False]).sum())
        def near_route():
            args = cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                    near="kernel", **leg)
            return cc.trace_closest_args(args)[0](**args)[1]

        a1 = prep(False)
        ms = dict(
            near_two_level_route=_time_cuda(torch, near_route, 3),
            two_level_route=_time_cuda(torch, lambda: route(True), 3),
            two_level_prep=_time_cuda(torch, lambda: prep(True), 3),
            single_level_route=_time_cuda(torch, lambda: route(False), 1,
                                          warm=False),
            single_level_prep=_time_cuda(torch, lambda: prep(False), 1,
                                         warm=False),
            k1_kernel=_time_cuda(torch, lambda: cc.trace_closest_tiles(**a1),
                                 3),
        )
        del a1
        print(f"config #5 slab {key}: K3 route with the order made in the "
              f"kernel {ms['near_two_level_route']:.3f} ms, K3 route "
              f"{ms['two_level_route']:.3f} ms"
              f" (prep {ms['two_level_prep']:.3f}), K1 route over all "
              f"{tables.clusters.box.shape[0]} clusters "
              f"{ms['single_level_route']:.3f} ms (prep "
              f"{ms['single_level_prep']:.3f}, K1 {ms['k1_kernel']:.3f}); "
              f"face mismatches {mismatch} of {faces[True].numel()} ({card})",
              flush=True)
        if mismatch:
            fail(f"config #5 {key}: K3 and K1 routes differ on {mismatch} "
                 "faces")
        routes[key] = dict(mismatch=mismatch, **ms)
    o, d, tm, _ = _fold(torch, legs["bounce"])  # the sorted trace's key
    key = _compare_keys(torch, "key, config #5 slab bounce over the supers",
                        o, d, tm, tables.clusters.sort_box, 2, card)
    return closest, anyhit, pairs, routes, near, near_pairs, key


def _bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_config5_slabs_resume(torch, tables, seed, card):
    """7d: slabs vs one slab, and checkpoint resume, bit for bit."""
    import dataclasses

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.renderer import FrameBuffers, Renderer

    st = RenderSettings(width=CONFIG5_CHECK[0], height=CONFIG5_CHECK[1],
                        frame_slabs=8)

    def run(settings, steps):
        r = Renderer(Prebuilt(tables), settings, base_seed=seed,
                     device=DEVICE)
        for _ in range(steps):
            r.step()
        return r

    def same(a, b):
        return all(
            _bits_equal(torch, getattr(a.buffers, f.name),
                        getattr(b.buffers, f.name))
            for f in dataclasses.fields(FrameBuffers)
        )

    slabs, whole = run(st, 1), run(st.replace(frame_slabs=1), 1)
    if not same(slabs, whole):
        fail("config #5: 8 slabs differ from 1 slab")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "config5_checkpoint.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    uninterrupted = run(st, 2)
    slabs.save_checkpoint(path)
    resumed = run(st, 0)
    resumed.load_checkpoint(path)
    resumed.step()
    if not same(resumed, uninterrupted):
        fail("config #5: the resumed run differs from the uninterrupted one")
    os.unlink(path)
    print(f"config #5 at {st.width}x{st.height}: 8 slabs = 1 slab bit for "
          "bit; resume from a checkpoint = uninterrupted run bit for bit "
          f"({card})", flush=True)


# --- 8. the front door: OBJ/MTL → load_scene → CLI, features, viewer ---

# the bundled OBJ's size: 22,278 triangles, 44,556 faces two-sided
FRONTEND_TRIANGLES = 22_278
FRONTEND_SIZE = (1920, 1080)
FRONTEND_CHECK = 64  # side of the card-vs-CPU frames
FRONTEND_ROUNDS = 8  # timed frames of each feature, interleaved
FRONTEND_FEATURES = {
    "default": {},
    "reprojection_rate=4": dict(reprojection_rate=4),
    "use_hit_predictor": dict(use_hit_predictor=True),
    "debug_bvh": dict(debug_bvh=True),
    "resolution_scale=0.5": dict(resolution_scale=0.5),
    "geometry_buffer_scale=0.5": dict(geometry_buffer_scale=0.5),
}
# the spheres of stress_scene moved in front of the default camera, and
# the room around them (x = ±6, floor, ceiling, back wall)
FRONTEND_SHIFT = (1.25, -1.5, -6.0)
ROOM_X, ROOM_FLOOR, ROOM_CEILING, ROOM_BACK, ROOM_FRONT = (
    6.0, -1.5, 3.0, -14.0, 2.0)


def _quad(a, b, c, d):
    import numpy as np

    return [np.array([a, b, c], np.float32), np.array([a, c, d], np.float32)]


def write_obj_scene(directory: str, n_triangles: int):
    """A Cornell-style OBJ/MTL scene in ``directory``: ten ``o`` groups in
    the reference's load order (Light, back_wall, ceiling, Dodecahedron,
    Floor, Ladder, left_wall, right_wall, Suzanne, TallBox), so that
    ``load_scene``'s REFERENCE_SUBSET keeps eight of them with Light first
    and drops Ladder and right_wall; the spheres of
    ``stress_scene(n_triangles)`` (with their vertex normals) fill the
    three object groups. → (obj path, mtl path, triangles written)."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    src = stress_scene(n_triangles)
    spheres = [m for m in src.models if m.name.startswith("sphere_")]
    x, fl, ce, bk, fr = ROOM_X, ROOM_FLOOR, ROOM_CEILING, ROOM_BACK, ROOM_FRONT
    ly = ce - 0.05
    groups = [
        ("Light", "Light",
         _quad([-1, ly, -9], [1, ly, -9], [1, ly, -7], [-1, ly, -7])),
        ("back_wall", "White",
         _quad([-x, fl, bk], [x, fl, bk], [x, ce, bk], [-x, ce, bk])),
        ("ceiling", "White",
         _quad([-x, ce, fr], [x, ce, fr], [x, ce, bk], [-x, ce, bk])),
        ("Dodecahedron", None, spheres[0::3]),
        ("Floor", "White",
         _quad([-x, fl, bk], [-x, fl, fr], [x, fl, fr], [x, fl, bk])),
        ("Ladder", "White",
         [np.array([[20, 0, 20], [21, 0, 20], [20, 1, 20]], np.float32)]),
        ("left_wall", "Red",
         _quad([-x, fl, fr], [-x, fl, bk], [-x, ce, bk], [-x, ce, fr])),
        ("right_wall", "Green",
         _quad([x, fl, bk], [x, fl, fr], [x, ce, fr], [x, ce, bk])),
        ("Suzanne", None, spheres[1::3]),
        ("TallBox", None, spheres[2::3]),
    ]
    mtl = ["newmtl Light", "Kd 0.8 0.8 0.8", "Ke 1 1 1",
           "newmtl White", "Kd 0.73 0.73 0.73",
           "newmtl Red", "Kd 0.65 0.05 0.05",
           "newmtl Green", "Kd 0.12 0.45 0.15"]
    for k, m in enumerate(spheres):
        color = src.mat_color[int(m.faces.material_idx[0])]
        mtl += [f"newmtl Sphere{k}", "Kd %.6f %.6f %.6f" % tuple(color)]
    shift = np.array(FRONTEND_SHIFT, np.float32)
    lines = ["# a Cornell-style room around stress_scene's spheres",
             "mtllib scene.mtl"]
    nv = nn = tris = 0
    for name, mat, body in groups:
        lines.append(f"o {name}")
        if mat is not None:
            lines.append(f"usemtl {mat}")
            for tri in body:
                lines += ["v %.9g %.9g %.9g" % tuple(p) for p in tri]
                lines.append(f"f {nv + 1} {nv + 2} {nv + 3}")
                nv += 3
                tris += 1
            continue
        for m in body:
            fs = m.faces
            f = len(fs)
            lines.append(f"usemtl Sphere{spheres.index(m)}")
            p = np.stack([fs.p0, fs.p0 + fs.e1, fs.p0 + fs.e2], 1) + shift
            n = np.stack([fs.n0, fs.n1, fs.n2], 1)
            lines += ["v %.9g %.9g %.9g" % tuple(q) for q in p.reshape(-1, 3)]
            lines += ["vn %.9g %.9g %.9g" % tuple(q)
                      for q in n.reshape(-1, 3)]
            iv = nv + 1 + np.arange(3 * f).reshape(f, 3)
            ino = nn + 1 + np.arange(3 * f).reshape(f, 3)
            lines += ["f %d//%d %d//%d %d//%d" % (a, b, c, d, e, g)
                      for (a, c, e), (b, d, g) in zip(iv.tolist(),
                                                      ino.tolist())]
            nv += 3 * f
            nn += 3 * f
            tris += f
    obj_path = os.path.join(directory, "scene.obj")
    mtl_path = os.path.join(directory, "scene.mtl")
    with open(obj_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(mtl_path, "w") as fh:
        fh.write("\n".join(mtl) + "\n")
    return obj_path, mtl_path, tris


def _near_only(name, launches, n):
    """Launch counts of a default-order 1080p run: ``n`` K2n closest-hit
    launches and no other."""
    expect = tuple(n * x for x in launches_per_frame(near_closest=1))
    if launches != expect:
        fail(f"{name}: launches {launches} of {WRAPPERS}, expected {expect}")


def drive_features(torch, tables, width, height, rounds, seed, card):
    """Every per-pixel feature of ``FRONTEND_FEATURES`` at ``width`` x
    ``height``: one Renderer each, one warm-up frame each, then ``rounds``
    rounds that time one frame of every Renderer in turn (the camera moved
    before each frame where reprojection is on), so that drift between
    rounds falls on all of them alike. Each feature's launches are counted
    from 0 over its timed frames and must be the default order's; finite
    accumulation and display images. Per feature: the frame times, their
    median, ms/frame and Mrays/s over all its frames, the display image's
    ms, and the median of its frame minus the default frame of the same
    round. → ({name: path dict}, {name: Renderer})."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    renderers = {}
    for name, kw in FRONTEND_FEATURES.items():
        st = RenderSettings(width=width, height=height, **kw)
        renderers[name] = Renderer(Prebuilt(tables), st, base_seed=seed,
                                   device=DEVICE)
        renderers[name].step()
    torch.cuda.synchronize()
    launches = {name: np.zeros(len(WRAPPERS), np.int64) for name in renderers}
    frame_ms = {name: [] for name in renderers}
    rays = dict.fromkeys(renderers, 0.0)
    for _ in range(rounds):
        for name, r in renderers.items():
            _zero_launch_counts()
            t0 = time.perf_counter()
            if r.settings.reproject:
                r.move_camera([0.02, 0.0, 0.0])
            r.step()
            torch.cuda.synchronize()
            frame_ms[name].append((time.perf_counter() - t0) * 1e3)
            rays[name] += r.last_rays
            launches[name] += _launch_counts()
    paths = {}
    for name, r in renderers.items():
        st = r.settings
        counts = tuple(int(n) for n in launches[name])
        _near_only(name, counts, 6 * rounds)
        if not bool(torch.isfinite(r.buffers.image).all()):
            fail(f"{name}: the accumulation buffer is not finite")
        t0 = time.perf_counter()
        disp = r.image()
        image_ms = (time.perf_counter() - t0) * 1e3
        if disp.shape != (st.height, st.width, 3) or not np.isfinite(
                disp).all():
            fail(f"{name}: display image {disp.shape}, finite "
                 f"{bool(np.isfinite(disp).all())}")
        times = frame_ms[name]
        ms = sum(times) / rounds
        delta = float(np.median(np.subtract(times, frame_ms["default"])))
        paths[name] = dict(
            launches=counts, ms_per_frame=ms,
            median_ms=float(np.median(times)), frame_ms=times,
            delta_ms=delta, mrays=rays[name] / (ms * rounds / 1e3) / 1e6,
            image_ms=image_ms)
        print(f"frontend {name}: {rounds} frames of {st.width}x{st.height} "
              f"(render {st.render_width}x{st.render_height}, G-buffer rows "
              f"{st.geo_height}) interleaved with the other features, "
              f"median {paths[name]['median_ms']:.1f} ms/frame (frames "
              f"{[round(t, 1) for t in times]}), median {delta:+.1f} ms "
              f"against the default frame of the same round, "
              f"{paths[name]['mrays']:.3f} Mrays/s, display image "
              f"{image_ms:.1f} ms, launches "
              f"{ {w: n for w, n in zip(WRAPPERS, counts) if n} } ({card})",
              flush=True)
    return paths, renderers


def _features_card_vs_cpu(torch, tables_cpu, tables_card, seed):
    """Each feature on a 64x64 frame, card against the CPU twins: two
    frames (the camera moved between them), equal NaN masks, RMSE < 1e-5
    on the accumulation and on the display image."""
    import numpy as np

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    out = {}
    for name, kw in FRONTEND_FEATURES.items():
        st = RenderSettings(width=FRONTEND_CHECK, height=FRONTEND_CHECK, **kw)
        imgs = []
        for dev, tables in ((DEVICE, tables_card), ("cpu", tables_cpu)):
            r = Renderer(Prebuilt(tables), st, base_seed=seed, device=dev)
            r.step()
            r.camera.move(np.array([0.02, 0.0, 0.0], np.float32))
            r.step()
            imgs.append((r.buffers.image.cpu().numpy(), r.image()))
        (card_acc, card_disp), (cpu_acc, cpu_disp) = imgs
        rmse = []
        for a, b in ((card_acc, cpu_acc), (card_disp, cpu_disp)):
            nan = np.isnan(b)
            if not (np.isnan(a) == nan).all():
                fail(f"frontend {name}: NaN masks differ, card and CPU")
            rmse.append(float(np.sqrt(np.mean((a[~nan] - b[~nan]) ** 2))))
        print(f"frontend {name}: {FRONTEND_CHECK}x{FRONTEND_CHECK}, card vs "
              f"CPU twins, RMSE accumulation {rmse[0]:.3g}, display "
              f"{rmse[1]:.3g}", flush=True)
        if not max(rmse) < 1e-5:
            fail(f"frontend {name}: RMSE {max(rmse)} >= 1e-5, card vs CPU")
        out[name] = rmse
    return out


def predictor_legs(torch, r, tables, seed, card):
    """The primary leg of a frame of Renderer ``r`` (``use_hit_predictor``,
    after its frames): ``t_max`` from the quads of its previous G-buffer,
    through K2n against its twin (0 mismatches), and against the same rays
    with ``t_max`` = F32_MAX: the faces must be equal wherever the
    predictor's candidate face re-hits; both legs timed."""
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops import rng
    from webgpu_raytracing_tpu_torch.ops.predictor import (
        predict_hit_dist, quad_faces,
    )
    from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

    st = r.settings
    dev = torch.device(DEVICE)
    w, h = st.render_width, st.render_height
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.int32, device=dev),
        torch.arange(w, dtype=torch.int32, device=dev), indexing="ij",
    )
    idx = (xs + ys * w).reshape(-1)
    pos = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    view = torch.as_tensor(r.camera.view_matrix(), device=dev)
    o, d, _ = camera_rays(pos, view, rng.seed_state(seed + 1, idx), st)
    quads = quad_faces(r.buffers.prev_geo_face).reshape(-1, 4)
    t_max = predict_hit_dist(o, d, quads, tables)
    unbounded = torch.full_like(t_max, F32_MAX)
    rehit = t_max < F32_MAX
    legs = {}
    codes = {}
    for key, tm in (("bounded", t_max), ("unbounded", unbounded)):
        args = cc.prepare_tiles(o, d, tm, tables, tile=st.trace_tile,
                                near="kernel")
        if args.variant != "near":
            fail(f"predictor leg: variant {args.variant}, expected K2n")
        legs[key] = _compare_leg(torch, f"K2n primary leg, t_max {key}",
                                 args, card)
        wrapper = cc.trace_closest_args(args)[0]
        codes[key] = wrapper(**args)[1]
    diff = codes["bounded"] != codes["unbounded"]
    n_rehit = int(rehit.sum())
    bad = int((diff & rehit).sum())
    print(f"predictor leg: {n_rehit} of {rehit.numel()} rays re-hit a quad "
          f"candidate (finite t_max); faces that differ from the unbounded "
          f"leg's there: {bad}, elsewhere {int((diff & ~rehit).sum())}; K2n "
          f"{legs['bounded']['ms']:.3f} ms bounded vs "
          f"{legs['unbounded']['ms']:.3f} ms unbounded ({card})", flush=True)
    if bad:
        fail(f"predictor leg: {bad} re-hit rays changed face under the bound")
    if n_rehit < rehit.numel() // 4:
        fail(f"predictor leg: only {n_rehit} rays have a finite bound")
    return dict(rehit_rays=n_rehit, rays=int(rehit.numel()),
                rehit_face_mismatches=bad, **legs)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_on_card(torch, tables, seed, card, max_frames=40):
    """The viewer's serve loop in a thread on a card Renderer at 1080p:
    a frame and the stats over HTTP, a look input that restarts the
    accumulation, a ``set`` of ``resolution_scale``; the loop's launches
    (6 K2n a frame) and its smoothed timings."""
    import threading
    import urllib.request

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.frontend.viewer import serve
    from webgpu_raytracing_tpu_torch.renderer import Renderer

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.read()

    def post(obj):
        req = urllib.request.Request(base + "/input",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            resp.read()

    def wait(cond, what, seconds=120):
        deadline = time.time() + seconds
        while time.time() < deadline:
            if cond():
                return
            time.sleep(0.02)
        fail(f"viewer: timed out waiting for {what}")

    w, h = FRONTEND_SIZE
    r = Renderer(Prebuilt(tables), RenderSettings(width=w, height=h),
                 base_seed=seed, device=DEVICE)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    _zero_launch_counts()
    errors = []

    def run():
        try:
            serve(r, port=port, max_frames=max_frames)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            raise

    t0 = time.perf_counter()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    wait(lambda: r.counter >= 3, "three frames")
    png = get("/frame.png")
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        fail("viewer: /frame.png is not a PNG")
    stats = json.loads(get("/stats.json"))
    if (stats["width"], stats["height"]) != (w, h) or stats["counter"] < 1:
        fail(f"viewer: stats {stats}")
    before = stats["counter"]
    post({"type": "look", "dx": 30.0, "dy": 0.0})
    wait(lambda: json.loads(get("/stats.json"))["counter"] < before,
         "the look input to restart the accumulation")
    c0 = r.counter
    wait(lambda: r.counter >= c0 + 2, "two frames after the look")
    full = json.loads(get("/stats.json"))  # before the half-size frames
    post({"type": "set", "name": "resolution_scale", "value": 0.5})
    wait(lambda: r.settings.resolution_scale == 0.5,
         "the set of resolution_scale")
    last = full
    while th.is_alive():
        try:
            last = json.loads(get("/stats.json"))
        except OSError:  # the loop ended and shut its server down
            break
        time.sleep(0.05)
    th.join(timeout=300)
    wall = time.perf_counter() - t0
    if th.is_alive() or errors:
        fail(f"viewer: the serve loop did not end cleanly ({errors})")
    launches = _launch_counts()
    _near_only("viewer", launches, 6 * max_frames)
    print(f"viewer: {max_frames} frames served from the card in {wall:.1f} "
          f"s; at {w}x{h} smoothed {full['smoothed_ms']:.1f} ms/frame, "
          f"{full['smoothed_mrays']:.3f} Mrays/s; after the set of "
          f"resolution_scale 0.5 {last['smoothed_ms']:.1f} ms/frame, "
          f"{last['smoothed_mrays']:.3f} Mrays/s ({card})", flush=True)
    return dict(launches=launches, wall_s=wall, frames=max_frames,
                ms_per_frame=full["smoothed_ms"],
                mrays=full["smoothed_mrays"],
                half_scale_ms=last["smoothed_ms"],
                half_scale_mrays=last["smoothed_mrays"])


def phase_frontend(torch, paths, seed, card):
    """8. An OBJ/MTL scene written to disk, loaded natively and in Python
    (equal tables); ``cli render`` at 1080p on the card, byte for byte the
    PNG of a Renderer built from ``load_scene`` on the same files and
    seed; ``cli bench``; each per-pixel feature at 1080p and, at 64x64,
    card against CPU; the predictor-bounded K2n leg; the viewer. Each run
    of the main path counts its launches from 0 into ``paths``. → the
    numbers for the kernels line."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.frontend import cli
    from webgpu_raytracing_tpu_torch.models.scene import (
        load_scene, tables_to_numpy,
    )
    from webgpu_raytracing_tpu_torch.renderer import Renderer
    from webgpu_raytracing_tpu_torch.utils.image import write_png

    t_phase = time.perf_counter()
    out = {}
    w, h = FRONTEND_SIZE
    size = f"{w}x{h}"
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        # 1. write and load
        t0 = time.perf_counter()
        obj, mtl, tris = write_obj_scene(tmp, FRONTEND_TRIANGLES)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = load_scene(obj, mtl)
        native_s = time.perf_counter() - t0
        os.environ["WRT_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            py_scene = load_scene(obj, mtl)
            python_s = time.perf_counter() - t0
        finally:
            del os.environ["WRT_NO_NATIVE"]
        faces = sum(len(m.faces) for m in scene.models)
        print(f"frontend: wrote {tris} triangles ({os.path.getsize(obj)} "
              f"bytes of OBJ) in {write_s:.1f} s; load_scene took the "
              f"{scene.loader} path ({native_s:.2f} s), with WRT_NO_NATIVE "
              f"the {py_scene.loader} path ({python_s:.2f} s); models "
              f"{[m.name for m in scene.models]}, {faces} faces", flush=True)
        if scene.loader != "native" or py_scene.loader != "python":
            fail(f"frontend: loader paths {scene.loader} / "
                 f"{py_scene.loader}, expected native / python")
        tables = scene.tables(torch.device(DEVICE))
        a = tables_to_numpy(tables)
        b = tables_to_numpy(py_scene.tables(torch.device(DEVICE)))
        if set(a) != set(b) or not all(np.array_equal(a[k], b[k])
                                       for k in a):
            fail("frontend: native and Python loads give other tables")
        del py_scene, a, b
        out["scene"] = dict(triangles=tris, faces=faces, loader=scene.loader,
                            native_s=native_s, python_s=python_s)

        # 2. cli render and the same frames through Renderer; cli bench
        common = ["--obj", obj, "--mtl", mtl, "--size", size, "--seed",
                  str(seed), "--device", DEVICE]
        png_cli = os.path.join(tmp, "cli.png")
        metrics = os.path.join(tmp, "m.jsonl")
        _zero_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["render", *common, "--spp", "4", "--metrics", metrics,
                      "-o", png_cli])
        torch.cuda.synchronize()
        launches = _launch_counts()
        _near_only("cli render", launches, 12)
        with open(metrics) as fh:
            rows = [json.loads(line) for line in fh]
        wall = sum(rw["frame_ms"] for rw in rows) / 1e3
        paths["frontend_render"] = dict(
            launches=launches, ms_per_frame=wall * 1e3 / len(rows),
            mrays=sum(rw["rays"] for rw in rows) / wall / 1e6)
        direct = Renderer(scene, RenderSettings(width=w, height=h),
                          base_seed=seed, device=DEVICE)
        png_direct = os.path.join(tmp, "direct.png")
        write_png(png_direct, direct.render(4))
        del direct
        with open(png_cli, "rb") as fa, open(png_direct, "rb") as fb:
            same = fa.read() == fb.read()
        print(f"frontend cli render: {len(rows)} frames of {size} at "
              f"{[rw['frame_ms'] for rw in rows]} ms, the PNG "
              f"{'equals' if same else 'DIFFERS from'} the direct "
              f"Renderer's byte for byte ({card})", flush=True)
        if not same:
            fail("frontend: the CLI's PNG differs from the Renderer's")
        _zero_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["bench", *common, "--frames", "4"])
        torch.cuda.synchronize()
        launches = _launch_counts()
        _near_only("cli bench", launches, 6 * 5)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"frontend cli bench: {json.dumps(line)} ({card})", flush=True)
        paths["frontend_bench"] = dict(
            launches=launches, ms_per_frame=line["wall_s_per_frame"] * 1e3,
            mrays=line["value"])
        out["bench"] = line

        # 3. the per-pixel features
        features, renderers = drive_features(
            torch, tables, w, h, FRONTEND_ROUNDS, seed, card)
        for name, p in features.items():
            paths["frontend " + name] = p
        # 4. the predictor's primary leg, bounded, against the unbounded one
        out["predictor_leg"] = predictor_legs(
            torch, renderers["use_hit_predictor"], tables, seed, card)
        del renderers
        out["features"] = features
        out["card_vs_cpu_rmse"] = _features_card_vs_cpu(
            torch, scene.tables(torch.device("cpu")), tables, seed)

        # 5. the viewer
        paths["frontend_serve"] = serve_on_card(torch, tables, seed, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase_frontend: {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--config5-frames", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    card = phase_environment(torch)
    phase_build()
    raygen = phase_raygen(torch, card)
    from webgpu_raytracing_tpu_torch.config import (
        ProjectionType, RenderSettings,
    )
    from webgpu_raytracing_tpu_torch.frontend.cli import analytic_scene
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops.cluster_cuda import is_two_level
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
    shade = {"envis_1080p": phase_shade(
        torch, card, "envis_1080p", scene.tables(torch.device(DEVICE)),
        RenderSettings(**SLICE).replace(environment="equirect",
                                        env_importance_sampling=True),
        0, 1080)}
    rederive = {"slice_1080p": phase_rederive(
        torch, card, "slice_1080p", scene.tables(torch.device(DEVICE)),
        RenderSettings(**SLICE), 0, 1080)}
    direct_st = RenderSettings(width=256, height=256, bounces_depth=1,
                               projection_type=ProjectionType.PERSPECTIVE)
    direct_tables = analytic_scene().tables(torch.device(DEVICE))
    light = {"direct_256": phase_light(
        torch, card, "direct_256", direct_tables, direct_st,
        _direct_lanes(torch, direct_tables, direct_st, a.seed))}
    del direct_tables
    closest, anyhit, pairs, sched, k4, hooked, binned_legs, keys = (
        phase_kernel_vs_twin(torch, scene, sky, a.seed, card))
    paths = phase_paths(torch, scene, sky, a.frames, a.seed, card)
    phase_direct(torch, paths, a.frames, a.seed, card)
    reference = phase_reference(torch)
    completion = phase_port_completion(torch, scene, paths, a.frames, a.seed,
                                       card)
    del scene

    # 7. config #5
    t0 = time.perf_counter()
    scene5 = stress_scene(CONFIG5_TRIANGLES)
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables5 = scene5.tables(torch.device("cuda"))
    torch.cuda.synchronize()
    ct = tables5.clusters
    c, g = ct.box.shape[0], ct.group
    c2 = 0 if ct.super_box is None else ct.super_box.shape[0]
    real = int((ct.face_id[:, 0] >= 0).sum())
    table_bytes = sum(
        x.numel() * x.element_size()
        for x in [getattr(tables5, k) for k in (
            "node_box", "node_meta", "tri", "shade_normal", "face_material",
            "model_face_offset", "model_face_count", "mat_color",
            "mat_emission")]
        + [getattr(ct, k) for k in ("box", "mat_b", "face_id",
                                     "partner_code", "super_box",
                                     "child_box_t")]
        if x is not None
    )
    print(f"config #5 scene: stress_scene({CONFIG5_TRIANGLES}) "
          f"{tables5.tri.shape[0]} faces in {len(scene5.models)} models, "
          f"built in {scene_s:.1f} s; tables on the card in "
          f"{time.perf_counter() - t0:.1f} s: C = {c} clusters ({real} with "
          f"faces), C2 = {c2} supers of G = {g}, {table_bytes} bytes",
          flush=True)
    if not (is_two_level(ct) and g == 64 and c == c2 * g):
        fail(f"config #5: tables are not two-level with G = 64 (C {c}, C2 "
             f"{c2}, G {g})")
    closest5, anyhit5, pairs5, routes, near5, near_pairs5, key5 = (
        phase_config5_kernels(torch, tables5, a.seed, card))
    shade["config5_slab"] = phase_shade(torch, card, "config5_slab", tables5,
                                        RenderSettings(**CONFIG5), 1890, 270)
    rederive["config5_slab"] = phase_rederive(
        torch, card, "config5_slab", tables5, RenderSettings(**CONFIG5), 1890,
        270)
    nee5 = RenderSettings(next_event_estimation=True, **CONFIG5)
    light["config5_slab_nee"] = phase_light(
        torch, card, "config5_slab_nee", tables5, nee5,
        _nee_lanes(torch, tables5, nee5, 1890, 270, 27182818))
    del scene5
    slabs = CONFIG5["frame_slabs"]
    drive_pair(
        torch, paths, "config5", "config #5 frame", Prebuilt(tables5),
        RenderSettings(**CONFIG5), a.config5_frames, a.seed, card,
        dict(near_closest_two_level=6 * slabs),
        dict(closest_two_level=6 * slabs))
    phase_config5_slabs_resume(torch, tables5, a.seed, card)
    drive_pair(
        torch, paths, "config5_nee", "config #5 NEE (1080p)",
        Prebuilt(tables5),
        RenderSettings(width=1920, height=1080, frame_slabs=4,
                       next_event_estimation=True),
        1, a.seed, card,
        dict(near_closest_two_level=24, near_any_two_level=24),
        dict(closest_two_level=24, any_two_level=24), finite=False)
    drive_pair(
        torch, paths, "config5_exact", "config #5 frame, exact pairs",
        Prebuilt(tables5), RenderSettings(exact_pairs=True, **CONFIG5), 1,
        a.seed, card,
        dict(near_pairs_two_level=2 * slabs,
             near_closest_two_level=4 * slabs),
        dict(pairs_two_level=2 * slabs, closest_two_level=4 * slabs))
    del tables5

    # 8. the front door
    frontend = phase_frontend(torch, paths, a.seed, card)

    def by_path(i):
        return {k: v["launches"][i] for k, v in paths.items()
                if v["launches"][i]}

    frame_ms = {k: v["ms_per_frame"] for k, v in paths.items()}
    mrays = {k: v["mrays"] for k, v in paths.items()}
    source = "webgpu_raytracing_tpu_torch/csrc/cluster_trace.cu"
    pallas = "webgpu_raytracing_tpu/ops/cluster_pallas.py"

    def closest_of(legs):
        return {k: v for k, v in legs.items() if k not in SHADOW_LEGS}

    def anyhit_of(legs):
        return {k: v for k, v in legs.items() if k in SHADOW_LEGS}

    def entry(name, replaces, i, legs, main_leg, pipelined_walk=None,
              **extra):
        leg = legs[main_leg]
        held = list(legs.values())
        if pipelined_walk is not None:  # the entry's other walk
            held += list(pipelined_walk.values())
            extra["pipelined_walk"] = pipelined_walk
        launches = by_path(i)
        if not launches:
            fail(f"{name}: no launch on any path")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=max(x["max_abs"] for x in held),
            mismatches=max(x["mismatch"] for x in held),
            ms=leg["ms"], plain_ms=leg["plain_ms"],
            bound_ms=leg["bound_ms"], bound_by=leg["bound_by"],
            library_ms=None, timed_leg=main_leg, legs=legs, **extra,
        )

    print(json.dumps({"kernels": [
        entry("trace_closest_clustered", f"{pallas}:1141", 0, closest,
              "bounce", ms_per_frame=frame_ms, mrays_per_s=mrays,
              sorted_path=paths["sorted"],
              nee_sorted_path=paths["nee_sorted"]),
        entry("trace_any_clustered", f"{pallas}:576 and :1243", 1, anyhit,
              "nee", sample_env_ms=paths["envis"]["sample_env_ms"],
              reference_rmse=reference),
        entry("trace_closest_clustered_two_level", f"{pallas}:1379", 2,
              closest5, "bounce", routes=routes,
              config5_frame=paths["config5_outside"]),
        entry("trace_any_clustered_two_level", f"{pallas}:1379", 3, anyhit5,
              "nee"),
        entry("trace_pairs_clustered",
              f"{pallas}:396 and :436 (pairs=True: _round_pick :236-270, "
              ":335-373; _amb_flag :376)", 4, pairs, "bounce",
              exact_path=paths["exact_outside"]),
        entry("trace_pairs_clustered_two_level",
              f"{pallas}:1379 (pairs=True: :1406-1410, :1443-1458, "
              ":1566-1569)", 5, pairs5, "bounce",
              config5_exact_frame=paths["config5_exact_outside"]),
        entry("trace_sched_clustered",
              f"{pallas}:841 (_kernel_sched, called at :1932)", 6,
              sched["K5 rounds of 4"], "bounce",
              rounds_of_1=sched["K5 rounds of 1"],
              rounds_of_8=sched["K5 rounds of 8"],
              sched_path=paths["sched"]),
        entry("trace_near_closest_clustered",
              f"{pallas}:436 (_kernel_one_tile in_near=True, :469-490)", 7,
              {**closest_of(sched["K2n"]),
               "predictor primary": frontend["predictor_leg"]["bounded"],
               "predictor unbounded": frontend["predictor_leg"]["unbounded"]},
              "bounce", routes=sched["routes"],
              pipelined_walk=closest_of(sched["K2n pipelined"]),
              near_path=paths["default"],
              predictor_leg=frontend["predictor_leg"],
              frontend={k: v for k, v in frontend.items()
                        if k != "predictor_leg"},
              oracles={k: completion["oracles"][k]
                       for k in ("primary", "bounce")}),
        entry("trace_near_any_clustered",
              f"{pallas}:436 (in_near=True, any_hit=True)", 8,
              anyhit_of(sched["K2n"]), "nee",
              pipelined_walk=anyhit_of(sched["K2n pipelined"]),
              oracles=completion["oracles"]["nee"]),
        entry("trace_near_pairs_clustered",
              f"{pallas}:436 (in_near=True, pairs=True)", 9,
              sched["K2n pairs"], "bounce",
              pipelined_walk=sched["K2n pipelined pairs"]),
        entry("trace_pipelined_closest_clustered",
              f"{pallas}:436 (_kernel_one_tile pipelined=True, :600-722; "
              "the streaming form :731-748)", 10, closest_of(sched["K2pl"]),
              "bounce", pipelined_path=paths["pipelined"]),
        entry("trace_pipelined_any_clustered",
              f"{pallas}:436 (pipelined=True, any_hit=True)", 11,
              anyhit_of(sched["K2pl"]), "nee"),
        entry("trace_pipelined_pairs_clustered",
              f"{pallas}:436 (pipelined=True, pairs=True)", 12,
              sched["K2pl pairs"], "bounce"),
        entry("trace_binned_pass",
              f"{pallas}:953 (_kernel_binned, called from trace_binned_pass "
              "at :1106)", 13, k4, "bounce", hooked_drain_entries=hooked,
              whole_legs=binned_legs,
              paths={k: paths[k] for k in ("binned", "binned_any_nee",
                                           "multipass", "binned_near")}),
        entry("trace_near_closest_clustered_two_level",
              f"{pallas}:1379 (_kernel_two_level, called at :1772) with the "
              "super order of :436's in_near=True (:469-490); the JAX "
              "dispatcher turns kernel_near off on two-level tables (:1717)",
              14, closest_of(near5), "bounce", routes=routes,
              config5_frame=paths["config5"]),
        entry("trace_near_any_clustered_two_level",
              f"{pallas}:1379 (any_hit=True) with the in-kernel super order",
              15, anyhit_of(near5), "nee",
              config5_nee_frame=paths["config5_nee"]),
        entry("trace_near_pairs_clustered_two_level",
              f"{pallas}:1379 (pairs=True) with the in-kernel super order",
              16, near_pairs5, "bounce",
              config5_exact_frame=paths["config5_exact"]),
        entry("top_keys",
              "webgpu_raytracing_tpu/ops/ray_sort.py:37 (nearest_cluster_key"
              "), :143 (nearest_cluster_key_fused), :183 "
              "(nearest_cluster_keys2): XLA code, no pallas_call", 17,
              {**keys, "config5 bounce": key5}, "bounce",
              paths={k: paths[k] for k in (
                  "sorted", "nee_sorted", "binned", "binned_any_nee",
                  "multipass", "binned_near", "sorted_near", "chained",
                  "sorted_near_nee", "chained_nee")}),
        dict(name="camera_rays", route="cuda",
             source="webgpu_raytracing_tpu_torch/csrc/raygen.cu",
             replaces="none: XLA code in webgpu_raytracing_tpu/ops/raygen.py",
             launches_per_call=1, mismatches=0, library_ms=None,
             launches_per_frame={
                 k: paths[k]["raygen_per_frame"] for k in ("config5",
                                                            "direct")},
             timed_leg="config5_slab", legs=raygen,
             **{k: raygen["config5_slab"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="shade", route="cuda",
             source="webgpu_raytracing_tpu_torch/csrc/shade.cu",
             replaces="none: XLA code in "
             "webgpu_raytracing_tpu/ops/integrator.py",
             launches_per_segment=2, mismatches=0, library_ms=None,
             launches_per_frame={
                 k: paths[k]["shade_per_frame"] for k in ("config5",
                                                           "direct")},
             timed_leg="config5_slab", legs=shade,
             **{k: shade["config5_slab"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="rederive_uv", route="cuda",
             source="webgpu_raytracing_tpu_torch/csrc/rederive.cu",
             replaces=f"none: XLA code in {pallas}:2047 (rederive_uv)",
             library_ms=None,
             launches_per_frame={
                 k: paths[k]["rederive_per_frame"] for k in ("config5",
                                                              "direct")},
             timed_leg="config5_slab bounce", legs=rederive,
             **{k: rederive["config5_slab"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="lights", route="cuda",
             source="webgpu_raytracing_tpu_torch/csrc/light.cu",
             replaces="none: XLA code in "
             "webgpu_raytracing_tpu/ops/integrator.py (direct_light)",
             launches_per_sample=2, mismatches=0, library_ms=None,
             launches_per_frame={
                 k: paths[k]["light_per_frame"] for k in (
                     "nee", "direct", "config5_nee", "config5")},
             timed_leg="config5_slab_nee", legs=light,
             **{k: light["config5_slab_nee"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by")}),
    ]}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
