"""Readings from which the limits of ``cells/<cell>.json`` are set.

    python3 bench_torch/calibrate.py --workload <cell> [--seeds 12]
        [--controls 3] [--first-seed N] [--seconds S]

For each of ``--seeds`` seeds, one run of the cell as ``run.py`` makes
it (a window of ``--seconds``, by default the manifest's ``run_seconds``;
the compared frame drawn from the seed) gives the compared
numbers of a sound run: the lower readings are their largest. For each
of ``--controls`` seeds, the control: the reference computed in
bfloat16, the nearest precision below the float32 that the renderer
states, put in the program's place for the same frame;
its smallest numbers are the upper readings. One JSON line per reading, then a
summary line. Needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402


def control(spec, seed, device, size=None):
    """The numbers of the bfloat16 reference against the float32 one on
    the frame after the warm-up frames of ``seed``, from that frame's
    view."""
    import torch

    import compare
    import reference as ref
    from motion import CameraPath

    st = run.settings_of(spec)
    if size is not None:
        st["width"], st["height"] = size
    desc = run.generate_scene(spec, seed)
    img = run.generate_env(spec, seed, torch.device(device))
    view = CameraPath(spec["config"]).view(run.WARMUP_FRAMES)
    fseed, jitter = run.frame_inputs(seed, run.WARMUP_FRAMES + 1,
                                     st["jitter_strength"])[-1]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        scene = ref.Scene(desc, device, dt)
        env = ref.Environment(st["environment"], img,
                              st["env_importance_sampling"], dt)
        out[dt] = ref.render_frame(scene, env, st, view, fseed, jitter,
                                   dtype=dt)
        del scene, env
    tally = compare.Tally()
    (c32, r32), (c16, r16) = out[torch.float32], out[torch.bfloat16]
    tally.add(c16, c32, r16, r32)
    return tally.numbers()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=None)
    a = ap.parse_args()
    spec = run.cell_spec(a.workload)
    seconds = a.seconds or run.read_json(
        os.path.join(run.ROOT, "BENCHMARK.json"))["run_seconds"]
    lows, highs = [], []
    for k in range(a.seeds):
        seed = a.first_seed + 7919 * k
        t = time.time()
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=seconds, trace=0)
        res = run.run(args, "cuda", spec, out=lambda s: None)
        nums = {k2: v["value"] for k2, v in res["compared"].items()}
        lows.append(nums)
        print(json.dumps(dict(kind="program", workload=a.workload,
                              seed=seed, numbers=nums,
                              seconds=time.time() - t)), flush=True)
    for k in range(a.controls):
        seed = a.first_seed + 7919 * (a.seeds + k)
        t = time.time()
        nums = control(spec, seed, "cuda")
        highs.append(nums)
        print(json.dumps(dict(kind="control", workload=a.workload,
                              seed=seed, numbers=nums,
                              seconds=time.time() - t)), flush=True)
    summary = dict(kind="summary", workload=a.workload)
    for name in ("bad_px_pct", "rays_err_pct", "accum_px"):
        summary[name] = dict(
            lower=max((n[name] for n in lows), default=None),
            upper=min((n[name] for n in highs if name in n), default=None))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
