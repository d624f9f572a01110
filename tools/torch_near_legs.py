"""The in-kernel order against the outside order, leg by leg, in a minute.

    python3 tools/torch_near_legs.py [--config5] [--staged] [--seed 0]
                                     [--nvcc-flag F] [--variant=FLAGS]
                                     [--search S] [--legs L]

For frame 0's primary, first bounce, NEE shadow and env-NEE shadow legs of
the 1080p slice (``stress_scene(44_556)``, 2,073,600 rays; the env leg on
chip_smoke's equirect of the procedural sky) and, with ``--config5``, the
first three of one 4K slab of BASELINE config #5
(``stress_scene(1_000_000)``, 1,036,800 rays), and for each search
(closest-hit, any-hit, pairs): runs the kernel that walks the order sorted
outside (K1 / K2p; K3 / K3p) and the one that orders its tile itself (K2n;
K3 / K3p with their own super order), checks that every output is equal
bit for bit, and prints both times (CUDA events, the least of three rounds
of five launches, taken twice) with the card's name and power limit.
``--staged`` adds, on the slice, the kernels that walk the order in staged
rounds: K5 in rounds of 4 (closest-hit), K2pl and K2n's pipelined walk,
each held to the outside order's outputs bit for bit and timed beside it;
and K1c's drain on the bounce leg: K1 capped at 4 clusters with its stop,
then K1 and K2n on its survivors from the stop and the carried code,
which must complete K1's outputs bit for bit.
Exits with 1 on the first leg that differs.

The quick check after an edit of ``csrc/cluster_trace.cu``: it builds the
library as the package does and needs no twin, so it takes about 30 s for
the slice and 70 s more with ``--config5`` (the scene's numpy build).
``--nvcc-flag`` (repeatable) is added to the build's flags and so to the
library's name. ``--variant`` (repeatable) adds a build of its own with
those flags as well (all builds run at once): every entry of every variant
is checked against the outside order of the plain build and timed in turns
(first to last, then last to first, two times each), so that variants of a
constant behind an ``#ifndef`` are compared in one call on one card. The
script runs on a checkout of an earlier commit too (it needs only
``prepare_tiles`` and the wrappers): run from its root, it times that
commit's kernels.
``--search`` and ``--legs`` (comma-separated) keep only some searches and
legs. Fails without a CUDA device. Imports ``chip_smoke`` for the legs.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--staged", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nvcc-flag", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--search", default="closest,any,pairs")
    ap.add_argument("--legs", default="primary,bounce,nee,env")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_near_legs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops import _build
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops.env_sample import (
        build_env_distribution,
    )

    _build.NVCC_FLAGS.extend(a.nvcc_flag)
    base = list(_build.NVCC_FLAGS)
    variants = [("", base)] + [(v, base + v.split()) for v in a.variant]
    t0 = time.perf_counter()
    if a.variant:
        builds = [threading.Thread(target=_build.build, args=(f,))
                  for _, f in variants]
        for b in builds:
            b.start()
        for b in builds:
            b.join()
        for _, f in variants:  # a failed build raises here
            _build.build(f)
        print(f"torch_near_legs: {len(variants)} builds in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def use(flags):
        if a.variant:  # else the one library loads at the first launch
            _build.NVCC_FLAGS[:] = flags
            _build._lib = None
            _build.load()

    card = cs.smi()
    dev = torch.device("cuda")
    searches = [(k, s) for k, s in (("closest", cc.trace_closest_args),
                                    ("any", cc.trace_any_args),
                                    ("pairs", cc.trace_pairs_args))
                if k in a.search.split(",")]

    # the entries a leg goes through: the outside order (the reference),
    # the order in the kernel and, --staged on single-level tables, the
    # staged walks; (name, prepare_tiles keywords, searches)
    entries = [("", dict(near="outside"), None),
               ("", dict(near="kernel"), None)]
    staged = [(" rounds of 4", dict(sched_rounds=4), ("closest",)),
              ("", dict(pipelined=True), None),
              (" pipelined", dict(near="kernel", pipelined=True), None)]

    def same(out, ref):
        out = out if isinstance(out, tuple) else (out,)
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(ref, out))

    def timed(line, runs):
        """``runs``: (name, wrapper, args, check), where ``check(outputs)``
        says the outputs are right. Every run of every build is checked,
        then timed in turns (builds first to last, then last to first)."""
        times = {(e, v): [] for e, _, _, _ in runs for v, _ in variants}
        for order in (variants, variants[::-1]):
            for name, flags in order:
                use(flags)
                for entry, wrapper, args, check in runs:
                    if not check(wrapper(**args)):
                        print(f"{line}: {entry} [{name}] differs ({card})",
                              flush=True)
                        return False
                    times[entry, name] += [
                        min(cs._time_cuda(torch, lambda: wrapper(**args), 5)
                            for _ in range(3))]
        print(f"{line}: equal True; " + ", ".join(
            f"{e} [{v}] " + " / ".join(f"{t:.3f}" for t in ts) + " ms"
            for (e, v), ts in times.items()) + f" ({card})", flush=True)
        return True

    def compare(label, tables, st, legs):
        todo = entries + (staged if a.staged and not cc.is_two_level(
            tables.clusters) else [])
        for key in a.legs.split(","):
            if key not in legs:
                continue
            for kind, select in searches:
                runs = []
                for suffix, kw, only in todo:
                    if only and kind not in only:
                        continue
                    args = cc.prepare_tiles(
                        tables=tables, tile=st.trace_tile,
                        pairs=kind == "pairs", **legs[key], **kw)
                    wrapper = select(args)[0]
                    runs.append((wrapper.__name__ + suffix, wrapper, args))
                use(base)
                ref = runs[0][1](**runs[0][2])
                ref = ref if isinstance(ref, tuple) else (ref,)
                if not timed(f"{label} {key} {kind}", [
                        (e, w, x, lambda out: same(out, ref))
                        for e, w, x in runs]):
                    return False
                del runs, ref
        return True

    def drains(tables, st, leg):
        """K1c on the bounce leg: K1 capped at 4 entries with its stop
        (only its survivors may differ from K1's uncapped outputs), then
        K1 and K2n on the survivors from the stop and the carried code,
        which must complete K1's outputs bit for bit."""
        tile = st.trace_tile
        use(base)
        full = cc.trace_closest_tiles(**cc.prepare_tiles(
            tables=tables, tile=tile, **leg))
        capped = cc.prepare_tiles(tables=tables, tile=tile, cap=4,
                                  return_stop=True, **leg)
        t1, c1, stop = cc.trace_closest_tiles(**capped)
        surv = t1.view(torch.int32) > stop
        print(f"slice bounce: {int(surv.sum())} of {leg['o'].shape[0]} rays "
              f"survive K1 capped at 4 ({card})", flush=True)
        tm2 = torch.where(surv, t1, torch.zeros_like(t1))
        runs = [("trace_closest_tiles capped at 4", cc.trace_closest_tiles,
                 capped, lambda out: same(out, (t1, c1, stop)) and not bool(
                     ((c1 != full[1]) & ~surv).any()))]
        for kw in ({}, dict(near="kernel")):
            args = cc.prepare_tiles(
                leg["o"], leg["d"], tm2, tables, None, leg["excl_code"],
                tile, t_start=stop.view(torch.float32), start_code=c1, **kw)
            wrapper = cc.trace_closest_args(args)[0]
            runs.append((wrapper.__name__ + " on the survivors", wrapper,
                         args, lambda out: same(
                             (torch.where(surv, out[0], t1),
                              torch.where(surv, out[1], c1)), full)))
        return timed("slice bounce K1c", runs)

    st = RenderSettings(**cs.SLICE)
    tables = stress_scene(cs.N_TRIANGLES).tables(dev)
    sky = build_env_distribution(
        cs.sky_equirect(torch, *cs.SKY_SHAPE, "cuda").cpu().numpy(), "cuda")
    legs = cs.frame0_legs(torch, tables, st, a.seed, sky=sky)
    if not compare("slice", tables, st, legs):
        return 1
    if a.staged and not drains(tables, st, legs["bounce"]):
        return 1
    del legs
    if a.config5:
        st = RenderSettings(**cs.CONFIG5)
        tables = stress_scene(cs.CONFIG5_TRIANGLES).tables(dev)
        rows = st.render_height // st.frame_slabs
        legs = cs.frame0_legs(torch, tables, st, a.seed,
                              row0=cs.CONFIG5_SLAB * rows, rows=rows)
        if not compare("config #5 slab", tables, st, legs):
            return 1
    print(f"torch_near_legs: {time.perf_counter() - t0:.0f} s, flags "
          f"{a.nvcc_flag}, variants {a.variant}, staged {a.staged} "
          f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
