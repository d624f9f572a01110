"""The in-kernel order against the outside order, leg by leg, in a minute.

    python3 tools/torch_near_legs.py [--config5] [--seed 0] [--nvcc-flag F]
                                     [--variant=FLAGS] [--search S]
                                     [--legs L]

For frame 0's primary, first bounce, NEE shadow and env-NEE shadow legs of
the 1080p slice (``stress_scene(44_556)``, 2,073,600 rays; the env leg on
chip_smoke's equirect of the procedural sky) and, with ``--config5``, the
first three of one 4K slab of BASELINE config #5
(``stress_scene(1_000_000)``, 1,036,800 rays), and for each search
(closest-hit, any-hit, pairs): runs the kernel that walks the order sorted
outside (K1 / K2p; K3 / K3p) and the one that orders its tile itself (K2n;
K3 / K3p with their own super order), checks that every output is equal
bit for bit, and prints both times (CUDA events, the least of three rounds
of five launches) with the card's name and power limit. Exits with 1 on
the first leg that differs.

The quick check after an edit of ``csrc/cluster_trace.cu``: it builds the
library as the package does and needs no twin, so it takes about 30 s for
the slice and 70 s more with ``--config5`` (the scene's numpy build).
``--nvcc-flag`` (repeatable) is added to the build's flags and so to the
library's name. ``--variant`` (repeatable) adds a build of its own with
those flags as well (all builds run at once): the in-kernel entries of
every variant are checked against the outside order and timed in turns
(first to last, then last to first, two times each), so that variants of a
constant behind an ``#ifndef`` are compared in one call on one card.
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

    def compare(label, tables, st, legs):
        for key in a.legs.split(","):
            if key not in legs:
                continue
            for kind, select in searches:
                args = {}
                for near in ("outside", "kernel"):
                    args[near] = cc.prepare_tiles(
                        tables=tables, tile=st.trace_tile, near=near,
                        pairs=kind == "pairs", **legs[key])
                wrapper = {n: select(x)[0] for n, x in args.items()}
                use(base)
                ref = wrapper["outside"](**args["outside"])
                ref = ref if isinstance(ref, tuple) else (ref,)
                ms_out = min(
                    cs._time_cuda(torch, lambda: wrapper["outside"](
                        **args["outside"]), 5) for _ in range(3))
                times = {name: [] for name, _ in variants}
                for order in (variants, variants[::-1]):
                    for name, flags in order:
                        use(flags)
                        out = wrapper["kernel"](**args["kernel"])
                        out = out if isinstance(out, tuple) else (out,)
                        if not all(torch.equal(x.view(torch.int32),
                                               y.view(torch.int32))
                                   for x, y in zip(ref, out)):
                            print(f"{label} {key} {kind}: "
                                  f"{wrapper['kernel'].__name__} [{name}] "
                                  f"differs from the outside order "
                                  f"({card})", flush=True)
                            return False
                        times[name] += [
                            min(cs._time_cuda(torch, lambda: wrapper[
                                "kernel"](**args["kernel"]), 5)
                                for _ in range(3))]
                print(f"{label} {key} {kind}: equal True; "
                      f"{wrapper['outside'].__name__} {ms_out:.3f} ms, "
                      f"{wrapper['kernel'].__name__} "
                      + ", ".join(f"[{n}] " + " / ".join(
                          f"{t:.3f}" for t in ts) + " ms"
                          for n, ts in times.items())
                      + f" ({card})", flush=True)
                del args, ref
        return True

    st = RenderSettings(**cs.SLICE)
    tables = stress_scene(cs.N_TRIANGLES).tables(dev)
    sky = build_env_distribution(
        cs.sky_equirect(torch, *cs.SKY_SHAPE, "cuda").cpu().numpy(), "cuda")
    if not compare("slice", tables, st,
                   cs.frame0_legs(torch, tables, st, a.seed, sky=sky)):
        return 1
    if a.config5:
        st = RenderSettings(**cs.CONFIG5)
        tables = stress_scene(cs.CONFIG5_TRIANGLES).tables(dev)
        rows = st.render_height // st.frame_slabs
        legs = cs.frame0_legs(torch, tables, st, a.seed,
                              row0=cs.CONFIG5_SLAB * rows, rows=rows)
        if not compare("config #5 slab", tables, st, legs):
            return 1
    print(f"torch_near_legs: {time.perf_counter() - t0:.0f} s, flags "
          f"{a.nvcc_flag}, variants {a.variant} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
