"""The in-kernel order against the outside order, leg by leg, in a minute.

    python3 tools/torch_near_legs.py [--config5] [--seed 0] [--nvcc-flag F]

For frame 0's primary, first bounce and NEE shadow legs of the 1080p slice
(``stress_scene(44_556)``, 2,073,600 rays) and, with ``--config5``, of one 4K
slab of BASELINE config #5 (``stress_scene(1_000_000)``, 1,036,800 rays),
and for each search (closest-hit, any-hit, pairs): runs the kernel that
walks the order sorted outside (K1 / K2p; K3 / K3p) and the one that orders
its tile itself (K2n; K3 / K3p with their own super order), checks that
every output is equal bit for bit, and prints both times (CUDA events, the
least of three rounds of five launches) with the card's name and power
limit. Exits with 1 on the first leg that differs.

The quick check after an edit of ``csrc/cluster_trace.cu``: it builds the
library as the package does and needs no twin, so it takes about 25 s for
the slice and 70 s more with ``--config5`` (the scene's numpy build).
``--nvcc-flag`` (repeatable) is added to the build's flags and so to the
library's name: two variants of a constant behind an ``#ifndef`` can be
timed in one call on the card. Fails without a CUDA device. Imports
``chip_smoke`` for the legs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nvcc-flag", action="append", default=[])
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

    _build.NVCC_FLAGS.extend(a.nvcc_flag)
    t0 = time.perf_counter()
    card = cs.smi()
    dev = torch.device("cuda")
    searches = (("closest", cc.trace_closest_args),
                ("any", cc.trace_any_args), ("pairs", cc.trace_pairs_args))

    def compare(label, tables, st, legs):
        for key in ("primary", "bounce", "nee"):
            for kind, select in searches:
                res = {}
                for near in ("outside", "kernel"):
                    args = cc.prepare_tiles(
                        tables=tables, tile=st.trace_tile, near=near,
                        pairs=kind == "pairs", **legs[key])
                    wrapper = select(args)[0]
                    out = wrapper(**args)
                    out = out if isinstance(out, tuple) else (out,)
                    ms = min(cs._time_cuda(torch, lambda: wrapper(**args), 5)
                             for _ in range(3))
                    res[near] = (out, ms, wrapper.__name__)
                    del args
                equal = all(
                    torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for x, y in zip(res["outside"][0], res["kernel"][0]))
                print(f"{label} {key} {kind}: equal {equal}; "
                      f"{res['outside'][2]} {res['outside'][1]:.3f} ms, "
                      f"{res['kernel'][2]} {res['kernel'][1]:.3f} ms "
                      f"({card})", flush=True)
                if not equal:
                    return False
        return True

    st = RenderSettings(**cs.SLICE)
    tables = stress_scene(cs.N_TRIANGLES).tables(dev)
    if not compare("slice", tables, st,
                   cs.frame0_legs(torch, tables, st, a.seed)):
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
          f"{a.nvcc_flag} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
