"""Where a leg of the two-level kernel (K3) goes, inside the kernel.

    python3 tools/torch_k3_split.py [--seed 0]

Builds ``csrc/cluster_trace.cu`` with ``-DWRT_K3_CLOCKS`` (a library of its
own under build/kernels/: the flag is part of the library's name), which
makes thread 0 of every K3 block add the ``clock64()`` ticks between the
walk's block barriers to per-phase sums. Then runs frame 0's primary, first
bounce and NEE shadow legs of one 4K slab of BASELINE config #5
(``stress_scene(1_000_000)``, rows 1080-1349 of 3840x2160, 1,036,800 rays)
through each search of K3 that the frames run on them (closest-hit on the
primary and bounce legs, any-hit on the NEE leg, pairs (K3p) on the
primary and bounce legs), with the super order sorted outside the kernel
and with the order made inside it, and prints for each leg its time (CUDA
events, the clocks included), the supers a tile visits, and the share of
the block ticks in each phase:

* ``order``: the kernel's first half (the tile's entry distances into every
  super box and the sort); 0 with the order from outside;
* ``vote``: the block-wide vote for the next super, which waits for the
  block's slowest walker;
* ``cull``: the child boxes' slab pass; ``rank``: the sort of the children;
* ``walk``: thread 0's walk of the children, its warp's slot scans shared
  with it (slot tests).

Prints one JSON line with the numbers and the card's name and power limit.
Fails without a CUDA device. Imports ``chip_smoke`` for the legs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("order", "vote", "cull", "rank", "walk")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_k3_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene
    from webgpu_raytracing_tpu_torch.ops import _build
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc

    _build.NVCC_FLAGS.append("-DWRT_K3_CLOCKS")
    lib = _build.load()
    lib.wrt_k3_clocks.restype = ctypes.c_int
    lib.wrt_k3_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def clocks():
        out = (ctypes.c_ulonglong * 6)()
        err = lib.wrt_k3_clocks(out, 1)
        if err:
            raise RuntimeError(lib.wrt_error_string(err).decode())
        return list(out)

    card = cs.smi()
    dev = torch.device("cuda")
    tables = stress_scene(cs.CONFIG5_TRIANGLES).tables(dev)
    st = RenderSettings(**cs.CONFIG5)
    rows = st.render_height // st.frame_slabs
    legs = cs.frame0_legs(torch, tables, st, a.seed,
                          row0=cs.CONFIG5_SLAB * rows, rows=rows)
    result = {"card": card, "legs": {}}
    searches = (("primary", "closest", cc.trace_closest_args),
                ("bounce", "closest", cc.trace_closest_args),
                ("nee", "any", cc.trace_any_args),
                ("primary", "pairs", cc.trace_pairs_args),
                ("bounce", "pairs", cc.trace_pairs_args))
    for key, kind, select in searches:
        for near in ("outside", "kernel"):
            args = cc.prepare_tiles(tables=tables, tile=st.trace_tile,
                                    near=near, pairs=kind == "pairs",
                                    **legs[key])
            wrapper = select(args)[0]
            wrapper(**args)
            clocks()  # zero the sums after the warm-up
            ms = cs._time_cuda(torch, lambda: wrapper(**args), 3, warm=False)
            ticks = clocks()
            supers, total = ticks[5], sum(ticks[:5])
            n_tiles = args["t_max"].shape[0] // st.trace_tile
            shares = {p: ticks[i] / total for i, p in enumerate(PHASES)}
            name = f"{key} {kind}, order made {near}"
            result["legs"][name] = dict(
                ms=ms, kernel=wrapper.__name__,
                supers_per_tile=supers / 3 / n_tiles, shares=shares,
                block_ticks_per_tile=total / 3 / n_tiles)
            print(f"{name} ({wrapper.__name__}): {ms:.3f} ms with the clocks "
                  f"on, {supers / 3 / n_tiles:.2f} supers visited per tile, "
                  f"{total / 3 / n_tiles:.0f} block ticks per tile: "
                  + ", ".join(f"{p} {shares[p]:.3f}" for p in PHASES)
                  + f" ({card})", flush=True)
            del args
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
