"""How the validity margin of the exact-pairs kernels decides their faces.

    python3 tools/torch_pairs_margin.py [--margins -14 -16 -18 -20 -22] [--seed 0]

On the closest-hit legs that chip_smoke.py compares (frame 0's 1080p
primary and first-bounce rays of ``stress_scene(44_556)``, and the
primary and bounce rays of one 4K slab of the 1M-triangle config #5
scene, two-level tables), runs the pairs kernel (K2p or K3p) with each
margin 2^m of ``--margins`` (``ops/cluster_cuda.MARGIN`` is an argument of
the kernel), adjudicates its candidates with ``adjudicate_compact`` and
counts the rays whose face differs from the plain route's (K1 or K3,
exact f32 Möller–Trumbore), split into misses and other faces, with the
flag rate and the rays whose robust slot stayed empty while the first
slot was set. Prints one line per leg and margin, then one JSON line and
the card's name and power limit. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(tables, legs, label, margins):
    from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
    from webgpu_raytracing_tpu_torch.ops.adjudicate import adjudicate_compact

    default = cc.MARGIN
    rows = []
    try:
        for key in ("primary", "bounce"):
            rows += _measure_leg(cc, adjudicate_compact, tables, legs[key],
                                 label + key, margins)
    finally:
        cc.MARGIN = default
    return rows


def _measure_leg(cc, adjudicate_compact, tables, leg, name, margins):
    fid = tables.clusters.face_id
    plain = cc.prepare_tiles(tables=tables, **leg)
    ref = cc.code_to_face(cc.trace_closest_args(plain)[0](**plain)[1], fid)
    del plain
    args = cc.prepare_tiles(tables=tables, pairs=True, **leg)
    live = args["t_max"] > 0
    rows = []
    for m in margins:
        cc.MARGIN = 2.0**m  # read by the kernel's launcher at each call
        t1, c1, c2, c3, amb = cc.trace_pairs_args(args)[0](**args)
        faces = tuple(cc.code_to_face(c, fid) for c in (c1, c2, c3))
        hit = adjudicate_compact(leg["o"], leg["d"], args["t_max"], t1,
                                 faces, amb, tables)
        bad = hit.face != ref
        row = dict(
            leg=name, margin_log2=m, rays=int(ref.numel()),
            flag_rate=float(amb[live].float().mean()),
            faces_differ=int(bad.sum()),
            adjudicated_miss=int((bad & (hit.face < 0)).sum()),
            robust_empty=int(((c3 < 0) & (c1 >= 0)).sum()),
        )
        print(f"{name}, margin 2^{m}: {row['faces_differ']} of "
              f"{row['rays']} faces differ from the plain route "
              f"({row['adjudicated_miss']} adjudicated misses), flag rate "
              f"{row['flag_rate']:.6f}, robust slot empty on "
              f"{row['robust_empty']}", flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--margins", type=int, nargs="+",
                    default=[-14, -16, -18, -20, -22])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_pairs_margin: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from webgpu_raytracing_tpu_torch.config import RenderSettings
    from webgpu_raytracing_tpu_torch.models.stress import stress_scene

    dev = torch.device("cuda")
    tables = stress_scene(cs.N_TRIANGLES).tables(dev)
    legs = cs.frame0_legs(torch, tables, RenderSettings(**cs.SLICE), a.seed)
    rows = measure(tables, legs, "slice ", a.margins)
    del tables, legs
    st = RenderSettings(**cs.CONFIG5)
    tables = stress_scene(cs.CONFIG5_TRIANGLES).tables(dev)
    n = st.render_height // st.frame_slabs
    legs = cs.frame0_legs(torch, tables, st, a.seed,
                          row0=cs.CONFIG5_SLAB * n, rows=n)
    rows += measure(tables, legs, "config #5 slab ", a.margins)
    print(json.dumps({"margins": rows}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
