"""The in-kernel order against the outside order, leg by leg, in a minute.

    python3 tools/torch_near_legs.py [--config5] [--staged] [--seed 0]
                                     [--nvcc-flag F] [--variant=FLAGS]
                                     [--search S] [--legs L] [--keys]

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

``--keys`` times the ray sort's legs instead: the coherence key of the
slice's bounce leg (top 3), shadow legs (top 2) and a multipass leg (the
bounce rays K1 capped at 4 leaves unfinished, top 2 with ``t_start``),
through ``ray_sort.nearest_cluster_keys2`` / ``nearest_cluster_key``, and
K4 on the bounce and shadow legs sorted by nearest cluster, as
``binned_trace`` makes them; with ``--config5`` also the key of the slab's
bounce leg over the supers; then 1080p frames (one warm-up, three timed
frames, ms each and peak memory): default, sorted, chained, NEE default,
sorted and chained, ``binned_sort`` with the order in the kernel and
outside, ``multipass_cap=4``. It uses only functions an earlier checkout
has too, so run from the root of a ``git archive`` of the parent it times
the parent's key (plain torch) and K4; each output's sha256 is printed, so
that the two checkouts' outputs can be compared. With ``--variant`` the
legs of every build are held to the plain build's outputs.
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
    ap.add_argument("--keys", action="store_true")
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

    def digest(out):
        import hashlib

        h = hashlib.sha256()
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            h.update(x.contiguous().view(torch.int32).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def sort_legs(label, tables, st, legs):
        """--keys: the keys and K4 legs of ``legs`` (above), each checked
        against the plain build and timed in turns (:func:`timed`)."""
        from webgpu_raytracing_tpu_torch.ops import ray_sort as rs

        boxes = tables.clusters.sort_box
        c = boxes.shape[0]
        runs = []
        for key, n in (("bounce", 3), ("nee", 2), ("env", 2)):
            if key not in legs:
                continue
            o, d, tm, ex = cs._fold(torch, legs[key])
            runs.append((f"{key} top-{n} key", lambda o=o, d=d, tm=tm, n=n:
                         rs.nearest_cluster_keys2(o, d, tm, boxes, n=n)))
            if cc.is_two_level(tables.clusters):  # K4: single-level only
                continue
            k1 = rs.nearest_cluster_keys2(o, d, tm, boxes)[0]
            cid_s, perm = rs.sort_keys(rs._cid_of(k1, c))
            o_s, d_s, tm_s, ex_s = rs.permute_rows(perm, (o, d, tm, ex))
            sched, _ = rs._block_schedules(cid_s, o.shape[0] // st.trace_tile,
                                           st.trace_tile, c)
            args = cc.binned_args(o_s, d_s, tm_s, tables, sched, ex_s,
                                  tile=st.trace_tile)
            runs.append((f"{key} K4", lambda args=args:
                         cc.trace_binned_tiles(**args)))
        if "bounce" in legs and not cc.is_two_level(tables.clusters):
            o, d, tm, ex = cs._fold(torch, legs["bounce"])
            t1, _, stop = cc.trace_closest_tiles(**cc.prepare_tiles(
                o, d, tm, tables, None, ex, st.trace_tile, cap=4,
                return_stop=True))
            tm2 = torch.where(t1.view(torch.int32) > stop, t1,
                              torch.zeros_like(t1))
            ts = stop.view(torch.float32)
            runs.append(("multipass top-2 key with t_start",
                         lambda o=o, d=d, tm2=tm2, ts=ts:
                         rs.nearest_cluster_key(o, d, tm2, boxes,
                                                t_start=ts)))
        for name, fn in runs:
            use(base)
            ref = fn()
            want = digest(ref)
            print(f"{label} {name}: sha256 {want}", flush=True)
            def check(out, want=want):
                return digest(out) == want

            if not timed(f"{label} {name}", [(name, fn, {}, check)]):
                return False
        return True

    def frames(scene, st):
        """--keys: 1080p frames of the ray sort's settings, ms each."""
        from webgpu_raytracing_tpu_torch.renderer import Renderer

        srt = st.replace(sort_bounce_rays=True)
        nee = st.replace(next_event_estimation=True)
        cases = {
            "default": st, "sorted": srt,
            "chained": srt.replace(chained_sort=True), "NEE": nee,
            "NEE sorted": nee.replace(sort_bounce_rays=True),
            "NEE chained": nee.replace(sort_bounce_rays=True,
                                       chained_sort=True),
            "binned": srt.replace(binned_sort=True),
            "binned, order outside": srt.replace(binned_sort=True,
                                                 kernel_near=False),
            "multipass_cap=4, order outside": srt.replace(
                multipass_cap=4, kernel_near=False),
        }
        use(base)
        for name, fst in cases.items():
            r = Renderer(scene, fst, base_seed=a.seed, device="cuda")
            r.step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(3):
                t1 = time.perf_counter()
                r.step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"frame {name}: " + " / ".join(f"{x:.1f}" for x in ms)
                  + f" ms, peak {peak:.3f} GiB, image sha256 "
                  f"{digest(r.buffers.image)} ({card})", flush=True)
            del r

    st = RenderSettings(**cs.SLICE)
    scene = stress_scene(cs.N_TRIANGLES)
    tables = scene.tables(dev)
    sky = build_env_distribution(
        cs.sky_equirect(torch, *cs.SKY_SHAPE, "cuda").cpu().numpy(), "cuda")
    legs = cs.frame0_legs(torch, tables, st, a.seed, sky=sky)
    if a.keys:
        if not sort_legs("slice", tables, st, legs):
            return 1
        del legs
        if a.config5:
            st5 = RenderSettings(**cs.CONFIG5)
            tables5 = stress_scene(cs.CONFIG5_TRIANGLES).tables(dev)
            rows = st5.render_height // st5.frame_slabs
            legs5 = cs.frame0_legs(torch, tables5, st5, a.seed,
                                   row0=cs.CONFIG5_SLAB * rows, rows=rows)
            if not sort_legs("config #5 slab", tables5, st5,
                             {"bounce": legs5["bounce"]}):
                return 1
            del legs5, tables5
        frames(scene, st)
        print(f"torch_near_legs --keys: {time.perf_counter() - t0:.0f} s, "
              f"variants {a.variant} ({card})", flush=True)
        return 0
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
