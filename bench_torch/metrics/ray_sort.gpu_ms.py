"""Device busy time of the ray sort, ms per traced frame: what the port's
``integrator.trace_closest`` launches outside trace prep, the trace
kernels and rederive. On sorted legs that is the key kernel (which the
port launches outside ``cluster_cuda._run``), the sort, the gathers, the
count reads, the tail of known misses and the unsort, and, on every
leg, the leg's own glue (folding ``active`` into t_max).

It holds only in a cell whose trace legs are all closest-hit legs: the
ranges subtracted also hold the shadow legs' prep and kernels, which lie
outside ``bench.closest``. Hence its one cell."""

LESS = ("bench.trace_prep", "bench.trace_kernels", "bench.rederive")


def read(ctx):
    closest = ctx["range_us"].get("bench.closest")
    if closest is None:
        return None
    less = {k: ctx["range_us"].get(k, 0.0) for k in LESS}
    ctx["notes"].append(
        f"ray_sort.gpu_ms: bench.closest {closest / 1e3:.6f} ms less "
        + ", ".join(f"{k} {v / 1e3:.6f} ms" for k, v in less.items())
        + f" over {ctx['frames']} frames")
    return (closest - sum(less.values())) / 1e3 / ctx["frames"]
