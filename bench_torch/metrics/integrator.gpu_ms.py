"""Device busy time of the frame's kernels outside raygen, trace prep,
the trace kernels and rederive: shading and sampling
(``ops/integrator.py``, ``env_sample``, ``envmap``, ``rng``) and the
accumulation, ms per traced frame."""

LAYERS = ("bench.raygen", "bench.trace_prep", "bench.trace_kernels",
          "bench.rederive")


def read(ctx):
    frame = ctx["range_us"].get("bench.frame")
    if frame is None:
        return None
    rest = frame - sum(ctx["range_us"].get(k, 0.0) for k in LAYERS)
    return rest / 1e3 / ctx["frames"]
