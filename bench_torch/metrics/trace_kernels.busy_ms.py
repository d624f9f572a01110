"""Device busy time of the hand-written trace kernels
(``csrc/cluster_trace.cu``, every launch goes through
``ops/cluster_cuda._run``), ms per traced frame."""


def read(ctx):
    us = ctx["range_us"].get("bench.trace_kernels")
    return None if us is None else us / 1e3 / ctx["frames"]
