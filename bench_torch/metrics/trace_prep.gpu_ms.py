"""Device busy time of the kernels launched inside the port's
``ops/cluster_cuda.prepare_tiles`` (ray padding, and with the order made
outside the kernels the tile entry distances and their sort), ms per
traced frame."""


def read(ctx):
    us = ctx["range_us"].get("bench.trace_prep")
    return None if us is None else us / 1e3 / ctx["frames"]
