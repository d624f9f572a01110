"""Device busy time of the kernels launched inside the port's
``rederive_uv`` (the exact t, u, v of each hit face), ms per traced
frame."""


def read(ctx):
    us = ctx["range_us"].get("bench.rederive")
    return None if us is None else us / 1e3 / ctx["frames"]
