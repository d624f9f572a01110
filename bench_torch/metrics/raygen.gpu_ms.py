"""Device busy time of the kernels launched inside the port's
``renderer.camera_rays`` (ops/raygen.py), ms per traced frame."""


def read(ctx):
    us = ctx["range_us"].get("bench.raygen")
    return None if us is None else us / 1e3 / ctx["frames"]
