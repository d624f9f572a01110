"""Strict f32 arithmetic for decision-critical paths.

Counterpart of ``webgpu_raytracing_tpu/ops/strictf.py``. There, every
product is forced through ``x*y + zero`` with an opaque zero so that XLA
cannot contract it into an FMA. Eager PyTorch launches one kernel per
operator and rounds every result to f32, so a plain ``x * y`` already is
``fl(x*y)``: no barrier is needed. Fused operators (``addcmul``,
``addcdiv``, ``baddbmm``, matmul for dot products) and ``torch.compile``
must never be used in these chains.

The port follows the JAX package's op order as written, rounded as eager
JAX rounds it; its tests check that bit for bit. Under ``jax.jit`` XLA
also contracts unguarded mul-adds into FMAs and turns divisions by
constants into reciprocal products. That changes only the last bit almost
everywhere, and is followed in one place only, where a last bit is
amplified 10^5-fold: the sun-disc ramp of ``envmap.procedural_sky``
(:func:`fma` below reproduces the contraction there).
"""

from __future__ import annotations

import torch


def smul(x, y):
    """Strict ``fl(x*y)``."""
    return x * y


def sdot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Strict 3-component dot with left-associated f32 adds — the WGSL
    ``dot(vec3f, vec3f)`` evaluation order: ``(p0 + p1) + p2``."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def scross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component-wise cross product, every product rounded before the
    subtraction (scalar evaluation order)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def fma(a, b, c) -> torch.Tensor:
    """``fl(a*b + c)`` with ONE f32 rounding, as XLA's contracted FMA
    computes it. The product of two f32 values is exact in f64, so the
    f64 sum is rounded twice (to 53 bits, then to 24); that can differ
    from a true FMA only when the f64 sum lands exactly on an f32
    rounding midpoint. Python floats are taken as f32 (JAX weak typing).
    """

    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(torch.tensor(x, dtype=torch.float32))

    return (f64(a) * f64(b) + f64(c)).float()
