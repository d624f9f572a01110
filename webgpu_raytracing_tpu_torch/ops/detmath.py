"""Correctly rounded f32 helpers (counterpart of
``webgpu_raytracing_tpu/ops/detmath.py``).

The JAX package computes division, square root and sin/cos/tan with
exact-residual corrections made of plain f32 multiplies and adds, so that
XLA:CPU and XLA:TPU land on the same bits. The same operation sequence in
eager PyTorch lands on the same bits again (every op is one IEEE
rounding), and ``/`` and ``sqrt`` are correctly rounded on the CPU and,
without fast math, on the GPU. ``optimization_barrier`` has no
counterpart: eager PyTorch does no algebraic simplification.
"""

from __future__ import annotations

import torch

from .strictf import sdot3

_SPLIT = 4097.0


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float() if x.dtype != torch.float32 else x
    return torch.tensor(x, dtype=torch.float32)


def _two_prod(x, y):
    """Exact f32 product: x*y == p + err (Dekker two-product via Veltkamp
    splitting). Every partial product is exact, so FMA or not makes no
    difference here."""
    p = x * y
    cx = _SPLIT * x
    xh = cx - (cx - x)
    xl = x - xh
    cy = _SPLIT * y
    yh = cy - (cy - y)
    yl = y - yh
    err = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, err


def det_div(num, den) -> torch.Tensor:
    """num / den, correctly rounded (one exact-residual correction on top
    of the platform quotient; a bitwise no-op where ``/`` is already
    correctly rounded)."""
    num = _f32(num)
    den = _f32(den)
    q = num / den
    p, err = _two_prod(q, den)
    r = (num - p) - err
    res = q + r / den
    return torch.where(torch.isfinite(res), res, q)


def det_sqrt(x) -> torch.Tensor:
    """sqrt(x), correctly rounded; zeros, infs and NaNs pass through."""
    x = _f32(x)
    s = torch.sqrt(x)
    p, err = _two_prod(s, s)
    r = (x - p) - err
    res = s + r / (2.0 * s)
    return torch.where((s > 0) & torch.isfinite(s), res, s)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """v / max(|v|, eps) along the last axis."""
    n = torch.clamp(det_sqrt(sdot3(v, v)), min=eps).unsqueeze(-1)
    return det_div(v, n)


# Deterministic trigonometry (double-f32); constants and the algorithm
# are the JAX package's (see its module comment for their derivation).
_PIO2_1 = 1.5707963705062866
_PIO2_2 = -4.371138828673793e-08
_PIO2_3 = -1.7151245100058819e-15
_TWO_OVER_PI = 0.6366197466850281

_S1 = (-0.1666666716337204, 4.967053879312289e-09)
_S2 = (0.008333333767950535, -4.34617203337595e-10)
_S3 = (-0.00019841270113829523, 2.725596874933456e-12)
_S4 = 2.7557318844628753e-06
_S5 = -2.5052107943679403e-08
_S6 = 1.6059044372074283e-10
_C1 = (-0.5, 0.0)
_C2 = (0.0416666679084301, -1.2417634698280722e-09)
_C3 = (-0.0013888889225199819, 3.3631094437103215e-11)
_C4 = (2.4801587642286904e-05, -3.40699609366682e-13)
_C5 = -2.755731998149713e-07
_C6 = 2.0876755879584152e-09
_C7 = -1.147074536050896e-11


def _two_sum(a, b):
    """Error-free sum: a + b == s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(a, b):
    ah, al = a
    bh, bl = b
    s, e = _two_sum(ah, bh)
    return _two_sum(s, e + (al + bl))


def _df_mul(a, b):
    ah, al = a
    bh, bl = b
    p, e = _two_prod(ah, bh)
    return _two_sum(p, e + (ah * bl + al * bh))


def _df_mul_f(a, b):
    ah, al = a
    p, e = _two_prod(ah, b)
    return _two_sum(p, e + al * b)


def _sincos_core(x):
    """Reduced-range double-f32 sin/cos: (sin_df, cos_df, quadrant)."""
    x = _f32(x)
    dev = x.device

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    n = torch.round(x * c(_TWO_OVER_PI))
    p1, e1 = _two_prod(n, c(_PIO2_1))
    r = _df_add(_two_sum(x, -p1), (-e1, c(0.0)))
    p2, e2 = _two_prod(n, c(_PIO2_2))
    r = _df_add(r, (-p2, -e2))
    r = _df_add(r, (-(n * c(_PIO2_3)), c(0.0)))

    s = _df_mul(r, r)
    sh = s[0]

    def df_c(v):
        return (c(v[0]), c(v[1]))

    t_f = c(_S4) + sh * (c(_S5) + sh * c(_S6))
    acc = _df_add(df_c(_S3), _df_mul_f(s, t_f))
    acc = _df_add(df_c(_S2), _df_mul(s, acc))
    acc = _df_add(df_c(_S1), _df_mul(s, acc))
    t = _df_mul(s, acc)
    sin_r = _df_mul(r, _df_add((c(1.0), c(0.0)), t))

    c_f = c(_C5) + sh * (c(_C6) + sh * c(_C7))
    acc = _df_add(df_c(_C4), _df_mul_f(s, c_f))
    acc = _df_add(df_c(_C3), _df_mul(s, acc))
    acc = _df_add(df_c(_C2), _df_mul(s, acc))
    acc = _df_add(df_c(_C1), _df_mul(s, acc))
    cos_r = _df_add((c(1.0), c(0.0)), _df_mul(s, acc))

    q = n.to(torch.int32) & 3
    return sin_r, cos_r, q


def det_sincos(x):
    """(sin x, cos x), bit-identical to the JAX package's det_sincos."""
    sin_r, cos_r, q = _sincos_core(x)
    sr, cr = sin_r[0] + sin_r[1], cos_r[0] + cos_r[1]
    odd = (q & 1) == 1
    s = torch.where(odd, cr, sr)
    c = torch.where(odd, sr, cr)
    neg_s = (q == 2) | (q == 3)
    neg_c = (q == 1) | (q == 2)
    return torch.where(neg_s, -s, s), torch.where(neg_c, -c, c)


def det_tan(x):
    """tan x via the double-f32 quotient of the unrounded sin/cos pair."""
    sin_r, cos_r, q = _sincos_core(x)
    odd = (q & 1) == 1
    num = (
        torch.where(odd, -cos_r[0], sin_r[0]),
        torch.where(odd, -cos_r[1], sin_r[1]),
    )
    den = (
        torch.where(odd, sin_r[0], cos_r[0]),
        torch.where(odd, sin_r[1], cos_r[1]),
    )
    neg = (q == 2) | (q == 3)
    num = (torch.where(neg, -num[0], num[0]), torch.where(neg, -num[1], num[1]))
    den = (torch.where(neg, -den[0], den[0]), torch.where(neg, -den[1], den[1]))
    q0 = num[0] / den[0]
    rem = _df_add(num, [-v for v in _df_mul_f(den, q0)])
    q1 = (rem[0] + rem[1]) / den[0]
    return q0 + q1
