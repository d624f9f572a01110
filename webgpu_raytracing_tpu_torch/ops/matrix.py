"""Device-side 4×4 matrix inverse (counterpart of
``webgpu_raytracing_tpu/ops/matrix.py``; reference K13,
render.ts:1336-1376). View math is host-side numpy (utils/mathx.py); the
device op is kept for parity, batched over leading dims."""

from __future__ import annotations

import torch


def mat4_inverse(m: torch.Tensor) -> torch.Tensor:
    """Cofactor-expansion inverse of (..., 4, 4) matrices, the WGSL's
    formulation (render.ts:1337-1375), one rounding per operation in the
    JAX package's order."""
    a00, a01, a02, a03 = (m[..., 0, k] for k in range(4))
    a10, a11, a12, a13 = (m[..., 1, k] for k in range(4))
    a20, a21, a22, a23 = (m[..., 2, k] for k in range(4))
    a30, a31, a32, a33 = (m[..., 3, k] for k in range(4))

    b00 = a00 * a11 - a01 * a10
    b01 = a00 * a12 - a02 * a10
    b02 = a00 * a13 - a03 * a10
    b03 = a01 * a12 - a02 * a11
    b04 = a01 * a13 - a03 * a11
    b05 = a02 * a13 - a03 * a12
    b06 = a20 * a31 - a21 * a30
    b07 = a20 * a32 - a22 * a30
    b08 = a20 * a33 - a23 * a30
    b09 = a21 * a32 - a22 * a31
    b10 = a21 * a33 - a23 * a31
    b11 = a22 * a33 - a23 * a32

    det = b00 * b11 - b01 * b10 + b02 * b09 + b03 * b08 - b04 * b07 + b05 * b06
    inv_det = 1.0 / det

    rows = [
        [
            a11 * b11 - a12 * b10 + a13 * b09,
            a02 * b10 - a01 * b11 - a03 * b09,
            a31 * b05 - a32 * b04 + a33 * b03,
            a22 * b04 - a21 * b05 - a23 * b03,
        ],
        [
            a12 * b08 - a10 * b11 - a13 * b07,
            a00 * b11 - a02 * b08 + a03 * b07,
            a32 * b02 - a30 * b05 - a33 * b01,
            a20 * b05 - a22 * b02 + a23 * b01,
        ],
        [
            a10 * b10 - a11 * b08 + a13 * b06,
            a01 * b08 - a00 * b10 - a03 * b06,
            a30 * b04 - a31 * b02 + a33 * b00,
            a21 * b02 - a20 * b04 - a23 * b00,
        ],
        [
            a11 * b07 - a10 * b09 - a12 * b06,
            a00 * b09 - a01 * b07 + a02 * b06,
            a31 * b01 - a30 * b03 - a32 * b00,
            a20 * b03 - a21 * b01 + a22 * b00,
        ],
    ]
    out = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return out * inv_det[..., None, None]
