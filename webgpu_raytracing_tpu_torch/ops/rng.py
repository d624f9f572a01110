"""Device RNG + sampling library (counterpart of
``webgpu_raytracing_tpu/ops/rng.py``, the reference's WGSL PCG hash,
shaders/rng.ts:30-168).

The state is one 32-bit word per lane. PyTorch's uint32 dtype lacks
shifts on the CPU, so the word is held in an int64 tensor with values in
``[0, 2**32)`` and every step is masked with ``& 0xFFFFFFFF``: the same
bits as the JAX package's uint32 arithmetic, draw for draw.

Every sampler returns ``(value, new_state)``; :func:`masked_advance`
advances only active lanes, mirroring divergent draw order in the SIMT
original.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import PI, TWO_PI

UINT_MAX_F = 4294967295.0  # f32(0xffffffffu) == 2**32
_MASK = 0xFFFFFFFF
THIRD = 0.3333333432674408  # f32(1/3), the exponent of sample_insphere


def seed_state(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """rng_state = seed + idx (render.ts:1453), mod 2**32."""
    return (idx.to(torch.int64) + (int(seed) & _MASK)) & _MASK


def random_1u(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PCG-style hash (shaders/rng.ts:34-40):

    old = state + 747796405 + 2891336453 (mod 2^32)
    word = ((old >> ((old >> 28) + 4)) ^ old) * 277803737
    state' = (word >> 22) ^ word
    """
    old = (state + (747796405 + 2891336453)) & _MASK
    shift = (old >> 28) + 4
    word = (((old >> shift) ^ old) * 277803737) & _MASK
    new_state = (word >> 22) ^ word
    return new_state, new_state


def random_1(state):
    """f32 in [0, 1] (shaders/rng.ts:43-45)."""
    u, state = random_1u(state)
    return u.to(torch.float32) / UINT_MAX_F, state


def random_2(state):
    """vec2(random_1(), random_1()) — x drawn first (rng.ts:16-28)."""
    x, state = random_1(state)
    y, state = random_1(state)
    return torch.stack([x, y], dim=-1), state


def random_3(state):
    """vec3 of three draws, x first."""
    x, state = random_1(state)
    y, state = random_1(state)
    z, state = random_1(state)
    return torch.stack([x, y, z], dim=-1), state


def masked_advance(state, new_state, active):
    """Advance the state only where ``active``."""
    return torch.where(active, new_state, state)


def sample_circle(t):
    """rng.ts:69-72 — point on the unit circle."""
    from .detmath import det_sincos

    s, c = det_sincos(t * TWO_PI)
    return torch.stack([c, s], dim=-1)


def sample_incircle(t):
    """rng.ts:74-76 — uniform in the unit disc; t is (..., 2)."""
    from .detmath import det_sqrt

    return sample_circle(t[..., 0]) * det_sqrt(t[..., 1]).unsqueeze(-1)


def sample_sphere(t):
    """rng.ts:102-109 — uniform on the unit sphere; t is (..., 2)."""
    from .detmath import det_sincos, det_sqrt

    u = t[..., 0] * 2.0 - 1.0
    v = t[..., 1]
    sin_theta = det_sqrt(torch.clamp(1.0 - u * u, min=0.0))
    sphi, cphi = det_sincos(TWO_PI * v)
    return torch.stack([sin_theta * cphi, u, sin_theta * sphi], dim=-1)


def sample_hemisphere(t, n):
    """rng.ts:111-119 — uniform on the hemisphere around n (WGSL
    ``faceForward(v, v, -n)``: v where dot(v, n) > 0, else -v)."""
    v = sample_sphere(t)
    return torch.where((v * n).sum(-1, keepdim=True) > 0, v, -v)


def sample_cosine_weighted_hemisphere(t, n):
    """rng.ts:88-100 — normalize(n + sample_sphere(t)); n is not
    normalized first (reference behaviour)."""
    from .detmath import normalize

    return normalize(n + sample_sphere(t))


def sample_insquare(t):
    """rng.ts:125-127 — uniform in [-1, 1]^2."""
    return 2.0 * t - 1.0


def sample_intriangle(t):
    """Uniform barycentric (u, v) in the unit triangle: the standard
    reflection, as the JAX package has it (the reference's rng.ts:129-131
    leaves ``t`` unreflected when t.x >= t.y and lands outside the
    triangle a quarter of the time)."""
    u, v = t[..., 0], t[..., 1]
    flip = u + v > 1.0
    return torch.stack(
        [torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)],
        dim=-1,
    )


def sample_insphere(t):
    """rng.ts:121-123 — uniform in the unit ball; t is (..., 3). The cube
    root is ``pow(|x|, f32(1/3))`` in double, rounded to f32 and given
    x's sign: within 1 ulp of ``jnp.cbrt`` (XLA's own approximation),
    which no library function here reproduces bit for bit."""
    x = t[..., 2]
    root = torch.pow(torch.abs(x).double(), THIRD).float()
    return sample_sphere(t[..., :2]) * torch.copysign(root, x).unsqueeze(-1)


# 1/pdf of the samplers (rng.ts:133-167)
def pdf_inv_sphere():
    return 2.0 * TWO_PI


def pdf_inv_hemisphere():
    return TWO_PI


def pdf_inv_circle():
    return TWO_PI


def pdf_inv_incircle():
    return PI


def pdf_inv_insphere():
    return PI * 4.0 / 3.0


def pdf_inv_intriangle():
    return 0.5


def pdf_inv_insquare():
    return 4.0
