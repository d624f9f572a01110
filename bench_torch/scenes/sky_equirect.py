"""An (H, W, 3) equirect map of the procedural sky, sampled at each
texel's centre direction (the inverse of the equirect lookup): the
port's ``chip_smoke.sky_equirect``, over the reference's sky. Nothing
is drawn from the seed."""

from __future__ import annotations

import math

import torch

from reference import procedural_sky


def generate(seed: int, height: int, width: int, device) -> torch.Tensor:
    del seed
    theta = math.pi * (1.0 - (torch.arange(
        height, device=device, dtype=torch.float32) + 0.5) / height)
    phi = (torch.arange(width, device=device, dtype=torch.float32)
           + 0.5) / width
    phi = phi * 2.0 * math.pi - math.pi
    st, ct = torch.sin(theta)[:, None], torch.cos(theta)[:, None]
    d = torch.stack([st * torch.cos(phi)[None], ct.expand(height, width),
                     st * torch.sin(phi)[None]], dim=-1)
    return procedural_sky(d.reshape(-1, 3), torch.float32).reshape(
        height, width, 3)
