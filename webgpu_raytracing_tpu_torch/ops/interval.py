"""Interval math (counterpart of ``webgpu_raytracing_tpu/ops/interval.py``;
reference K2, render.ts:315-344), elementwise on tensors or floats.

Kept with the reference's ``intervalOverlap`` OR-quirk (render.ts:322-323)
for parity; the traversal uses the corrected test (ops/intersect.py
``ray_aabb``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EPSILON, F32_MAX, F32_MIN


class Interval(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor


EMPTY = (F32_MAX, F32_MIN)
UNIVERSE = (F32_MIN, F32_MAX)
POSITIVE_UNIVERSE = (EPSILON, F32_MAX)


def overlap(a_min, a_max, b_min, b_max):
    """intervalOverlap verbatim, with the ``or`` that makes it nearly
    always true (render.ts:322-323)."""
    return (a_min <= b_max) | (b_min <= a_max)


def overlap_correct(a_min, a_max, b_min, b_max):
    """The conventional AND form."""
    return (a_min <= b_max) & (b_min <= a_max)


def contains(i_min, i_max, x):
    return (i_min <= x) & (x <= i_max)


def surrounds(i_min, i_max, x):
    """Strict containment, the triangle-hit interval test
    (render.ts:331-334)."""
    return (i_min < x) & (x < i_max)


def clamp(i_min, i_max, x):
    return torch.minimum(torch.maximum(x, i_min), i_max)
