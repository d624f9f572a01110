"""The comparison that decides ``correct``: what the timed path produced
for the compared frames against the plain reference (reference.py).

Three numbers, each held to the cell's limit (``cells/<cell>.json``):

- ``bad_px_pct``: the share, in percent, of the compared samples' pixels
  whose colour is wrong: NaN in one and not the other, or apart by more
  than ``REL_TOL`` of the reference's largest channel plus ``ABS_TOL``.
  Rounding that moves a ray by an ulp past an edge changes a whole path,
  so a sound run reads a few pixels in ten thousand, and a run in a
  lower precision reads most of them.
- ``rays_err_pct``: the frames' ray count, as the program reports it to
  ``mrays_per_s``, against the reference's count, in percent.
- ``accum_px``: pixels of the accumulation image where the frame did not
  add exactly the sum of its samples' colours and its sample count to
  the image it started from (NaN where NaN). It is exact: limit 0.
"""

from __future__ import annotations

import torch

REL_TOL = 1e-3
ABS_TOL = 1e-3
NAMES = ("bad_px_pct", "rays_err_pct", "accum_px")


def bad_pixels(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """Pixels of one sample's (R, 3) colours that disagree."""
    if prog.shape != ref.shape:
        return ref.shape[0]
    nan_p, nan_r = torch.isnan(prog).any(-1), torch.isnan(ref).any(-1)
    diff = (prog - ref).abs().amax(-1)
    tol = REL_TOL * ref.abs().amax(-1) + ABS_TOL
    finite = ~nan_p & ~nan_r
    bad = (nan_p != nan_r) | (finite & ~(diff <= tol))
    return int(bad.sum())


def accumulation_errors(before, after, colors) -> int:
    """Pixels of the (H, W, 4) image where ``after`` is not ``before``
    plus the frame's samples (colour sums in the program's order, and
    the count of samples), bit for bit with NaN equal to NaN."""
    h, w = before.shape[:2]
    if not colors or any(c.shape[0] != h * w for c in colors):
        return h * w
    color = torch.zeros_like(colors[0]) + colors[0]
    for c in colors[1:]:
        color = color + c
    samples = torch.full((h * w, 1), float(len(colors)),
                         dtype=color.dtype, device=color.device)
    want = before + torch.cat([color, samples], -1).reshape(h, w, 4)
    same = (want == after) | (torch.isnan(want) & torch.isnan(after))
    return int((~same.all(-1)).sum())


class Tally:
    """The numbers over every compared frame."""

    def __init__(self):
        self.pixels = self.bad = self.accum = 0
        self.rays_prog = self.rays_ref = 0.0
        self.frames = 0

    def add(self, prog_colors, ref_colors, prog_rays, ref_rays,
            before=None, after=None):
        self.frames += 1
        if len(prog_colors) != len(ref_colors):
            self.bad += sum(c.shape[0] for c in ref_colors)
        for p, r in zip(prog_colors, ref_colors):
            self.bad += bad_pixels(p, r)
        self.pixels += sum(c.shape[0] for c in ref_colors)
        self.rays_prog += float(prog_rays)
        self.rays_ref += float(ref_rays)
        if before is not None:
            self.accum += accumulation_errors(before, after, prog_colors)

    def numbers(self) -> dict:
        if not self.frames:
            return {}
        return dict(
            bad_px_pct=100.0 * self.bad / max(self.pixels, 1),
            rays_err_pct=100.0 * abs(self.rays_prog - self.rays_ref)
            / max(self.rays_ref, 1.0),
            accum_px=self.accum,
        )


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number present and within its limit."""
    return bool(numbers) and all(
        k in numbers and numbers[k] <= limits[k] for k in limits)
