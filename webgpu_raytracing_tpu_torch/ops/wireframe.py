"""Debug BVH wireframe (counterpart of
``webgpu_raytracing_tpu/ops/wireframe.py``; reference K17,
render.ts:1517-1630).

The reference instanced-draws 12 line-list edges per BVH AABB with an
additive-ish blend (each fragment adds 0.01). Here a vectorized line
rasterizer projects all 8 corners of every node AABB with the
view-projection matrix, clips, and accumulates the 12 edges of every box
into an (H, W) intensity buffer with a fixed number of samples per edge:
a scatter-add (``index_add_``). Every term is the same constant, so each
pixel's sum is the same whatever order the adds land in."""

from __future__ import annotations

import numpy as np
import torch

from .sampling import to_int32

# edge list over the 8 corner indices (bit k of the corner index selects
# min/max on axis k) — the same 12 cube edges as render.ts:1568-1592
_EDGES = np.array(
    [
        (0, 1), (1, 5), (5, 4), (0, 4),  # bottom ring
        (2, 3), (3, 7), (7, 6), (2, 6),  # top ring
        (0, 2), (1, 3), (5, 7), (4, 6),  # verticals
    ],
    dtype=np.int64,
)
# (8, 3) 0 → min, 1 → max
_CORNER_SEL = np.array(
    [[(c >> k) & 1 for k in range(3)] for c in range(8)], np.float32
)

LINE_INTENSITY = 0.01  # fragment output (render.ts:1599)
_SAMPLES_PER_EDGE = 64


def _linspace01(n: int, dev) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in f32 as XLA evaluates it: ``iota``
    times the f32 reciprocal of ``n - 1`` (its compiled form turns the
    division by a constant into that product), the last sample exactly
    1."""
    step = torch.tensor(np.float32(1.0) / np.float32(n - 1), device=dev)
    ts = torch.arange(n - 1, dtype=torch.float32, device=dev) * step
    return torch.cat([ts, torch.ones(1, dtype=torch.float32, device=dev)])


def rasterize_bvh_wireframe(
    node_min: torch.Tensor,  # (N, 3)
    node_max: torch.Tensor,  # (N, 3)
    view_proj: torch.Tensor,  # (4, 4) perspectiveZO * inverse(view)
    width: int,
    height: int,
) -> torch.Tensor:
    """Returns an (H, W) additive intensity image of all node AABB edges."""
    dev = node_min.device
    n = node_min.shape[0]
    sel = torch.from_numpy(_CORNER_SEL).to(dev)
    corners = (
        node_min[:, None, :] * (1.0 - sel)[None]
        + node_max[:, None, :] * sel[None]
    )  # (N, 8, 3)
    hom = torch.cat(
        [corners, torch.ones((n, 8, 1), dtype=torch.float32, device=dev)],
        dim=-1,
    )
    # hom @ view_proj.T, the four terms summed left to right (the JAX
    # package's eager evaluation)
    m = view_proj.T
    clip = ((hom[..., 0:1] * m[0] + hom[..., 1:2] * m[1])
            + hom[..., 2:3] * m[2]) + hom[..., 3:4] * m[3]  # (N, 8, 4)

    e = torch.from_numpy(_EDGES).to(dev)
    a = clip[:, e[:, 0], :]  # (N, 12, 4)
    b = clip[:, e[:, 1], :]

    ts = _linspace01(_SAMPLES_PER_EDGE, dev)
    pts = a[:, :, None, :] * (1 - ts[None, None, :, None]) + b[
        :, :, None, :
    ] * ts[None, None, :, None]  # (N, 12, S, 4)
    pts = pts.reshape(-1, 4)

    w_c = pts[:, 3]
    valid = w_c > 1e-6
    ndc = pts[:, :3] / torch.clamp(w_c, min=1e-6)[:, None]
    # z in [0, 1] (perspectiveZO), x/y in [-1, 1]; y up in clip space →
    # screen row = (1 - y)/2 * H when displayed top-down
    xs = to_int32((ndc[:, 0] + 1.0) * 0.5 * width)
    ys = to_int32((1.0 - ndc[:, 1]) * 0.5 * height)
    valid = (
        valid
        & (ndc[:, 2] >= 0.0)
        & (ndc[:, 2] <= 1.0)
        & (xs >= 0)
        & (xs < width)
        & (ys >= 0)
        & (ys < height)
    )
    flat_idx = torch.where(valid, ys * width + xs, torch.zeros_like(xs))
    contrib = torch.where(
        valid, torch.full_like(w_c, LINE_INTENSITY), torch.zeros_like(w_c)
    )
    img = torch.zeros((height * width,), dtype=torch.float32, device=dev)
    img.index_add_(0, flat_idx.long(), contrib)
    return img.reshape(height, width)


def overlay_wireframe(display: torch.Tensor,
                      wire: torch.Tensor) -> torch.Tensor:
    """Blend the wireframe over a display image like the reference's
    one / one-minus-src-alpha pass with per-fragment alpha 0.01
    (render.ts:1604-1615)."""
    alpha = torch.clamp(wire, 0.0, 1.0)[..., None]
    return display * (1.0 - alpha) + alpha
