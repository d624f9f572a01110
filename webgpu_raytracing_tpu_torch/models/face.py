"""Face geometry in SoA form.

The reference stores each face as ``p0`` plus edge vectors ``e1 = p1 - p0``
and ``e2 = p2 - p0`` — not raw vertices (scene.ts:144-163) — because
Möller–Trumbore consumes edges directly (render.ts:371-373). Every face is
duplicated with flipped winding (edges swapped) and negated normals so
geometry is two-sided under backface culling (``backface`` scene.ts:62-81,
applied :165). The duplicate is interleaved right after its original,
matching reference face indices exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FaceSet:
    """SoA arrays over F faces (all float32 (F, 3) unless noted)."""

    p0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    n0: np.ndarray  # vertex normals at p0 / p0+e1 / p0+e2
    n1: np.ndarray
    n2: np.ndarray
    normal: np.ndarray  # geometric face normal = normalize(cross(e1, e2))
    material_idx: np.ndarray  # (F,) int32

    def __len__(self) -> int:
        return self.p0.shape[0]

    @staticmethod
    def concat(sets: list) -> "FaceSet":
        return FaceSet(
            *(
                np.concatenate([getattr(s, f.name) for s in sets], axis=0)
                for f in dataclasses.fields(FaceSet)
            )
        )


def build_faces(
    positions: np.ndarray,  # (F, 3, 3): triangle vertices p0, p1, p2
    vertex_normals: np.ndarray | None,  # (F, 3, 3) or None (flat normals)
    material_idx: np.ndarray,  # (F,) int32
    two_sided: bool = True,
) -> FaceSet:
    positions = np.asarray(positions, dtype=np.float32)
    p0 = positions[:, 0]
    e1 = positions[:, 1] - p0
    e2 = positions[:, 2] - p0

    fn = np.cross(e1, e2)
    norm = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = (fn / np.maximum(norm, 1e-30)).astype(np.float32)

    if vertex_normals is None:
        n0 = n1 = n2 = fn
    else:
        vn = np.asarray(vertex_normals, dtype=np.float32)
        n0, n1, n2 = vn[:, 0], vn[:, 1], vn[:, 2]

    material_idx = np.asarray(material_idx, dtype=np.int32)
    front = FaceSet(p0, e1, e2, n0, n1, n2, fn, material_idx)
    if not two_sided:
        return front

    # Backface: swap e1/e2 (flipped winding) and negate all normals; vertex
    # normal slots follow the swapped point order (scene.ts:71-80).
    back = FaceSet(p0, e2, e1, -n0, -n2, -n1, -fn, material_idx)

    def interleave(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = np.empty((a.shape[0] * 2,) + a.shape[1:], dtype=a.dtype)
        out[0::2] = a
        out[1::2] = b
        return out

    return FaceSet(
        *(
            interleave(getattr(front, f.name), getattr(back, f.name))
            for f in dataclasses.fields(FaceSet)
        )
    )
