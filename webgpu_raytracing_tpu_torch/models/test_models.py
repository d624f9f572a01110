"""Analytic fixture models (testModels.ts:1-98) + extra analytic scenes.

Parity notes:

* ``makeModel`` fixtures are single-sided (no backface duplication — only
  OBJ models pass through ``backface``, scene.ts:165) and use the geometric
  face normal as all three vertex normals (testModels.ts:26-35).
* The reference pre-transforms the cube vertex list by ``cubeModelMatrix``
  *and* ``makeModel`` applies the same matrix again (testModels.ts:41-76) —
  so the "unit cube scaled 0.5 at z=-4" actually lands at scale 0.25 around
  z=-6. Replicated verbatim: fixtures must match the reference geometry.
"""

from __future__ import annotations

import numpy as np

from .face import FaceSet, build_faces


def make_model(
    vertices: np.ndarray,
    indices: np.ndarray,
    model_matrix: np.ndarray | None = None,
    material_idx: int = 0,
) -> FaceSet:
    """testModels.ts:5-39 — faces from an indexed mesh, flat normals."""
    vertices = np.asarray(vertices, dtype=np.float32)
    if model_matrix is not None:
        m = np.asarray(model_matrix, dtype=np.float32)
        hom = np.concatenate(
            [vertices, np.ones((len(vertices), 1), np.float32)], axis=1
        )
        vertices = (hom @ m.T)[:, :3]
    tris = vertices[np.asarray(indices, dtype=np.int64)]  # (F, 3, 3)
    mats = np.full((len(tris),), material_idx, dtype=np.int32)
    return build_faces(tris, None, mats, two_sided=False)


def _translate_scale(t, s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    m[0, 0] = m[1, 1] = m[2, 2] = s
    return m


CUBE_MODEL_MATRIX = _translate_scale((0.0, 0.0, -4.0), 0.5)

_UNIT_CUBE_VERTICES = np.array(
    [
        [1, 1, 1],
        [-1, 1, 1],
        [-1, -1, 1],
        [1, -1, 1],
        [1, 1, -1],
        [-1, 1, -1],
        [-1, -1, -1],
        [1, -1, -1],
    ],
    dtype=np.float32,
)

_UNIT_CUBE_INDICES = np.array(
    [
        [0, 1, 2],
        [2, 3, 0],
        [5, 4, 6],
        [7, 6, 4],
        [0, 4, 1],
        [5, 1, 4],
        [6, 2, 5],
        [5, 2, 1],
        [7, 3, 6],
        [6, 3, 2],
        [0, 3, 7],
        [7, 4, 0],
    ],
    dtype=np.int64,
)


def unit_cube_model() -> FaceSet:
    """testModels.ts:71-76 (matrix applied twice, as in the reference)."""
    pre = (
        np.concatenate(
            [_UNIT_CUBE_VERTICES, np.ones((8, 1), np.float32)], axis=1
        )
        @ CUBE_MODEL_MATRIX.T
    )[:, :3]
    return make_model(pre, _UNIT_CUBE_INDICES, CUBE_MODEL_MATRIX)


def triangle_model() -> FaceSet:
    """testModels.ts:87-96 — one triangle at (-0.5, -0.5, -2)."""
    m = _translate_scale((-0.5, -0.5, -2.0), 1.0)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    return make_model(verts, np.array([[0, 1, 2]]), m)


def uv_sphere(
    center, radius: float, material_idx: int = 0, lat: int = 16, lon: int = 32
) -> FaceSet:
    """Triangulated UV sphere with smooth vertex normals — used by the
    BASELINE config #1 "spheres + plane" analytic scene."""
    center = np.asarray(center, dtype=np.float32)
    theta = np.linspace(0.0, np.pi, lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, lon + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack(
        [
            np.sin(tt) * np.cos(pp),
            np.cos(tt),
            np.sin(tt) * np.sin(pp),
        ],
        axis=-1,
    )  # (lat+1, lon, 3) unit sphere

    def vid(i, j):
        return i * lon + (j % lon)

    quads = []
    for i in range(lat):
        for j in range(lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                quads.append((a, b, d))
            if i < lat - 1:
                quads.append((b, c, d))
    unit = pts.reshape(-1, 3)
    idx = np.array(quads, dtype=np.int64)
    tris = unit[idx] * radius + center
    nrms = unit[idx]  # smooth normals = unit directions
    mats = np.full((len(idx),), material_idx, dtype=np.int32)
    return build_faces(tris, nrms, mats, two_sided=False)


def ground_plane(y: float, half: float, material_idx: int = 0) -> FaceSet:
    verts = np.array(
        [[-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]],
        dtype=np.float32,
    )
    idx = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64)
    tris = verts[idx]
    mats = np.full((2,), material_idx, dtype=np.int32)
    return build_faces(tris, None, mats, two_sided=True)
