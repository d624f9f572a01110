"""Triangle meshes as the scene generators build them: the port's
``models/test_models.py`` (``uv_sphere``, ``ground_plane``) and
``models/face.py`` (``build_faces``) copied, so that the benchmark makes
its scenes without the program.

A generator returns a scene description: a list of models
``(name, faces)``, where ``faces`` is a dict of float32 numpy arrays
``p0``, ``e1``, ``e2`` (edges from ``p0``), ``n0``, ``n1``, ``n2``
(vertex normals), ``normal`` (geometric face normal), ``material_idx``
(int32) and ``partner`` (int32, the model-local index of the two-sided
duplicate, -1 for one-sided faces); and the material tables
``mat_color`` and ``mat_emission`` (K, 3). Model 0 is the light.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("p0", "e1", "e2", "n0", "n1", "n2", "normal", "material_idx")


def build_faces(positions, vertex_normals, material_idx,
                two_sided: bool = True) -> dict:
    """Faces from (F, 3, 3) vertices: p0 and the edges to the other two,
    flat normals when ``vertex_normals`` is None; with ``two_sided`` each
    face is followed by its duplicate with the edges swapped and every
    normal negated."""
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
    front = dict(p0=p0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2, normal=fn,
                 material_idx=material_idx)
    f = len(p0)
    if not two_sided:
        front["partner"] = np.full(f, -1, np.int32)
        return front
    back = dict(p0=p0, e1=e2, e2=e1, n0=-n0, n1=-n2, n2=-n1, normal=-fn,
                material_idx=material_idx)
    out = {}
    for k in FIELDS:
        a = np.empty((2 * f,) + front[k].shape[1:], dtype=front[k].dtype)
        a[0::2] = front[k]
        a[1::2] = back[k]
        out[k] = a
    idx = np.arange(2 * f, dtype=np.int32)
    out["partner"] = idx ^ 1
    return out


def uv_sphere(center, radius: float, material_idx: int = 0, lat: int = 16,
              lon: int = 32) -> dict:
    """A one-sided UV sphere with smooth vertex normals."""
    center = np.asarray(center, dtype=np.float32)
    theta = np.linspace(0.0, np.pi, lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, lon + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack(
        [np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)],
        axis=-1,
    )

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
    mats = np.full((len(idx),), material_idx, dtype=np.int32)
    return build_faces(tris, unit[idx], mats, two_sided=False)


def ground_plane(y: float, half: float, material_idx: int = 0) -> dict:
    """A two-sided square of two triangles at height ``y``."""
    verts = np.array(
        [[-half, y, -half], [half, y, -half], [half, y, half],
         [-half, y, half]],
        dtype=np.float32,
    )
    idx = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64)
    mats = np.full((2,), material_idx, dtype=np.int32)
    return build_faces(verts[idx], None, mats, two_sided=True)
