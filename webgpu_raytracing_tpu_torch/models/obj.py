"""Wavefront OBJ parser (numpy; a copy of
``webgpu_raytracing_tpu/models/obj.py``, which this package does not import).

Replaces the reference's ``obj-file-parser`` dependency (scene.ts:84-86).
Semantics preserved:

* vertex / normal / texcoord indices are global across ``o`` records (the
  reference concatenates ``posArray`` across models, scene.ts:124-126);
* each ``o`` starts a new model; faces carry the active ``usemtl`` name;
* polygons with more than 3 vertices are fan-triangulated.

Output is index arrays, not positions — geometry assembly (edge vectors,
backface duplication) happens in :mod:`.face`.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ObjModel:
    name: str
    # (F, 3) int32 global indices into the file-wide vertex arrays; -1 when absent
    vertex_idx: np.ndarray
    normal_idx: np.ndarray
    texcoord_idx: np.ndarray
    material: List[str]  # per-face material name


@dataclasses.dataclass
class ObjFile:
    vertices: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (N, 3) float32
    texcoords: np.ndarray  # (T, 3) float32
    models: List[ObjModel]


def _parse_face_vertex(tok: str) -> tuple:
    """`v`, `v/t`, `v//n`, or `v/t/n` → (v, t, n) 0-based, -1 if absent."""
    parts = tok.split("/")
    v = int(parts[0]) - 1
    t = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
    n = int(parts[2]) - 1 if len(parts) > 2 and parts[2] else -1
    return v, t, n


def parse_obj(text: str) -> ObjFile:
    vertices: List[List[float]] = []
    normals: List[List[float]] = []
    texcoords: List[List[float]] = []
    models: List[ObjModel] = []

    cur_name = "default"
    cur_vi: List[List[int]] = []
    cur_ni: List[List[int]] = []
    cur_ti: List[List[int]] = []
    cur_mat: List[str] = []
    material = ""
    started = False

    def flush():
        nonlocal cur_vi, cur_ni, cur_ti, cur_mat
        if not started:
            return
        models.append(
            ObjModel(
                name=cur_name,
                vertex_idx=np.array(cur_vi, dtype=np.int32).reshape(-1, 3),
                normal_idx=np.array(cur_ni, dtype=np.int32).reshape(-1, 3),
                texcoord_idx=np.array(cur_ti, dtype=np.int32).reshape(-1, 3),
                material=cur_mat,
            )
        )
        cur_vi, cur_ni, cur_ti, cur_mat = [], [], [], []

    for raw in text.split("\n"):
        i = raw.find("#")
        if i >= 0:
            raw = raw[:i]
        items = raw.split()
        if not items:
            continue
        key = items[0]
        if key == "v":
            vertices.append([float(x) for x in items[1:4]])
        elif key == "vn":
            normals.append([float(x) for x in items[1:4]])
        elif key == "vt":
            vals = [float(x) for x in items[1:4]]
            while len(vals) < 3:
                vals.append(0.0)
            texcoords.append(vals)
        elif key in ("o", "g"):
            flush()
            cur_name = items[1] if len(items) > 1 else "default"
            started = True
        elif key == "usemtl":
            material = items[1] if len(items) > 1 else ""
        elif key == "f":
            started = True
            fv = [_parse_face_vertex(t) for t in items[1:]]
            # fan triangulation
            for k in range(1, len(fv) - 1):
                tri = (fv[0], fv[k], fv[k + 1])
                cur_vi.append([t[0] for t in tri])
                cur_ti.append([t[1] for t in tri])
                cur_ni.append([t[2] for t in tri])
                cur_mat.append(material)

    flush()

    def arr(lst, cols):
        if not lst:
            return np.zeros((0, cols), dtype=np.float32)
        return np.array(lst, dtype=np.float32)

    return ObjFile(
        vertices=arr(vertices, 3),
        normals=arr(normals, 3),
        texcoords=arr(texcoords, 3),
        models=models,
    )
