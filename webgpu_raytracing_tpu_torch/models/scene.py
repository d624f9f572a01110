"""Scene assembly: models + materials → flat torch tables (counterpart of
``webgpu_raytracing_tpu/models/scene.py``).

The per-model preorder BVHs are concatenated with rebased skip links, the
faces flattened into SoA tables, and the scene cut into clusters (grouped
into superclusters once the scene is large), exactly as in the JAX
package; :meth:`Scene.tables` returns the same arrays as torch tensors on
an explicit device.

Load-bearing contract preserved: **model 0 is the light source**.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cluster_trace import ClusterTables, pack_cluster_tables
from ..ops.env_sample import ENV_FIELDS, EnvDistribution
from .bvh import BVH, build_bvh
from .cluster import build_clusters
from .face import FaceSet, build_faces
from .mtl import parse_mtl
from .native import parse_obj_native
from .obj import parse_obj
from .test_models import triangle_model, unit_cube_model

# The reference renders this hand-picked, reordered subset of the 13 loaded
# models (render.ts:91-100). Load order is [unitCube, triangle, Light,
# back_wall, ceiling, Dodecahedron, Floor, Ladder, left_wall, right_wall,
# Suzanne, TallBox, Teapot], so the rendered set is Light, Suzanne, Floor,
# TallBox, left_wall, Dodecahedron, back_wall, ceiling — Light first.
REFERENCE_SUBSET = (2, 10, 6, 11, 8, 5, 3, 4)

# SceneTables fields that hold plain arrays (the rest is ``clusters``)
TABLE_FIELDS = (
    "node_box",
    "node_meta",
    "tri",
    "shade_normal",
    "face_material",
    "model_face_offset",
    "model_face_count",
    "mat_color",
    "mat_emission",
)
CLUSTER_FIELDS = (
    "box", "mat_b", "face_id", "partner_code", "super_box", "child_box_t",
)


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Device-resident scene data (torch tensors on one device)."""

    node_box: torch.Tensor  # (N, 8) f32: min.xyz, max.xyz, 0, 0
    node_meta: torch.Tensor  # (N, 4) i32: skip, face0, face1, 0
    tri: torch.Tensor  # (F, 9) f32: p0, e1, e2
    shade_normal: torch.Tensor  # (F, 12) f32: faceNormal, n0, n1, n2
    face_material: torch.Tensor  # (F,) i32
    model_face_offset: torch.Tensor  # (M,) i32
    model_face_count: torch.Tensor  # (M,) i32
    mat_color: torch.Tensor  # (K, 3) f32
    mat_emission: torch.Tensor  # (K, 3) f32
    clusters: ClusterTables

    @property
    def device(self) -> torch.device:
        return self.tri.device

    def to(self, device) -> "SceneTables":
        return SceneTables(
            clusters=self.clusters.to(device),
            **{k: getattr(self, k).to(device) for k in TABLE_FIELDS},
        )


def tables_from_numpy(arrays: Dict[str, np.ndarray], device) -> SceneTables:
    """Build SceneTables from numpy arrays keyed by field name; the
    cluster fields are keyed ``clusters.<name>`` for each name of
    ``CLUSTER_FIELDS`` (``partner_code``, ``super_box`` and
    ``child_box_t`` optional). This is how tests hand the JAX package's
    tables to the port."""

    def t(a):
        return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(
            device
        )

    return SceneTables(
        clusters=ClusterTables(**{
            k: t(arrays["clusters." + k])
            for k in CLUSTER_FIELDS if "clusters." + k in arrays
        }),
        **{k: t(arrays[k]) for k in TABLE_FIELDS},
    )


def env_distribution_from_numpy(
    arrays: Dict[str, np.ndarray], device
) -> EnvDistribution:
    """Build an EnvDistribution from numpy arrays keyed by field name
    (``img``, ``row_cdf``, ``cond_cdf``, ``lum``, ``total``): how tests
    hand a JAX ``EnvDistribution``'s tables to the port."""
    return EnvDistribution(
        **{
            k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
            for k in ENV_FIELDS
        }
    )


def tables_to_numpy(tables: SceneTables) -> Dict[str, np.ndarray]:
    """Inverse of :func:`tables_from_numpy`."""
    out = {k: getattr(tables, k).cpu().numpy() for k in TABLE_FIELDS}
    for k in CLUSTER_FIELDS:
        v = getattr(tables.clusters, k)
        if v is not None:
            out["clusters." + k] = v.cpu().numpy()
    return out


@dataclasses.dataclass
class Model:
    name: str
    faces: FaceSet
    bvh: BVH


@dataclasses.dataclass
class Scene:
    models: List[Model]
    mat_color: np.ndarray  # (K, 3) f32
    mat_emission: np.ndarray  # (K, 3) f32
    mat_names: List[str]
    # how load_scene parsed the OBJ: "native" (runtime/loader.cpp, whose
    # BVH builder then built the trees too) or "python"; None for scenes
    # that were not loaded from a file
    loader: Optional[str] = None

    def select(self, indices: Sequence[int]) -> "Scene":
        return dataclasses.replace(
            self, models=[self.models[i] for i in indices]
        )

    def tables(
        self,
        device,
        cluster_size: int = 128,
        group_size: int | None = None,
    ) -> SceneTables:
        """Flatten all models into threaded traversal + shading tables on
        ``device``. ``group_size`` None picks two-level clusters (G = 64)
        for scenes of more than 1024 clusters' worth of faces, as the JAX
        package does; 0 forces single-level tables."""
        node_box_l, node_meta_l = [], []
        face_off, face_cnt = [], []
        node_off = 0
        foff = 0
        for m in self.models:
            b = m.bvh
            n = len(b)
            box = np.zeros((n, 8), dtype=np.float32)
            box[:, 0:3] = b.node_min
            box[:, 3:6] = b.node_max
            meta = np.zeros((n, 4), dtype=np.int32)
            meta[:, 0] = b.skip + node_off  # model-local end == next root
            meta[:, 1] = np.where(b.face0 >= 0, b.face0 + foff, -1)
            meta[:, 2] = np.where(b.face1 >= 0, b.face1 + foff, -1)
            node_box_l.append(box)
            node_meta_l.append(meta)
            face_off.append(foff)
            face_cnt.append(len(m.faces))
            node_off += n
            foff += len(m.faces)

        fs = FaceSet.concat([m.faces for m in self.models])
        tri = np.concatenate([fs.p0, fs.e1, fs.e2], axis=1).astype(np.float32)
        shade = np.concatenate(
            [fs.normal, fs.n0, fs.n1, fs.n2], axis=1
        ).astype(np.float32)

        if group_size is None:
            total_faces = sum(len(m.faces) for m in self.models)
            group_size = 64 if total_faces > 1024 * cluster_size else 0
        # two-sided duplicate map: face j is i's partner iff it has the
        # same p0 with e1/e2 swapped (JAX scene.py:138-155)
        f_total = len(fs)
        key = np.ascontiguousarray(
            np.concatenate([fs.p0, fs.e1, fs.e2], axis=1)
        ).view(np.dtype((np.void, 36))).ravel()
        flip = np.ascontiguousarray(
            np.concatenate([fs.p0, fs.e2, fs.e1], axis=1)
        ).view(np.dtype((np.void, 36))).ravel()
        order = np.argsort(key)
        pos = np.searchsorted(key[order], flip)
        cand = order[np.clip(pos, 0, f_total - 1)]
        match = (pos < f_total) & (key[cand] == flip)
        partner = np.where(match, cand, -1).astype(np.int32)

        clusters = pack_cluster_tables(
            build_clusters(
                self.models, cluster_size=cluster_size, group_size=group_size
            ),
            partner=partner,
            device=device,
        )

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return SceneTables(
            clusters=clusters,
            node_box=t(np.concatenate(node_box_l, axis=0)),
            node_meta=t(np.concatenate(node_meta_l, axis=0)),
            tri=t(tri),
            shade_normal=t(shade),
            face_material=t(fs.material_idx.astype(np.int32)),
            model_face_offset=t(np.array(face_off, np.int32)),
            model_face_count=t(np.array(face_cnt, np.int32)),
            mat_color=t(np.asarray(self.mat_color, np.float32)),
            mat_emission=t(np.asarray(self.mat_emission, np.float32)),
        )


def scene_from_facesets(
    named_facesets: Sequence[Tuple[str, FaceSet]],
    mat_color: np.ndarray,
    mat_emission: np.ndarray,
    mat_names: Optional[List[str]] = None,
) -> Scene:
    models = [
        Model(name=n, faces=f, bvh=build_bvh(f)) for n, f in named_facesets
    ]
    return Scene(
        models=models,
        mat_color=np.asarray(mat_color, np.float32).reshape(-1, 3),
        mat_emission=np.asarray(mat_emission, np.float32).reshape(-1, 3),
        mat_names=mat_names or [f"m{i}" for i in range(len(mat_color))],
    )


def materials_from_mtl(mtls) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """scene.ts:92-108 — Kd → color, Ke → emission; the material named
    'Light' is forced to color 0, emission (1,1,1)."""
    colors, emissions, names = [], [], []
    for m in mtls:
        if m.name == "Light":
            colors.append((0.0, 0.0, 0.0))
            emissions.append((1.0, 1.0, 1.0))
        else:
            colors.append(m.Kd)
            emissions.append(m.Ke)
        names.append(m.name)
    return (
        np.array(colors, dtype=np.float32),
        np.array(emissions, dtype=np.float32),
        names,
    )


def load_scene(
    obj_path: str,
    mtl_path: str,
    selection: Optional[Sequence[int]] = REFERENCE_SUBSET,
) -> Scene:
    """loadModels() (scene.ts:83-177): parse OBJ+MTL, prepend the two
    analytic fixtures, build two-sided faces + per-model BVHs; then apply
    the reference's 8-model subset selection (render.ts:91-100). The OBJ
    goes through the native parser when its library is available
    (models/native.py), else through :func:`.obj.parse_obj`, with the same
    result; ``Scene.loader`` says which."""
    with open(mtl_path) as fh:
        mtls = parse_mtl(fh.read())
    mat_color, mat_emission, mat_names = materials_from_mtl(mtls)
    name_to_idx = {n: i for i, n in enumerate(mat_names)}

    obj = parse_obj_native(os.fspath(obj_path))
    loader = "native"
    if obj is None:
        with open(obj_path) as fh:
            obj = parse_obj(fh.read())
        loader = "python"

    models: List[Model] = [
        Model(name=name, faces=fs, bvh=build_bvh(fs))
        for name, fs in (
            ("unitCube", unit_cube_model()),
            ("triangle", triangle_model()),
        )
    ]

    for om in obj.models:
        tris = obj.vertices[om.vertex_idx]  # (F, 3, 3)
        has_n = om.normal_idx.size and (om.normal_idx >= 0).all()
        nrms = obj.normals[om.normal_idx] if has_n else None
        mats = np.array(
            [name_to_idx.get(m, -1) for m in om.material], dtype=np.int32
        )
        fs = build_faces(tris, nrms, mats, two_sided=True)
        models.append(Model(name=om.name, faces=fs, bvh=build_bvh(fs)))

    scene = Scene(
        models=models,
        mat_color=mat_color,
        mat_emission=mat_emission,
        mat_names=mat_names,
        loader=loader,
    )
    if selection is not None:
        scene = scene.select(selection)
    return scene
