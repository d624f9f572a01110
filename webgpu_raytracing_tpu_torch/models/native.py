"""ctypes binding to the native scene-ingestion runtime
(``runtime/loader.cpp``, a copy of the JAX package's; counterpart of
``webgpu_raytracing_tpu/models/native.py``).

Compiles the shared library with ``g++ -O3`` on first use, never at
import, into ``build/native/libwrtloader_<hash>.so`` beside the package
(the checkout's ``build/`` directory, ignored by git), named by a hash of
the source. :func:`parse_obj_native` and :func:`build_bvh_native` return
byte-identical results to :func:`.obj.parse_obj` and
:func:`.bvh.build_bvh_python`; :func:`.scene.load_scene` and
:func:`.bvh.build_bvh` use them when the library is available. Set
``WRT_NO_NATIVE=1`` to force the pure-Python path; without a host
compiler the library is unavailable and the Python path runs
(``Scene.loader`` says which one loaded a scene)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "runtime", "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build_lib() -> Optional[str]:
    with open(SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libwrtloader_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    # a per-process temporary name: concurrent builders (test workers)
    # must not rename each other's half-written file
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", SRC, "-o",
           tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp_path, so_path)
    except (OSError, subprocess.SubprocessError):
        # no compiler, or it failed: another process may have won the race
        return so_path if os.path.exists(so_path) else None
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return so_path


def get_lib():
    """The native library (built if needed), or None when it is disabled
    (``WRT_NO_NATIVE``) or cannot be built."""
    global _lib, _build_failed
    if os.environ.get("WRT_NO_NATIVE"):
        return None
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _build_lib()
        if so is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(so)
        c = ctypes
        lib.wrt_obj_parse.restype = c.c_void_p
        lib.wrt_obj_parse.argtypes = [c.c_char_p]
        lib.wrt_obj_free.restype = None
        lib.wrt_obj_free.argtypes = [c.c_void_p]
        for fn in (
            "wrt_obj_num_vertices", "wrt_obj_num_normals",
            "wrt_obj_num_texcoords", "wrt_obj_num_models",
            "wrt_obj_num_materials",
        ):
            getattr(lib, fn).restype = c.c_int64
            getattr(lib, fn).argtypes = [c.c_void_p]
        fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        for fn in (
            "wrt_obj_copy_vertices", "wrt_obj_copy_normals",
            "wrt_obj_copy_texcoords",
        ):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [c.c_void_p, fp]
        lib.wrt_obj_model_name.restype = c.c_char_p
        lib.wrt_obj_model_name.argtypes = [c.c_void_p, c.c_int64]
        lib.wrt_obj_material_name.restype = c.c_char_p
        lib.wrt_obj_material_name.argtypes = [c.c_void_p, c.c_int64]
        lib.wrt_obj_model_num_faces.restype = c.c_int64
        lib.wrt_obj_model_num_faces.argtypes = [c.c_void_p, c.c_int64]
        lib.wrt_obj_model_copy.restype = None
        lib.wrt_obj_model_copy.argtypes = [c.c_void_p, c.c_int64, ip, ip,
                                           ip, ip]
        lib.wrt_bvh_build.restype = c.c_void_p
        lib.wrt_bvh_build.argtypes = [fp, fp, fp, c.c_int64]
        lib.wrt_bvh_free.restype = None
        lib.wrt_bvh_free.argtypes = [c.c_void_p]
        lib.wrt_bvh_num_nodes.restype = c.c_int64
        lib.wrt_bvh_num_nodes.argtypes = [c.c_void_p]
        lib.wrt_bvh_copy.restype = None
        lib.wrt_bvh_copy.argtypes = [c.c_void_p, fp, fp, ip, ip, ip, ip]
        _lib = lib
        return _lib


def parse_obj_native(path: str):
    """Native OBJ parse → :class:`.obj.ObjFile`, or None when the library
    is unavailable or the file cannot be read."""
    from .obj import ObjFile, ObjModel

    lib = get_lib()
    if lib is None:
        return None
    h = lib.wrt_obj_parse(os.fsencode(path))
    if not h:
        return None
    try:
        nv = lib.wrt_obj_num_vertices(h)
        nn = lib.wrt_obj_num_normals(h)
        nt = lib.wrt_obj_num_texcoords(h)
        vertices = np.empty((nv, 3), np.float32)
        normals = np.empty((nn, 3), np.float32)
        texcoords = np.empty((nt, 3), np.float32)
        if nv:
            lib.wrt_obj_copy_vertices(h, vertices.reshape(-1))
        if nn:
            lib.wrt_obj_copy_normals(h, normals.reshape(-1))
        if nt:
            lib.wrt_obj_copy_texcoords(h, texcoords.reshape(-1))
        mat_names: List[str] = [
            lib.wrt_obj_material_name(h, i).decode()
            for i in range(lib.wrt_obj_num_materials(h))
        ]
        models = []
        for m in range(lib.wrt_obj_num_models(h)):
            f = lib.wrt_obj_model_num_faces(h, m)
            v_idx = np.empty((f * 3,), np.int32)
            n_idx = np.empty((f * 3,), np.int32)
            t_idx = np.empty((f * 3,), np.int32)
            mat_id = np.empty((f,), np.int32)
            if f:
                lib.wrt_obj_model_copy(h, m, v_idx, n_idx, t_idx, mat_id)
            models.append(
                ObjModel(
                    name=lib.wrt_obj_model_name(h, m).decode(),
                    vertex_idx=v_idx.reshape(-1, 3),
                    normal_idx=n_idx.reshape(-1, 3),
                    texcoord_idx=t_idx.reshape(-1, 3),
                    material=[mat_names[i] if i >= 0 else ""
                              for i in mat_id.tolist()],
                )
            )
        return ObjFile(
            vertices=vertices, normals=normals, texcoords=texcoords,
            models=models,
        )
    finally:
        lib.wrt_obj_free(h)


def build_bvh_native(faces):
    """Native BVH build → :class:`.bvh.BVH`, or None when the library is
    unavailable."""
    from .bvh import BVH

    lib = get_lib()
    if lib is None:
        return None
    p0 = np.ascontiguousarray(faces.p0, np.float32)
    e1 = np.ascontiguousarray(faces.e1, np.float32)
    e2 = np.ascontiguousarray(faces.e2, np.float32)
    h = lib.wrt_bvh_build(p0.reshape(-1), e1.reshape(-1), e2.reshape(-1),
                          len(faces))
    if not h:
        return None
    try:
        n = lib.wrt_bvh_num_nodes(h)
        node_min = np.empty((n, 3), np.float32)
        node_max = np.empty((n, 3), np.float32)
        right = np.empty((n,), np.int32)
        face0 = np.empty((n,), np.int32)
        face1 = np.empty((n,), np.int32)
        skip = np.empty((n,), np.int32)
        if n:
            lib.wrt_bvh_copy(h, node_min.reshape(-1), node_max.reshape(-1),
                             right, face0, face1, skip)
        return BVH(node_min=node_min, node_max=node_max, right_idx=right,
                   face0=face0, face1=face1, skip=skip)
    finally:
        lib.wrt_bvh_free(h)
