"""BVH build (host, vectorized numpy) + skip-link threading for TPU.

Logical structure matches the reference builder (bv.ts:66-148): recursive
median split along the largest AABB axis, preorder node layout (left child
implicitly at ``index + 1``, explicit ``right_idx``), leaves hold up to two
face indices with ``-1`` sentinels, AABBs padded by ``BV_MIN_DELTA = 0.01``
per degenerate axis (bv.ts:13, 54-61).

TPU-native addition: after the build, every node gets a *skip link* (the
next preorder node when this subtree is rejected). This threads the tree so
device traversal needs **no per-ray stack** — one uniform loop
``idx = hit ? idx + 1 : skip[idx]`` that vectorizes cleanly over a ray
batch, replacing the divergent stack walk of the WGSL kernel
(render.ts:555-638). The split key replicates the reference quirk of
averaging the *stored* point slots ``(p0 + e1 + e2) / 3`` (bv.ts:80-86 sums
``points[i].position`` which hold p0/e1/e2), not the true centroid; tree
shape has no effect on the image, only on traversal order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .face import FaceSet

BV_MIN_DELTA = 0.01


@dataclasses.dataclass
class BVH:
    """Flat preorder BVH over one model's faces (indices are model-local)."""

    node_min: np.ndarray  # (N, 3) float32
    node_max: np.ndarray  # (N, 3) float32
    right_idx: np.ndarray  # (N,) int32, -1 for leaves
    face0: np.ndarray  # (N,) int32, -1 unless leaf
    face1: np.ndarray  # (N,) int32, -1 unless 2-face leaf
    skip: np.ndarray  # (N,) int32, node to jump to on miss; == N at the root

    def __len__(self) -> int:
        return self.node_min.shape[0]


def _aabbs_of(faces: FaceSet) -> tuple:
    """Per-face AABB over the three reconstructed vertices (bv.ts:41-51)."""
    v0 = faces.p0
    v1 = faces.p0 + faces.e1
    v2 = faces.p0 + faces.e2
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    return lo, hi


def build_bvh(faces: FaceSet) -> BVH:
    """Build a BVH, preferring the native C++ builder (runtime/loader.cpp,
    models/native.py), which produces byte-identical trees; the numpy
    builder when the library is unavailable or ``WRT_NO_NATIVE`` is set."""
    from .native import build_bvh_native

    bvh = build_bvh_native(faces)
    return build_bvh_python(faces) if bvh is None else bvh


def build_bvh_python(faces: FaceSet) -> BVH:
    f = len(faces)
    if f == 0:
        return BVH(
            *(np.zeros((0, 3), np.float32),) * 2,
            *(np.zeros((0,), np.int32),) * 4,
        )

    lo, hi = _aabbs_of(faces)
    # Split key: mean of the stored point slots (p0 + e1 + e2) / 3, matching
    # bv.ts:80-86 which reads positions that actually hold p0/e1/e2.
    key = (faces.p0 + faces.e1 + faces.e2) / 3.0

    node_min: list = []
    node_max: list = []
    right_idx: list = []
    face0: list = []
    face1: list = []

    # Iterative preorder: stack entries are (face_index_array, parent_node)
    # where parent_node's right_idx is set when the entry is popped (-1 for
    # left children / the root). LIFO order emits the entire left subtree
    # before the right, giving the implicit left-child-at-index+1 layout.
    stack = [(np.arange(f, dtype=np.int64), -1)]
    while stack:
        idxs, parent = stack.pop()
        node = len(node_min)
        if parent >= 0:
            right_idx[parent] = node

        bmin = lo[idxs].min(axis=0)
        bmax = hi[idxs].max(axis=0)
        # pad degenerate axes (bv.ts:54-61)
        thin = (bmax - bmin) < BV_MIN_DELTA
        bmax = bmax + thin.astype(np.float32) * BV_MIN_DELTA

        node_min.append(bmin)
        node_max.append(bmax)
        right_idx.append(-1)

        if idxs.shape[0] <= 2:
            face0.append(idxs[0] if idxs.shape[0] >= 1 else -1)
            face1.append(idxs[1] if idxs.shape[0] >= 2 else -1)
            continue
        face0.append(-1)
        face1.append(-1)

        axis = int(np.argmax(bmax - bmin))
        order = np.argsort(key[idxs, axis], kind="stable")
        sorted_idxs = idxs[order]
        mid = sorted_idxs.shape[0] // 2
        # push right first so left pops (and is emitted) first
        stack.append((sorted_idxs[mid:], node))
        stack.append((sorted_idxs[:mid], -1))

    n = len(node_min)
    right = np.array(right_idx, dtype=np.int32)
    skip = np.full((n,), n, dtype=np.int32)
    # Preorder parents precede children, so one forward pass threads the tree:
    # left child's miss target is the right sibling; right child inherits the
    # parent's miss target.
    for i in range(n):
        r = right[i]
        if r >= 0:
            skip[i + 1] = r
            skip[r] = skip[i]

    return BVH(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        right_idx=right,
        face0=np.array(face0, dtype=np.int32),
        face1=np.array(face1, dtype=np.int32),
        skip=skip,
    )


def validate_bvh(bvh: BVH, faces: FaceSet) -> None:
    """Structural invariants (the test oracle the reference never had):
    preorder layout, child containment, full leaf coverage, valid threading.
    """
    n = len(bvh)
    f = len(faces)
    lo, hi = _aabbs_of(faces)
    seen = np.zeros(f, dtype=bool)
    eps = 1e-5

    for i in range(n):
        r = int(bvh.right_idx[i])
        is_leaf = r < 0
        if is_leaf:
            for fi in (int(bvh.face0[i]), int(bvh.face1[i])):
                if fi < 0:
                    continue
                assert not seen[fi], f"face {fi} in two leaves"
                seen[fi] = True
                assert np.all(lo[fi] >= bvh.node_min[i] - eps)
                assert np.all(hi[fi] <= bvh.node_max[i] + eps)
        else:
            left = i + 1
            assert left < n and 0 <= r < n
            # BV_MIN_DELTA slack: a thin child is padded (+0.01 on max) and
            # may legitimately poke out of an unpadded parent — true of the
            # reference's trees as well (bv.ts:54-61).
            pad = BV_MIN_DELTA + eps
            for c in (left, r):
                assert np.all(bvh.node_min[c] >= bvh.node_min[i] - pad)
                assert np.all(bvh.node_max[c] <= bvh.node_max[i] + pad)
        s = int(bvh.skip[i])
        assert i < s <= n, f"skip link at {i} must move forward"

    assert seen.all() or f == 0, "every face must be covered by a leaf"
