"""Host-side quaternion / matrix math (numpy, float32).

The reference uses gl-matrix for camera math (store.ts:104-188). gl-matrix
stores matrices column-major and applies them as ``M * v``; here matrices
are numpy ``(4, 4)`` row-major arrays applied as ``M @ v`` — the same
transform, just the standard numpy convention. Quaternions are ``[x, y, z,
w]`` like gl-matrix.
"""

from __future__ import annotations

import numpy as np


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """gl-matrix quat.setAxisAngle (axis must be normalized)."""
    half = angle * 0.5
    s = np.sin(half)
    return np.array(
        [axis[0] * s, axis[1] * s, axis[2] * s, np.cos(half)], dtype=np.float32
    )


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = np.asarray(a, dtype=np.float64)
    bx, by, bz, bw = np.asarray(b, dtype=np.float64)
    return np.array(
        [
            ax * bw + aw * bx + ay * bz - az * by,
            ay * bw + aw * by + az * bx - ax * bz,
            az * bw + aw * bz + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float32,
    )


def quat_normalize(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    n = np.linalg.norm(q)
    if n == 0:
        return quat_identity()
    return (q / n).astype(np.float32)


def quat_rotation_to(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """gl-matrix quat.rotationTo: shortest rotation taking unit vector a to b."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = float(np.dot(a, b))
    if d < -0.999999:
        axis = np.cross([1.0, 0.0, 0.0], a)
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross([0.0, 1.0, 0.0], a)
        axis = axis / np.linalg.norm(axis)
        return quat_from_axis_angle(axis.astype(np.float32), np.pi)
    if d > 0.999999:
        return quat_identity()
    axis = np.cross(a, b)
    q = np.array([axis[0], axis[1], axis[2], 1.0 + d], dtype=np.float64)
    return quat_normalize(q)


def quat_rotate_vec3(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """gl-matrix vec3.transformQuat."""
    q = np.asarray(q, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    u = q[:3]
    w = q[3]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return (v + 2.0 * (w * uv + uuv)).astype(np.float32)


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def mat4_from_quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, dtype=np.float64)
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    m = np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy, 0],
            [xy + wz, 1 - (xx + zz), yz - wx, 0],
            [xz - wy, yz + wx, 1 - (xx + yy), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    return m.astype(np.float32)


def mat4_from_rotation_translation(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """gl-matrix mat4.fromRotationTranslation: rotate by q, then translate by t."""
    m = mat4_from_quat(q)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def mat4_invert(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=np.float64)).astype(np.float32)


def mat4_perspective_zo(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """gl-matrix mat4.perspectiveZO (clip z in [0, 1]); used for the debug
    BVH wireframe projection (store.ts:115-127)."""
    f = 1.0 / np.tan(fovy / 2.0)
    nf = 1.0 / (near - far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far * nf
    m[2, 3] = far * near * nf
    m[3, 2] = -1.0
    return m.astype(np.float32)


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    v = m @ np.array([p[0], p[1], p[2], 1.0], dtype=np.float32)
    return v[:3]


def transform_dir(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    v = m @ np.array([d[0], d[1], d[2], 0.0], dtype=np.float32)
    return v[:3]


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    if n == 0:
        return np.zeros_like(v).astype(np.float32)
    return (v / n).astype(np.float32)


def clamp(x, lo, hi):
    """utils.ts clamp."""
    return max(lo, min(hi, x))


def lerp(a, b, t):
    """utils.ts lerp."""
    return a * (1.0 - t) + b * t
