"""Camera state + controls.

Mirrors the reference's camera subsystem: the world basis constants
(camera.ts:3-5: right=(-1,0,0), up=(0,-1,0), front=(0,0,1)), the view
matrix derivation (store.ts:104-113: ``fromRotationTranslation(orientation,
-position)``), and the pointer-lock control semantics — ``rotateCamera``
builds yaw-around-world-up × pitch-around-camera-right with roll correction
(store.ts:295-321), ``move`` translates in the ground-plane-projected
camera basis (store.ts:323-344).

Every mutating method returns True when the camera changed — callers use
that to reset progressive accumulation, the reference's
``resetCounter()`` policy (store.ts:318-320, 340-343).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .utils import mathx as mx

RIGHT = np.array([-1.0, 0.0, 0.0], dtype=np.float32)
UP = np.array([0.0, -1.0, 0.0], dtype=np.float32)
FRONT = np.array([0.0, 0.0, 1.0], dtype=np.float32)


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    orientation: np.ndarray = dataclasses.field(
        default_factory=mx.quat_identity
    )

    def view_matrix(self) -> np.ndarray:
        """store.ts:104-113."""
        return mx.mat4_from_rotation_translation(
            self.orientation, -self.position
        )

    def view_projection_matrix(self, width: int, height: int, fov: float):
        """store.ts:115-127 — used by the debug BVH wireframe."""
        r = width / height
        d = np.tan(fov / 2.0)
        proj = mx.mat4_perspective_zo(2.0 * np.arctan(d / r), r, 0.1, 1000.0)
        return proj @ mx.mat4_invert(self.view_matrix())

    def rotate(self, d: np.ndarray) -> bool:
        """rotateCamera (store.ts:295-321); d = (yaw, pitch) deltas."""
        orientation = self.orientation.copy()
        right = mx.quat_rotate_vec3(orientation, RIGHT)

        mv_right = np.array([right[0], 0.0, right[2]], dtype=np.float32)
        q_x = mx.quat_from_axis_angle(UP, float(d[0]))
        q_y = mx.quat_from_axis_angle(right, float(d[1]))
        q_z = mx.quat_rotation_to(right, mv_right)

        orientation = mx.quat_mul(q_x, orientation)
        orientation = mx.quat_mul(q_y, orientation)
        orientation = mx.quat_mul(q_z, orientation)

        if np.array_equal(orientation, self.orientation):
            return False
        self.orientation = orientation
        return True

    def move(self, d: np.ndarray) -> bool:
        """move (store.ts:323-344); d in (right, up, front) amounts."""
        mv_up = UP.copy()
        mv_right = mx.quat_rotate_vec3(self.orientation, RIGHT)
        mv_right[1] = 0.0
        mv_front = mx.quat_rotate_vec3(self.orientation, FRONT)
        mv_front[1] = 0.0

        basis = np.stack([mv_right, mv_up, mv_front], axis=1)  # columns
        delta = basis @ np.asarray(d, dtype=np.float32)
        position = self.position + delta
        if np.array_equal(position, self.position):
            return False
        self.position = position
        return True


def orbit_path(
    center: np.ndarray,
    radius: float,
    height: float,
    n_frames: int,
):
    """Scripted camera orbit (BASELINE config #4): yields a Camera per
    frame, circling `center` and facing it."""
    center = np.asarray(center, dtype=np.float32)
    for k in range(n_frames):
        ang = 2.0 * np.pi * k / max(n_frames, 1)
        world_pos = center + np.array(
            [radius * np.sin(ang), height, radius * np.cos(ang)],
            dtype=np.float32,
        )
        # the view matrix translates by -position (store.ts:104-113), so
        # the camera's WORLD origin is -position
        cam = Camera(position=-world_pos)
        # orientation maps camera space → world; the camera looks down
        # its -z (raygen), so rotate (0,0,-1) onto the look direction
        look = mx.normalize(center - world_pos)
        fwd = np.array([0.0, 0.0, -1.0], dtype=np.float32)
        cam.orientation = mx.quat_rotation_to(fwd, look)
        yield cam


class Controls:
    """Keyboard/pointer state → camera motion (controls.ts:1-107).

    The reference assembles a per-frame move vector from held keys with a
    Shift run-multiplier (controls.ts:76-107) and converts pointer deltas
    to rotation scaled by dt·sensitivity (controls.ts:51-58). This is the
    headless equivalent: feed key presses/releases and pointer deltas,
    call :meth:`update` once per frame."""

    FORWARD = {"w", "ArrowUp"}
    BACK = {"s", "ArrowDown"}
    LEFT = {"a", "ArrowLeft"}
    RIGHT = {"d", "ArrowRight"}
    UP = {" ", "Space"}
    DOWN = {"Control", "c"}
    RUN = {"Shift"}

    def __init__(self, camera: Camera, sensitivity: float = 0.03,
                 speed: float = 2.0, run_speed: float = 5.0,
                 scale: float = 1.0):
        self.camera = camera
        self.sensitivity = sensitivity
        self.speed = speed
        self.run_speed = run_speed
        # store.scale (store.ts:78): look-sensitivity divisor, exposed in
        # the reference UI panel (UI.tsx:170-176)
        self.scale = scale
        self.keys: set = set()

    # key tracking (store.ts:346-359)
    def press(self, key: str) -> None:
        self.keys.add(key)

    def release(self, key: str) -> None:
        self.keys.discard(key)

    def release_all(self) -> None:  # blur releases lock (controls.ts:72-74)
        self.keys.clear()

    def pointer(self, dx: float, dy: float, dt: float) -> bool:
        """mousemove → rotateCamera(d · dt · sensitivity / scale)
        (controls.ts:51-58). Returns True if the camera changed."""
        d = (
            np.array([dx, dy], np.float32)
            * (dt * self.sensitivity / max(self.scale, 1e-9))
        )
        return self.camera.rotate(d)

    def update(self, dt: float) -> bool:
        """handleControls() (controls.ts:76-107): assemble the move vector
        from held keys; Shift multiplies speed. Returns True on motion."""
        def held(ks):
            return any(k in self.keys for k in ks)

        v = np.zeros(3, np.float32)
        if held(self.FORWARD):
            v[2] += 1.0
        if held(self.BACK):
            v[2] -= 1.0
        if held(self.RIGHT):
            v[0] += 1.0
        if held(self.LEFT):
            v[0] -= 1.0
        if held(self.UP):
            v[1] -= 1.0
        if held(self.DOWN):
            v[1] += 1.0
        if not v.any():
            return False
        speed = self.run_speed if held(self.RUN) else self.speed
        v = v / np.linalg.norm(v) * speed * dt
        return self.camera.move(v)
