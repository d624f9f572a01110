"""The camera of every frame of a run, counted from the first warm-up
frame.

A configuration file may carry ``camera_path``, an orbit as the port's
``cli orbit`` flies it (BASELINE config #4):

    "camera_path": {"center": [x, y, z], "radius": r, "height": h,
                    "poses": n, "frames_per_pose": k}

Frame f stands at pose (f // k) mod n; pose j circles ``center`` at the
angle 2 pi j / n, ``height`` above it, and faces it. Without it the
configuration's static ``camera`` serves every frame. The orbit's
geometry is a copy of the port's (``camera.orbit_path``,
``utils/mathx.quat_rotation_to``) in the same float64 steps and float32
roundings, so that the harness hands the program the poses that the
port's own orbit would.
"""

from __future__ import annotations

import numpy as np

from reference import view_matrix


def _normalize(v):
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    if n == 0:
        return np.zeros_like(v).astype(np.float32)
    return (v / n).astype(np.float32)


def _rotation_to(a, b):
    """gl-matrix quat.rotationTo: the shortest rotation taking the unit
    vector a onto b, float32 [x, y, z, w]."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = float(np.dot(a, b))
    if d < -0.999999:
        axis = np.cross([1.0, 0.0, 0.0], a)
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross([0.0, 1.0, 0.0], a)
        axis = (axis / np.linalg.norm(axis)).astype(np.float32)
        s = np.sin(np.pi * 0.5)
        return np.array([axis[0] * s, axis[1] * s, axis[2] * s,
                         np.cos(np.pi * 0.5)], dtype=np.float32)
    if d > 0.999999:
        return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)
    axis = np.cross(a, b)
    q = np.array([axis[0], axis[1], axis[2], 1.0 + d], dtype=np.float64)
    n = np.linalg.norm(q)
    if n == 0:
        return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)
    return (q / n).astype(np.float32)


def orbit_pose(center, radius, height, j, poses):
    """Pose j of an orbit of ``poses`` poses → (position, orientation),
    float32: the view translates by -position, so the camera's world
    origin is -position, and the orientation turns the camera's -z onto
    the direction to ``center``."""
    center = np.asarray(center, dtype=np.float32)
    ang = 2.0 * np.pi * j / max(poses, 1)
    world = center + np.array(
        [radius * np.sin(ang), height, radius * np.cos(ang)],
        dtype=np.float32)
    look = _normalize(center - world)
    forward = np.array([0.0, 0.0, -1.0], dtype=np.float32)
    return -world, _rotation_to(forward, look)


class CameraPath:
    """The pose of each frame of a configuration."""

    def __init__(self, config: dict):
        self.orbit = config.get("camera_path")
        if self.orbit is None:
            cam = config["camera"]
            self.static = (np.asarray(cam["position"], np.float32),
                           np.asarray(cam["orientation"], np.float32))

    def pose_index(self, frame: int) -> int:
        if self.orbit is None:
            return 0
        return (frame // self.orbit["frames_per_pose"]) % self.orbit["poses"]

    def pose(self, frame: int):
        """(position, orientation) of the frame, float32."""
        if self.orbit is None:
            return self.static
        o = self.orbit
        return orbit_pose(o["center"], o["radius"], o["height"],
                          self.pose_index(frame), o["poses"])

    def moves_before(self, frame: int) -> bool:
        """Whether the camera moves between frame - 1 and frame."""
        return frame > 0 and (self.pose_index(frame)
                              != self.pose_index(frame - 1))

    def view(self, frame: int) -> np.ndarray:
        """The frame's view matrix, as the reference is given it."""
        return view_matrix(*self.pose(frame))
