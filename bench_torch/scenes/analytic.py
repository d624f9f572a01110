"""BASELINE config #1's scene: a light sphere, two spheres and a plane
(the port's ``frontend/cli.analytic_scene``, copied). Nothing is drawn
from the seed."""

from __future__ import annotations

import numpy as np

from scenes._mesh import ground_plane, uv_sphere


def generate(seed: int):
    del seed
    models = [
        ("light", uv_sphere((0, 6, -6), 1.0, material_idx=0, lat=8, lon=12)),
        ("sphere_a", uv_sphere((-1.4, 1.0, -6), 1.0, material_idx=1)),
        ("sphere_b", uv_sphere((1.4, 0.8, -7), 0.8, material_idx=2)),
        ("plane", ground_plane(0.0, 20.0, material_idx=3)),
    ]
    return (
        models,
        np.array([[0, 0, 0], [0.8, 0.3, 0.3], [0.3, 0.4, 0.8],
                  [0.7, 0.7, 0.7]], np.float32),
        np.array([[12, 12, 12], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                 np.float32),
    )
