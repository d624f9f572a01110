"""The stress scene: a grid of UV spheres of random size, colour and
place, one emissive sphere as model 0, and a floor (the port's
``models/stress.py``, copied). The layout is drawn from ``layout_seed``,
which the configuration fixes, and not from the run's seed: every run
renders the same scene, so that runs of different seeds do the same
work (the run's seed draws the frames' samples)."""

from __future__ import annotations

import numpy as np

from scenes._mesh import ground_plane, uv_sphere


def generate(seed: int, n_triangles: int, layout_seed: int):
    del seed
    rng = np.random.default_rng(layout_seed)
    lat, lon = 24, 48
    tris_per_sphere = 2 * lat * lon - 2 * lon
    n_spheres = max(1, (n_triangles - 2) // tris_per_sphere)
    side = int(np.ceil(np.sqrt(n_spheres)))

    mats_color = [(0.0, 0.0, 0.0)]
    mats_emission = [(8.0, 8.0, 8.0)]
    models = [("light", uv_sphere((0.0, float(side) + 4.0, 0.0), 1.5,
                                  material_idx=0, lat=8, lon=12))]
    k = 0
    for i in range(side):
        for j in range(side):
            if k >= n_spheres:
                break
            mats_color.append(tuple(rng.uniform(0.2, 0.9, 3)))
            mats_emission.append((0.0, 0.0, 0.0))
            center = (
                (i - side / 2) * 2.5 + rng.uniform(-0.3, 0.3),
                rng.uniform(0.8, 1.6),
                (j - side / 2) * 2.5 + rng.uniform(-0.3, 0.3),
            )
            models.append((f"sphere_{k}", uv_sphere(
                center, rng.uniform(0.5, 1.0),
                material_idx=len(mats_color) - 1, lat=lat, lon=lon)))
            k += 1
    mats_color.append((0.7, 0.7, 0.7))
    mats_emission.append((0.0, 0.0, 0.0))
    models.append(("floor", ground_plane(0.0, side * 2.0,
                                         material_idx=len(mats_color) - 1)))
    return (models, np.array(mats_color, np.float32),
            np.array(mats_emission, np.float32))
