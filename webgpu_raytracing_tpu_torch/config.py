"""Render configuration (counterpart of ``webgpu_raytracing_tpu.config``).

:class:`RenderSettings` keeps the JAX package's fields with the same
defaults, so a settings object means the same render in both packages.
PyTorch runs eagerly, so nothing here is "static" in the jit sense: the
settings simply select code paths in :mod:`.renderer` and
:mod:`.ops.integrator`.

Fields of the JAX ``RenderSettings`` left out of this one:

* the TPU kernel schedule knobs, which change how the Pallas kernel runs
  and never what it returns: ``tiles_per_step``, ``lockstep_tiles``,
  ``trace_gang``, ``trace_gang_frac``, ``mm_passes``,
  ``pipeline_rounds``, ``trace_sched``, ``multipass_cap``,
  ``multipass_passes``, ``binned_sort``, ``binned_any_sort`` and
  ``approx_div``;
* the result-neutral ray-sort knobs ``sort_bounce_rays``, ``live_slice``
  and ``chained_sort``: bounce legs are traced unsorted until the ray sort
  is ported.

Settings that this package does not implement yet raise
``NotImplementedError`` (see :func:`check_supported`); none falls back to
another path.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class ShadingType(enum.IntEnum):
    FLAT = 0
    PHONG = 1


class ProjectionType(enum.IntEnum):
    FISHEYE = 0
    PANINI = 1
    PERSPECTIVE = 2
    ORTHOGRAPHIC = 3


class FovOrientation(enum.IntEnum):
    HORIZONTAL = 0
    VERTICAL = 1
    DIAGONAL = 2


class LensShape(enum.IntEnum):
    CIRCLE = 0
    SQUARE = 1


class Tonemapping(enum.IntEnum):
    REINHARD = 0
    FILMIC = 1
    ACES = 2
    LOTTES = 3
    NONE = 4


class BlitView(enum.Enum):
    IMAGE = "image"
    PREV_IMAGE = "prevImage"
    DEPTH = "depth"
    PREV_DEPTH = "prevDepth"
    DEPTH_DELTA = "depthDelta"
    NORMALS = "normals"


# JAX RenderSettings fields with no counterpart here (module docstring).
OMITTED_FIELDS = frozenset(
    {
        "tiles_per_step",
        "lockstep_tiles",
        "trace_gang",
        "trace_gang_frac",
        "mm_passes",
        "pipeline_rounds",
        "trace_sched",
        "multipass_cap",
        "multipass_passes",
        "binned_sort",
        "binned_any_sort",
        "approx_div",
        "sort_bounce_rays",
        "live_slice",
        "chained_sort",
    }
)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render settings; defaults mirror the reference store (store.ts:46-102)
    exactly as the JAX package's do. See that class for each field's
    meaning."""

    width: int = 640
    height: int = 480
    resolution_scale: float = 1.0
    geometry_buffer_scale: float = 1.0
    bvh_max_depth: int = 16
    bvh_leaf_soft_max_size: int = 2

    @property
    def render_width(self) -> int:
        return max(1, round(self.width * self.resolution_scale))

    @property
    def render_height(self) -> int:
        return max(1, round(self.height * self.resolution_scale))

    @property
    def geo_height(self) -> int:
        return max(
            1,
            min(
                round(self.render_height * self.geometry_buffer_scale),
                self.render_height,
            ),
        )

    sample_count: int = 1
    bounces_depth: int = 4
    samples_per_point: int = 1
    samples_per_bounce: int = 1

    fov: float = math.pi * 2 / 3
    fov_orientation: FovOrientation = FovOrientation.HORIZONTAL
    focus_distance: float = 4.0
    circle_of_confusion: float = 0.0
    panini_distance: float = 1.0
    vertical_compression: float = 0.0
    projection_type: ProjectionType = ProjectionType.PANINI
    lens_shape: LensShape = LensShape.CIRCLE

    shading_type: ShadingType = ShadingType.PHONG
    tonemapping: Tonemapping = Tonemapping.NONE
    exposure: float = 2.0
    gamma: float = 1.0
    ambience: float = 0.1
    blit_view: BlitView = BlitView.IMAGE

    reprojection_rate: int = 0
    jitter_strength: float = 0.0
    bilateral_filter: bool = False

    debug_bvh: bool = False
    debug_reprojection: bool = False

    use_hit_predictor: bool = False
    # "auto" is the only traversal here: the cluster kernel's entries for
    # CUDA tensors, their plain torch twins for CPU tensors
    # (ops/cluster_cuda.py)
    traversal: str = "auto"
    # rays per tile of the cluster traces (one CUDA block per tile)
    trace_tile: int = 128
    exact_pairs: bool = False
    exact_pairs_bounce: bool = False
    frame_slabs: int = 1
    env_nee_depth: int = 0
    next_event_estimation: bool = False
    environment: str = "procedural"
    env_importance_sampling: bool = False

    @property
    def reproject(self) -> bool:
        return self.reprojection_rate > 0

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


def check_supported(settings: RenderSettings) -> None:
    """Raise ``NotImplementedError`` for settings this package does not
    implement yet (each is a later slice of the port)."""
    unsupported = {
        "reprojection_rate > 0": settings.reprojection_rate > 0,
        "use_hit_predictor": settings.use_hit_predictor,
        "debug_bvh": settings.debug_bvh,
        "resolution_scale != 1": settings.resolution_scale != 1.0,
        "geometry_buffer_scale != 1": settings.geometry_buffer_scale != 1.0,
        "traversal != 'auto'": settings.traversal != "auto",
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(bad)
        )


# WGSL shader constants (shaders/constants.ts:1-15).
PHI = 1.61803398874989484820459
SRT = 1.41421356237309504880169
PI = 3.14159265358979323846264
E = 2.71828182845904523536028
TWO_PI = 6.28318530717958647692528
INV_PI = 0.31830988618379067153776
EPSILON = 0.001
F32_MAX = 3.4028234663852886e38
F32_MIN = 2.0**-126
MIN_DIST = 0.0
MAX_DIST = F32_MAX
