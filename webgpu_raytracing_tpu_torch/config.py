"""Render configuration (counterpart of ``webgpu_raytracing_tpu.config``).

:class:`RenderSettings` keeps the JAX package's fields with the same
defaults, so a settings object means the same render in both packages.
PyTorch runs eagerly, so nothing here is "static" in the jit sense: the
settings simply select code paths in :mod:`.renderer` and
:mod:`.ops.integrator`.

The tile-scheduling settings select hand-written kernels of
``csrc/cluster_trace.cu``: ``kernel_near`` (the tile entry distances and
the box order are computed inside the kernel: K2n over the clusters of
single-level tables, K3 / K3p over the superclusters of two-level ones),
``trace_sched`` (0, or 1, 2, 4, 8: K5, closest-hit legs in rounds of that
many clusters) and ``pipeline_rounds`` (K2pl: the next cluster is fetched
while the current one is tested); the last two are single-level only and
raise with two-level tables. All three return the same results as K1 / K3
over an order sorted outside the kernel. ``kernel_near`` is an argument of
the JAX dispatcher (``trace_closest_clustered_pallas``), off by default and
single-level only there, and not a field of its settings; it is a field
here (PORT_ONLY_FIELDS), and ON by default (DEFAULT_DEVIATIONS): with it
off every trace leg pays a dense plain-torch pass over all ray-box pairs
and a sort before its kernel. ``kernel_near=False`` keeps that outside
route (K1 / K3 over ``tile_nears_fused`` and ``torch.sort``), which
``multipass_cap`` needs, since only K1 can cap a walk.

``sort_bounce_rays`` and ``live_slice`` are the JAX fields: bounce and
shadow legs of segments past the first are traced in nearest-cluster order
(ops/ray_sort.py), later segments on a leading slice of the sorted rays.
The sort is a pure reordering with identical results; DEFAULT_DEVIATIONS
lists the fields whose default here differs from the JAX package's, with
the reason.

``binned_sort``, ``binned_any_sort``, ``multipass_cap`` and
``multipass_passes`` are the JAX fields too, with its defaults (all off):
on sorted legs of single-level tables, the per-ray-scheduled traces of
ops/ray_sort.py. ``binned_sort``: closest-hit legs run each ray's nearest
cluster, then the second nearest, through K4 (``wrt_trace_binned``) and
only the survivors through the drain kernel; shadow legs too, and those
alone with ``binned_any_sort``. ``multipass_cap`` > 0: closest-hit legs run
at most that many clusters per tile, and the survivors are regrouped and
traced again, ``multipass_passes`` passes in all. Each returns the plain
sorted trace's results; on two-level tables, on exact-pairs legs, and for
``multipass_cap`` with a kernel that takes no cap (``trace_sched``,
``kernel_near``, ``pipeline_rounds``) the plain sorted trace runs instead,
as in the JAX package: ``multipass_cap`` takes effect only with
``kernel_near=False``.

``traversal`` takes the JAX package's five values (TRAVERSALS):
``"auto"`` launches the CUDA kernels for CUDA tensors and runs their plain
twins for CPU tensors; ``"pallas"`` launches the kernels and raises
``ValueError`` for tensors that are not on a CUDA device; ``"pallas_interpret"``
runs the twins on whatever device the tensors are on (the port's
interpret mode); ``"clustered"`` and ``"threaded"`` are the plain-torch
oracles of ops/cluster_trace.py and ops/traverse.py, which share no code
with the kernels. The tile-scheduling settings above pick among the
kernels and their twins only. ``"threaded"`` legs are never sorted;
``"clustered"`` legs are, with ``sort_bounce_rays``.

``chained_sort`` (the JAX field and default, off) permutes the whole
per-lane path state into nearest-cluster order once per segment past the
first instead of sorting each trace (ops/integrator.py); it applies only
with ``sort_bounce_rays`` and a traversal other than ``"threaded"``, and
gives the same frame bit for bit.

Fields of the JAX ``RenderSettings`` left out of this one (OMITTED_FIELDS):
the TPU kernel schedule knobs, which change how the Pallas kernel runs and
never what it returns: ``tiles_per_step``, ``lockstep_tiles``,
``trace_gang``, ``trace_gang_frac``, ``mm_passes`` and ``approx_div``.

Values the port does not take raise ``ValueError`` (see
:func:`check_supported`); none falls back to another path.
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
        "approx_div",
    }
)
# Fields with no counterpart in the JAX RenderSettings (module docstring).
PORT_ONLY_FIELDS = frozenset({"kernel_near"})
# Fields whose default differs from the JAX package's → the reason.
DEFAULT_DEVIATIONS = {
    "sort_bounce_rays": (
        "the sorted frame is slower than the unsorted one: on an H100 "
        "the benchmark's stress1m_4k.sorted cell (config #5 at 4K, sort "
        "and live slice on) renders 94.5 Mrays/s against 104.0 for the "
        "unsorted stress1m_4k.path; the sorted, sliced legs cut the trace "
        "kernels from 119.8 to 97.2 ms a frame, but the key kernel (8.3 "
        "ms), the sort, gathers and unsort (9.7 ms in 1,664 launches) and "
        "one host read of a count per sorted leg cost more (PERF.md)"
    ),
    "kernel_near": (
        "not a JAX setting (PORT_ONLY_FIELDS; the JAX dispatcher's argument "
        "defaults to False): outside the kernel the tile entry distances "
        "and the sort are 134 ms of plain torch per 1080p leg, inside it a "
        "few ms (PERF.md)"
    ),
}
# ``trace_sched``: 0 (K1) or the clusters per round of K5
TRACE_SCHED_VALUES = (0, 1, 2, 4, 8)
# ``traversal`` (module docstring)
TRAVERSALS = ("auto", "pallas", "pallas_interpret", "clustered", "threaded")


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
    # one of TRAVERSALS (module docstring)
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
    # the tile-scheduling kernels (module docstring): the box order is made
    # inside the kernel by default; the other two are off
    trace_sched: int = 0
    pipeline_rounds: bool = False
    kernel_near: bool = True
    # the ray sort of bounce and shadow legs (ops/ray_sort.py)
    sort_bounce_rays: bool = False  # JAX: True (DEFAULT_DEVIATIONS)
    live_slice: bool = True
    chained_sort: bool = False
    # the per-ray-scheduled sorted traces (module docstring); all off
    multipass_cap: int = 0
    multipass_passes: int = 2
    binned_sort: bool = False
    binned_any_sort: bool = False

    @property
    def reproject(self) -> bool:
        return self.reprojection_rate > 0

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


def check_supported(settings: RenderSettings) -> None:
    """Raise ``ValueError`` for a ``traversal`` outside TRAVERSALS and for
    a ``trace_sched`` that K5 does not take. ``trace_sched`` and
    ``pipeline_rounds`` with two-level tables raise where the tables are
    known (ops/cluster_cuda.py ``prepare_tiles``), and ``"pallas"`` where
    the tensors are (the kernel wrappers)."""
    if settings.traversal not in TRAVERSALS:
        raise ValueError(
            f"traversal must be one of {TRAVERSALS}, got "
            f"{settings.traversal!r}"
        )
    if settings.trace_sched not in TRACE_SCHED_VALUES:
        raise ValueError(
            f"trace_sched must be one of {TRACE_SCHED_VALUES}, got "
            f"{settings.trace_sched}"
        )
    if settings.multipass_cap < 0 or settings.multipass_passes < 2:
        raise ValueError(
            "multipass_cap must be >= 0 and multipass_passes >= 2, got "
            f"{settings.multipass_cap} and {settings.multipass_passes}"
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
