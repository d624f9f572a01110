"""webgpu_raytracing_tpu_torch — the PyTorch/CUDA port of
``webgpu_raytracing_tpu`` for NVIDIA Hopper GPUs.

Module names mirror the JAX package's. Plain tensor code is PyTorch; the
cluster traces, Pallas kernels in the JAX package, are hand-written CUDA
kernels (``csrc/cluster_trace.cu``, bound in ``ops/cluster_cuda.py``) with
plain-torch twins that CPU tensors use; so are camera rays
(``csrc/raygen.cu``, ``ops/raygen.py``) and a path segment's shading
(``csrc/shade.cu``, ``ops/integrator.py``). This package never imports
JAX.
The names below load their modules on first use, so that importing the
package stays cheap.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    BlitView,
    FovOrientation,
    LensShape,
    ProjectionType,
    RenderSettings,
    ShadingType,
    Tonemapping,
)

_LAZY = {
    "Camera": ("webgpu_raytracing_tpu_torch.camera", "Camera"),
    "Controls": ("webgpu_raytracing_tpu_torch.camera", "Controls"),
    "orbit_path": ("webgpu_raytracing_tpu_torch.camera", "orbit_path"),
    "Scene": ("webgpu_raytracing_tpu_torch.models.scene", "Scene"),
    "load_scene": ("webgpu_raytracing_tpu_torch.models.scene", "load_scene"),
    "scene_from_facesets": (
        "webgpu_raytracing_tpu_torch.models.scene", "scene_from_facesets"
    ),
    "FrameBuffers": ("webgpu_raytracing_tpu_torch.renderer", "FrameBuffers"),
    "FrameInputs": ("webgpu_raytracing_tpu_torch.renderer", "FrameInputs"),
    "Renderer": ("webgpu_raytracing_tpu_torch.renderer", "Renderer"),
    "render_frame": ("webgpu_raytracing_tpu_torch.renderer", "render_frame"),
}


def __getattr__(name):  # PEP 562
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)


__all__ = [
    "Renderer",
    "render_frame",
    "FrameBuffers",
    "FrameInputs",
    "Scene",
    "load_scene",
    "scene_from_facesets",
    "Camera",
    "Controls",
    "orbit_path",
    "RenderSettings",
    "ShadingType",
    "ProjectionType",
    "FovOrientation",
    "LensShape",
    "Tonemapping",
    "BlitView",
]
