"""webgpu_raytracing_tpu_torch — the PyTorch/CUDA port of
``webgpu_raytracing_tpu`` for one NVIDIA Hopper GPU.

Module names mirror the JAX package's. Plain tensor code is PyTorch; the
closest-hit cluster trace, a Pallas kernel in the JAX package, is a
hand-written CUDA kernel (``csrc/cluster_trace.cu``, bound in
``ops/cluster_cuda.py``) with a plain-torch twin that CPU tensors use.
This package never imports JAX.
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
