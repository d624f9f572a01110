"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ctypes. The library
goes to ``build/kernels/libwrt_torch_<hash>.so`` beside the package (the
checkout's ``build/`` directory, ignored by git), named by a hash of the
sources (``*.cu`` and the ``*.cuh`` headers they include) and the flags,
so a changed source rebuilds and an unchanged one loads at once. The
build happens at first use, never at import.

Entry points (``csrc/cluster_trace.cu``): ``wrt_trace_closest`` and
``wrt_trace_any`` (single-level, K1), ``wrt_trace_closest_two_level`` and
``wrt_trace_any_two_level`` (two-level, K3), ``wrt_trace_pairs`` (K2p) and
``wrt_trace_pairs_two_level`` (K3p); ``wrt_trace_sched`` (K5, rounds of
``jblk`` clusters), ``wrt_trace_near_closest`` / ``_any`` / ``_pairs`` (K2n,
the tile entry distances inside the kernel) and
``wrt_trace_pipelined_closest`` / ``_any`` / ``_pairs`` (K2pl, the next
cluster fetched while the current one is tested);
``wrt_trace_near_closest_two_level`` / ``_any_`` / ``_pairs_two_level`` (K3
and K3p ordering their supers inside the kernel); ``wrt_trace_binned`` (K4,
the two scheduled clusters of each block of a sorted ray stream);
``wrt_top_keys`` (the ray sort's coherence key: the n nearest entered boxes
of each ray as packed int32 keys); and ``wrt_error_string``. In
``csrc/raygen.cu``: ``wrt_camera_rays`` (a sample's camera rays, one
thread a ray, with ``csrc/detmath.cuh``'s device functions). In
``csrc/shade.cu``: ``wrt_shade_hit`` and ``wrt_shade_bounce`` (a path
segment's shading, one thread a lane, with ``csrc/shade.cuh``). In
``csrc/rederive.cu``: ``wrt_rederive_uv`` (a closest-hit leg's exact t,
u and v from each ray's face, one thread a ray, with
``csrc/rederive.cuh``). In ``csrc/light.cu``: ``wrt_light_sample`` and
``wrt_light_add`` (a light sample of NEE on either side of its shadow
leg, one thread a lane, with ``csrc/light.cuh``). The
closest-hit entries of K1, K2pl and K2n and K4 take the code carried in
beside t_max (or null), K1's also the cap and the stop output, K2n's
closest-hit and any-hit entries the per-ray ``t_start``.
:func:`load` raises if the library lacks any of them.

Flags: ``--fmad=false`` keeps every product rounded before its add (the
reference's strict arithmetic); there is no ``--use_fast_math``, so
``/`` and ``sqrt`` stay IEEE-rounded. A missing or failing ``nvcc``
raises with its output.

The binding every kernel's Python entry is made of: :class:`Kernel` sends
CPU tensors to the plain twin and CUDA tensors to the launch function, and
counts the launches; :func:`check_args` checks a launch's tensors;
:func:`launch` calls an entry on the current stream of the current device
(:func:`check_current_device`) and raises on its error;
:func:`pointer_block` packs the tensors of an entry that takes an argument
struct.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from ..utils.timing import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of webgpu_raytracing_tpu_torch "
            "are built at first use and need the CUDA toolkit"
        )
    return path


def _sources(pattern: str = "*.cu"):
    return sorted(glob.glob(os.path.join(CSRC_DIR, pattern)))


def library_path(flags=None) -> str:
    """The library for the current sources, built with ``flags``
    (default NVCC_FLAGS)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS if flags is None
                                else flags).encode())
    for src in _sources("*.cu*"):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libwrt_torch_{h.hexdigest()[:16]}.so")


def build(flags=None) -> str:
    """Compile the kernels with ``flags`` (default NVCC_FLAGS) if the
    library for the current sources is missing; return its path. Builds
    with different flags may run at once (threads)."""
    flags = list(NVCC_FLAGS if flags is None else flags)
    so = library_path(flags)
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc, *flags, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def _entries():
    """Each entry symbol → (restype, argtypes)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [
        p, p, p, p,  # o, d, inv_d, t_max
        p, p, p, i,  # excl, snear, order, n_cols
        p, p, i, p,  # box, face_id, slots, tri
        f,  # eps2
    ]
    pairs_head = [
        p, p, p, p,  # a, inv_d, t_max, excl
        p, p, i, p,  # snear, order, n_cols, box
        p, i, p, f, f,  # face_id, slots, mat_b, eps2, margin
    ]
    pairs_out = [p] * 5  # t1, c1, c2, c3, amb
    tail = [i, i, p]  # n_tiles, tile, stream
    # K2n takes the number of boxes in place of snear, order, n_cols, and
    # the pipelined flag after its search's inputs
    near_head = head[:5] + [i] + head[8:] + [i]
    # K4 takes the block schedules in place of snear, order, n_cols
    binned_head = head[:5] + [p] + head[8:]
    near_pairs_head = pairs_head[:4] + [i] + pairs_head[7:] + [i]
    # K3 ordering its supers takes their number and boxes in that place
    near2_head = head[:5] + [i, p] + head[8:]
    near2_pairs_head = pairs_head[:4] + [i, p] + pairs_head[7:]
    return {
        # code0, cap, stop_out, t_out, code_out
        "wrt_trace_closest": (i, head + [p, i, p, p, p] + tail),
        # code0, t_out, code_out
        "wrt_trace_binned": (i, binned_head + [p, p, p] + tail),
        "wrt_trace_any": (i, head + [p] + tail),  # code_out
        # group, t_out, code_out
        "wrt_trace_closest_two_level": (i, head + [i, p, p] + tail),
        "wrt_trace_any_two_level": (i, head + [i, p] + tail),  # group, code
        "wrt_trace_pairs": (i, pairs_head + pairs_out + tail),
        "wrt_trace_pairs_two_level": (i, pairs_head + [i] + pairs_out + tail),
        "wrt_trace_sched": (i, head + [i, p, p] + tail),  # jblk, t, code
        # code0, t_out, code_out
        "wrt_trace_pipelined_closest": (i, head + [p, p, p] + tail),
        "wrt_trace_pipelined_any": (i, head + [p] + tail),
        "wrt_trace_pipelined_pairs": (i, pairs_head + pairs_out + tail),
        # t_start, code0, t_out, code_out
        "wrt_trace_near_closest": (i, near_head + [p, p, p, p] + tail),
        "wrt_trace_near_any": (i, near_head + [p, p] + tail),  # t_start, code
        "wrt_trace_near_pairs": (i, near_pairs_head + pairs_out + tail),
        # group, t_out, code_out
        "wrt_trace_near_closest_two_level": (i, near2_head + [i, p, p] + tail),
        "wrt_trace_near_any_two_level": (i, near2_head + [i, p] + tail),
        "wrt_trace_near_pairs_two_level": (
            i, near2_pairs_head + [i] + pairs_out + tail),
        # o, inv_d, t_max, t_start, box, n_boxes, kmask, n, keys, n_rays,
        # stream
        "wrt_top_keys": (i, [p, p, p, p, p, i, i, i, p, ctypes.c_longlong,
                             p]),
        # pos, view, state, projection, lens, the scalars (host), o, d,
        # state_out, n_rays, stream
        "wrt_camera_rays": (i, [p, p, p, i, i, p, p, p, p,
                                ctypes.c_longlong, p]),
        # the pointer block (host), phong, env_mis, n_lanes, stream
        "wrt_shade_hit": (i, [p, i, i, ctypes.c_longlong, p]),
        # the pointer block (host), env_is, run_env, n_lanes, stream
        "wrt_shade_bounce": (i, [p, i, i, ctypes.c_longlong, p]),
        # o, d, t, face, tri, out, n_rays, stream
        "wrt_rederive_uv": (i, [p, p, p, p, p, p, ctypes.c_longlong, p]),
        # the pointer block (host), n_lanes, stream
        "wrt_light_sample": (i, [p, ctypes.c_longlong, p]),
        # the pointer block (host), spp, last, n_lanes, stream
        "wrt_light_add": (i, [p, i, i, ctypes.c_longlong, p]),
        "wrt_error_string": (ctypes.c_char_p, [i]),
    }


def check_current_device(dev: torch.device) -> None:
    """Raise unless ``dev`` is the current CUDA device: a kernel runs where
    its rays are, and a caller that renders on several cards works on each
    under ``torch.cuda.device(dev)`` (parallel/shard.py), so rays on
    another card are a caller's error."""
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {dev}")
    cur = torch.cuda.current_device()
    if dev.index is not None and dev.index != cur:
        raise ValueError(
            f"the rays are on {dev} but the current CUDA device is cuda:"
            f"{cur}; trace under torch.cuda.device({str(dev)!r})"
        )


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; bind its entries."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        entries = _entries()
        missing = [name for name in entries if not hasattr(lib, name)]
        if missing:
            raise RuntimeError(
                f"kernel library {library_path()} lacks {', '.join(missing)}"
            )
        for name, (restype, argtypes) in entries.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def launch(label: str, entry: str, dev: torch.device, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``dev``, which must be the current CUDA device; a nonzero return raises
    with its ``wrt_error_string``."""
    check_current_device(dev)
    lib = load()
    err = getattr(lib, entry)(*args,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{label} kernel {entry} failed: "
                           + lib.wrt_error_string(err).decode())


def check_args(label: str, dev: torch.device, spec, copy: bool = False):
    """Each (name, tensor or None, dtype, shape or None for any) of
    ``spec`` checked to lie on ``dev``, contiguous, with that dtype and
    shape → the tensors, None kept. With ``copy`` a tensor that is not
    contiguous is copied instead of refused."""
    out = []
    for name, x, dt, shape in spec:
        if x is not None:
            if (x.device != dev or x.dtype != dt
                    or (shape is not None and x.shape != shape)
                    or not (copy or x.is_contiguous())):
                want = "" if shape is None else f" of shape {shape}"
                raise ValueError(
                    f"{label} kernel: {name} must be a contiguous {dt} "
                    f"tensor{want} on {dev}, got {x.dtype} {tuple(x.shape)} "
                    f"on {x.device} (contiguous={x.is_contiguous()})")
            if copy:
                x = x.contiguous()
        out.append(x)
    return out


def pointer_block(tensors) -> ctypes.Array:
    """The data pointers of ``tensors`` (null for None) as the host array
    that an entry taking an argument struct copies into it."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])


# Which of a kernel and its twin a routed entry runs: "auto" by the
# tensors' device (traversal "auto"), "kernel" the CUDA kernel only
# ("pallas"), "twin" the plain twin on any device ("pallas_interpret").
ROUTES = ("auto", "kernel", "twin")


class Kernel:
    """A kernel's Python entry, called with the arguments of ``twin`` and
    ``launch``. The device of the first tensor argument decides: CPU
    tensors run ``twin`` (the plain version) and count nothing; CUDA
    tensors run ``launch`` (which checks the arguments and launches the
    kernel) and add one to ``launches``; any other device raises. A
    ``routed`` entry also takes ``route`` (ROUTES): ``"kernel"`` launches
    or raises, ``"twin"`` runs the twin on any device. With ``span_name``
    the whole call is that span."""

    def __init__(self, name: str, twin, launch, label: str, doc: str,
                 routed: bool = False, span_name: Optional[str] = None):
        self.__name__ = self.__qualname__ = name
        self.twin, self.launch, self.label = twin, launch, label
        self.routed, self.span_name = routed, span_name
        self.launches = 0
        self.__doc__ = (
            f"{doc} CUDA tensors launch the kernel (counted in "
            f"``{name}.launches``); CPU tensors run the plain twin "
            f"(``{name}.twin``); "
            + ("``route`` as in ROUTES." if routed
               else "any other device raises."))

    def __call__(self, *args, **kw):
        if self.span_name is None:
            return self._dispatch(args, kw)
        with span(self.span_name):
            return self._dispatch(args, kw)

    def _dispatch(self, args, kw):
        route = kw.pop("route", "auto") if self.routed else "auto"
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        dev = next(x.device for x in (*args, *kw.values())
                   if isinstance(x, torch.Tensor))
        if route == "twin" or (route == "auto" and dev.type == "cpu"):
            return self.twin(*args, **kw)
        if dev.type == "cuda":
            out = self.launch(*args, **kw)
            self.launches += 1
            return out
        raise ValueError(
            f"no {self.label} kernel for device {dev}"
            + (" (route 'kernel', traversal 'pallas', runs only the CUDA "
               "kernels)" if route == "kernel" else ""))
