"""The ray-march kernel's wrapper: build, bind and launch ``csrc/raymarch.cu``.

Replaces the TPU kernel ``geodesic_raytracing_tpu/ops/pallas/raymarch.py::
launch`` (the pallas_call over (8, tile/8) ray tiles).  The CUDA kernel runs
one thread per ray: each thread keeps its ray in registers and marches it
to termination (``csrc/march.cuh``).  It is bound by FP32 ALU work per step
and by divergence within a warp, not by bytes (about 17 floats per ray are
read and written once); one thread per ray makes the divergence per warp
instead of per 2048-ray tile.  No tile packing is needed: the kernel reads
the (N, 4) ``RayState`` rows directly.

Build: ``nvcc`` into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so the build takes seconds), at first use, into
``build/grt_torch/`` keyed on a hash of the sources in ``csrc/``.  Without
``--use_fast_math`` and with ``-fmad=false`` the kernel follows the eager
torch march op for op in float32 except for the transcendentals.

The wrapper launches on CUDA tensors or raises: there is no fallback.  Its
plain twin is ``integrate.trace_rays_reference``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..metrics.base import Metric
from .integrate import (Features, RayState, TraceOptions, check_ported,
                        check_ported_metric)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grt_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# One C entry point per metric instance of the kernel.
_ENTRY = {"kerr_boyer": "grt_raymarch_kerr_boyer"}

# Kernel launches made by trace_rays_cuda (one per call).
LAUNCHES = 0

_lock = threading.Lock()
_lib = None
# {"seconds": nvcc wall time (None when the library was cached),
#  "ptxas": nvcc's -Xptxas -v report, "path": library path}
BUILD_INFO: dict = {}


def source_hash() -> str:
    """Hash of every source in ``csrc/`` (names and bytes)."""
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def build() -> Path:
    """Compile ``csrc/raymarch.cu`` unless a library for the current
    sources exists.  Prints the ptxas register/spill report once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libgrt_raymarch_{source_hash()}.so"
    if lib_path.exists():
        BUILD_INFO.update(seconds=None, ptxas="", path=str(lib_path))
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "raymarch.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    report = proc.stderr.strip()
    BUILD_INFO.update(seconds=seconds, ptxas=report, path=str(lib_path))
    print(f"[grt_torch] built {lib_path.name} in {seconds:.1f} s\n{report}",
          flush=True)
    return lib_path


def get_lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_float, ctypes.c_float,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int, ctypes.c_int,
                               vp, vp, vp, vp, vp, vp, vp, vp, vp]
            lib.grt_error_string.restype = ctypes.c_char_p
            lib.grt_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def _check(name, t: torch.Tensor, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"trace_rays_cuda: {name} is on {t.device}, "
                         "the kernel needs CUDA tensors")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"trace_rays_cuda: {name} is {t.dtype} "
                         f"{tuple(t.shape)}, expected {dtype} {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"trace_rays_cuda: {name} is not contiguous")


def trace_rays_cuda(metric: Metric, state: RayState, params,
                    features: Features, opts: TraceOptions,
                    f_in_x: torch.Tensor | None = None) -> RayState:
    """March every ACTIVE ray with the CUDA kernel: one launch on the
    current stream.  Returns a new RayState (the kernel updates copies of
    the input tensors in place).  ``f_in_x``: the launch-time |v^t| of each
    ray (default: taken from ``state``)."""
    global LAUNCHES
    if metric.name not in _ENTRY:
        raise NotImplementedError(f"no ray-march kernel instance for metric "
                                  f"{metric.name!r}")
    check_ported(opts)
    check_ported_metric(metric)

    n = state.position.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, shape, dtype in (("position", (n, 4), f32),
                               ("velocity", (n, 4), f32),
                               ("acceleration", (n, 4), f32),
                               ("next_ds", (n,), f32),
                               ("running_dlambda_dnew", (n,), f32),
                               ("status", (n,), i32), ("steps", (n,), i32)):
        _check(name, getattr(state, name), shape, dtype)
    if f_in_x is None:
        f_in_x = torch.abs(state.velocity[:, 0]).contiguous()
    _check("f_in_x", f_in_x, (n,), f32)

    out = RayState(*(t.clone() for t in state))
    feats = (ctypes.c_float * 6)(*(float(v) for v in features))
    lib = get_lib()
    entry = getattr(lib, _ENTRY[metric.name])
    dev = state.position.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(float(params["rs"]), float(params["a"]), feats, n,
                   int(opts.max_steps), out.position.data_ptr(),
                   out.velocity.data_ptr(), out.acceleration.data_ptr(),
                   out.next_ds.data_ptr(), out.running_dlambda_dnew.data_ptr(),
                   out.status.data_ptr(), out.steps.data_ptr(),
                   f_in_x.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("ray-march kernel launch failed: "
                           f"{lib.grt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out
