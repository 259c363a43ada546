"""The ray-march kernel's wrapper: build, bind and launch ``csrc/raymarch.cu``.

Replaces the TPU kernel ``geodesic_raytracing_tpu/ops/pallas/raymarch.py::
launch`` (the pallas_call over (8, tile/8) ray tiles).  The CUDA kernel runs
one thread per ray: each thread keeps its ray in registers and marches it
to termination (``csrc/march.cuh``).  It is bound by FP32 instruction rate
per step and by lanes that idle while their warp's slowest ray runs on, not
by bytes (68 bytes per ray are read and 64 written, once).  When the rays
are the pixels of an image, a warp takes an 8x4 pixel tile of it
(``tile_ray_index``), whose rays end after more similar step counts than 32
pixels of a row.  No tile packing is needed: the kernel reads the (N, 4)
``RayState`` rows directly.

Build: ``nvcc`` into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so the build takes seconds), at first use, into
``build/grt_torch/`` keyed on a hash of the sources in ``csrc/`` and of the
flags.  ``NVCC_FLAGS`` are the flags of the next build: no
``--use_fast_math`` (its sin and cos are too coarse for photon-ring rays),
and ``-fmad=false``, with which the kernel follows the eager torch march op
for op in float32.  ``with_flags`` derives a variant for measurement.

The wrapper launches on CUDA tensors or raises: there is no fallback.  Its
plain twin is ``integrate.trace_rays_reference``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
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
_libs: dict = {}  # flags -> loaded library
# flags -> {"seconds": nvcc wall time (None when the library was cached),
#           "ptxas": nvcc's -Xptxas -v report (kept beside the library),
#           "path": library path}
BUILD_INFO: dict = {}


def with_flags(*extra: str) -> tuple:
    """``NVCC_FLAGS`` with ``extra`` appended; an ``-fmad=`` among them
    replaces the default one (nvcc refuses the option twice)."""
    base = [f for f in NVCC_FLAGS
            if not (f.startswith("-fmad=")
                    and any(e.startswith("-fmad=") for e in extra))]
    return (*base, *extra)


def source_hash(flags=None) -> str:
    """Hash of every source in ``csrc/`` (names and bytes) and of the build
    flags (default: ``NVCC_FLAGS``)."""
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS if flags is None else flags).encode())
    return h.hexdigest()[:16]


def ptxas_summary(report: str) -> dict:
    """``{"registers", "stack_bytes", "spill_store_bytes",
    "spill_load_bytes"}`` of the ray-march kernel from a ``-Xptxas -v``
    report."""
    regs = re.search(r"Used (\d+) registers", report)
    mem = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads", report)
    if not (regs and mem):
        raise ValueError(f"no ptxas report of a kernel in:\n{report}")
    return {"registers": int(regs.group(1)), "stack_bytes": int(mem.group(1)),
            "spill_store_bytes": int(mem.group(2)),
            "spill_load_bytes": int(mem.group(3))}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, or under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def build(flags=None) -> Path:
    """Compile ``csrc/raymarch.cu`` with ``flags`` (default: ``NVCC_FLAGS``)
    unless a library for the current sources and these flags exists.
    Prints the ptxas register/spill report once."""
    flags = tuple(NVCC_FLAGS if flags is None else flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libgrt_raymarch_{source_hash(flags)}.so"
    report_path = lib_path.with_suffix(".ptxas.txt")
    if lib_path.exists() and report_path.exists():
        BUILD_INFO[flags] = dict(seconds=None, ptxas=report_path.read_text(),
                                 path=str(lib_path))
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(CSRC / "raymarch.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    report = proc.stderr.strip()
    report_path.write_text(report)
    os.replace(tmp, lib_path)
    BUILD_INFO[flags] = dict(seconds=seconds, ptxas=report,
                             path=str(lib_path))
    print(f"[grt_torch] built {lib_path.name} in {seconds:.1f} s\n{report}",
          flush=True)
    return lib_path


def get_lib():
    """The kernel library of the current ``NVCC_FLAGS``, loaded (and built
    at first use)."""
    flags = tuple(NVCC_FLAGS)
    with _lock:
        if flags not in _libs:
            lib = ctypes.CDLL(str(build(flags)))
            vp = ctypes.c_void_p
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_float, ctypes.c_float,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               *[vp] * 10]
            lib.grt_raymarch_config.restype = ctypes.c_int
            lib.grt_raymarch_config.argtypes = [
                ctypes.POINTER(ctypes.c_int)] * 2
            lib.grt_error_string.restype = ctypes.c_char_p
            lib.grt_error_string.argtypes = [ctypes.c_int]
            _libs[flags] = lib
        return _libs[flags]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.grt_error_string(rc).decode()} ({rc})")


def kernel_config() -> dict:
    """``{"threads", "blocks_per_sm"}`` of the built kernel: its block size
    and the blocks of it that one SM holds at once."""
    lib = get_lib()
    out = [ctypes.c_int() for _ in range(2)]
    _raise_on(lib, lib.grt_raymarch_config(*(ctypes.byref(c) for c in out)),
              "occupancy query")
    return dict(zip(("threads", "blocks_per_sm"), (c.value for c in out)))


TILE_W, TILE_H = 8, 4  # kTileW, kTileH of csrc/raymarch.cu


def tile_ray_index(n_rays: int, width: int) -> np.ndarray:
    """The kernel's thread-to-ray map for the pixels of a row-major image of
    ``width`` (``ray_of_thread`` in ``csrc/raymarch.cu``), in numpy: entry
    t is the ray of thread t, or -1 for a thread beyond the image's right
    or bottom edge.  Warp t // 32 takes the 8x4 pixel tile t // 32 (tiles in
    row-major order), lane t % 32 its pixel (lane % 8, lane // 8)."""
    height = n_rays // width
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    t = np.arange(tiles_x * tiles_y * 32)
    tile, lane = t // 32, t % 32
    x = (tile % tiles_x) * TILE_W + lane % TILE_W
    y = (tile // tiles_x) * TILE_H + lane // TILE_W
    return np.where((x < width) & (y < height), y * width + x, -1)


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
                    f_in_x: torch.Tensor | None = None,
                    trials: torch.Tensor | None = None,
                    image_width: int | None = None) -> RayState:
    """March every ACTIVE ray with the CUDA kernel: one launch on the
    current stream.  Returns a new RayState (the kernel updates copies of
    the input tensors in place).  ``f_in_x``: the launch-time |v^t| of each
    ray (default: taken from ``state``).  ``trials``: an (N,) int32 tensor
    that receives the trial iterations of each ray marched (committed steps,
    rejected trials and the terminating one); others keep their entry.
    ``image_width``: the rays are the pixels of a row-major image of this
    width, and each warp takes an 8x4 pixel tile of it (default: 32
    consecutive rays); the result is the same either way."""
    global LAUNCHES
    if metric.name not in _ENTRY:
        raise NotImplementedError(f"no ray-march kernel instance for metric "
                                  f"{metric.name!r}")
    check_ported(opts)
    check_ported_metric(metric)

    n = state.position.shape[0]
    width = 0 if image_width is None else int(image_width)
    if image_width is not None and (width <= 0 or n % width != 0):
        raise ValueError(f"trace_rays_cuda: image_width {image_width} does "
                         f"not divide the {n} rays")
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
    if trials is not None:
        _check("trials", trials, (n,), i32)

    out = RayState(*(t.clone() for t in state))
    feats = (ctypes.c_float * 6)(*(float(v) for v in features))
    lib = get_lib()
    entry = getattr(lib, _ENTRY[metric.name])
    dev = state.position.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(float(params["rs"]), float(params["a"]), feats, n, width,
                   int(opts.max_steps), out.position.data_ptr(),
                   out.velocity.data_ptr(), out.acceleration.data_ptr(),
                   out.next_ds.data_ptr(), out.running_dlambda_dnew.data_ptr(),
                   out.status.data_ptr(), out.steps.data_ptr(),
                   f_in_x.data_ptr(),
                   None if trials is None else trials.data_ptr(),
                   stream)
    _raise_on(lib, rc, "ray-march kernel launch")
    LAUNCHES += 1
    return out
