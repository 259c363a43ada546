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

The kernel is a C++ template over the metric and over the trace options the
step branches on (planar mode, the Euler integrator, affine
reparameterisation).  One library is built per metric (``INSTANCES``), each
holding the six option instances; the options travel as launch arguments
and the library's entry point picks the instance.

Build: ``nvcc`` into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so the build takes seconds), at a metric's first
use (``build_all`` builds every metric's at once, one ``nvcc`` each), into
``build/grt_torch/`` keyed on a hash of the sources in ``csrc/`` and of the
flags.  ``NVCC_FLAGS`` are the flags of the next build: no
``--use_fast_math`` (its sin and cos are too coarse for photon-ring rays),
and ``-fmad=false``, with which the kernel follows the eager torch march op
for op in float32.  ``with_flags`` derives a variant for measurement.

The wrapper launches on CUDA tensors or raises: there is no fallback, and a
metric without a kernel instance, or one that differs from the registered
metric its instance was written from (``check_compiled_metric``), raises
``NotImplementedError``.  Its plain
twin is ``integrate.trace_rays_reference``.
"""

from __future__ import annotations

import concurrent.futures
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
from .integrate import Features, RayState, TraceOptions, schedule_constants

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grt_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# The kernel's metric instances: metric name -> (the metric struct of
# csrc/metrics.cuh, the metric's parameters in the order of that struct).
INSTANCES = {
    "kerr_boyer": ("KerrBoyer", ("rs", "a")),
    "schwarzschild": ("Schwarzschild", ("rs",)),
    "schwarzschild_fast": ("SchwarzschildFast", ("rs",)),
    "schwarzschild_skewed": ("SchwarzschildSkewed", ()),
    "schwarzschild_ingoing_ef": ("SchwarzschildIngoingEF", ("rs",)),
    "de_sitter": ("DeSitter", ("cosmological_constant",)),
    "minkowski": ("Minkowski", ()),
    "minkowski_skew": ("MinkowskiSkew", ()),
    "wormhole (morris-thorne)": ("Wormhole", ("n",)),
    "black_hole_cosmic_string": ("BlackHoleCosmicString", ("rs", "B")),
    "ernst": ("Ernst", ("B", "rs")),
    "kerr_newman_boyer": ("KerrNewmanBoyer", ("rs", "r2q", "a")),
    "kerr_ingoing_ef": ("KerrIngoingEF", ("rs", "a")),
    "kerr_rational_polynomial": ("KerrRationalPolynomial", ("m", "a")),
    "misner_4d": ("Misner4D", ("phi0",)),
    "cosmic_string_spinning": ("CosmicStringSpinning", ("a", "k")),
    "janis_newman_winicour": ("JanisNewmanWinicour", ("r0", "mu")),
    "schwarzschild_ingoing_ef_hawking": ("SchwarzschildIngoingEFHawking",
                                         ("rs_base", "lifetime")),
    "configurable_wormhole": ("ConfigurableWormhole", ("M", "p", "a")),
    "ellis_drainhole": ("EllisDrainhole", ("m", "n")),
    "symmetric_warp_drive": ("SymmetricWarpDrive", ()),
    "alcubierre": ("Alcubierre", ("velocity", "sigma", "R")),
    "krasnikov_tube": ("KrasnikovTube", ("e", "D", "pmax", "littled")),
    "krasnikov_cylindrical": ("KrasnikovCylindrical", ("e", "D", "pmax")),
    "godel_cylindrical": ("GodelCylindrical", ("a",)),
    "kerr_schild": ("KerrSchild", ("a", "rs")),
    "kerr_newman_schild": ("KerrNewmanSchild", ("a", "rs", "Q")),
    "double_schwarzschild": ("DoubleSchwarzschild", ("M1", "M2", "z")),
    "double_kerr": ("DoubleKerr", ("R", "M", "a")),
    "double_kerr_alt": ("DoubleKerrAlt", ("R", "M", "q")),
    "double_unequal_kerr": ("DoubleUnequalKerr",
                            ("m1", "m2", "fa1", "fa2", "R")),
}

# What a metric struct of csrc/ has compiled in besides the metric function:
# the MetricConfig fields the step branches on and the chart.  (The config's
# max_acceleration_change travels in Features, at run time.)
COMPILED_CONFIG = ("adaptive_precision", "detect_singularities", "singular",
                   "singular_terminator", "has_cylindrical_singularity",
                   "cylindrical_terminator", "unconditionally_nonsingular",
                   "coordinate_system", "to_polar", "from_polar",
                   "origin_distance")

# Kernel launches made by trace_rays_cuda (one per call), by metric.
LAUNCHES_BY_METRIC: dict = {}

_lock = threading.Lock()
_libs: dict = {}  # (metric name, flags) -> loaded library
# (metric name, flags) -> {"seconds": nvcc wall time (None when the library
#           was cached), "ptxas": nvcc's -Xptxas -v report (kept beside the
#           library), "path": library path}
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    """Set the launch counts to 0."""
    LAUNCHES_BY_METRIC.clear()


def launches() -> int:
    """Kernel launches since the counts were last set to 0, of all metrics."""
    return sum(LAUNCHES_BY_METRIC.values())


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


def ptxas_instances(report: str) -> dict:
    """``{(planar, euler, reparameterisation): {"registers", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}}`` of every ray-march kernel
    instance in a ``-Xptxas -v`` report (the options are read from the
    mangled name's ``StepOptions<...>``)."""
    out = {}
    for block in re.split(r"Compiling entry function '", report)[1:]:
        opt = re.match(r"[^']*StepOptionsILb(\d)ELb(\d)ELb(\d)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        mem = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", block)
        if not (opt and regs and mem):
            continue
        out[tuple(bool(int(g)) for g in opt.groups())] = {
            "registers": int(regs.group(1)),
            "stack_bytes": int(mem.group(1)),
            "spill_store_bytes": int(mem.group(2)),
            "spill_load_bytes": int(mem.group(3))}
    if not out:
        raise ValueError(f"no ptxas report of a kernel in:\n{report}")
    return out


def ptxas_summary(report: str) -> dict:
    """``{"registers", "stack_bytes", "spill_store_bytes",
    "spill_load_bytes"}`` of the ray-march kernel's instance of the default
    options (Verlet, no reparameterisation, not planar) from a
    ``-Xptxas -v`` report."""
    return ptxas_instances(report)[(False, False, False)]


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


def _instance(name: str) -> tuple:
    try:
        return INSTANCES[name]
    except KeyError:
        raise NotImplementedError(
            f"no ray-march kernel instance for metric {name!r} (instances: "
            f"{sorted(INSTANCES)})") from None


def check_compiled_metric(metric: Metric) -> None:
    """Raise NotImplementedError unless ``metric`` is what the kernel
    instance of its name was written from: the registered metric's function,
    its rank-1 decomposition (which picks the acceleration path),
    ``depends_on``, symmetry flag (it sets the precision weights) and every
    ``COMPILED_CONFIG`` field.  A metric whose config was replaced has no
    instance, whatever its name."""
    from ..metrics import REGISTRY

    _instance(metric.name)
    known = REGISTRY.get(metric.name)
    differs = ["(not registered)"] if known is None else [
        f for f in ("fn", "rank1", "depends_on", "spherically_symmetric")
        if getattr(metric, f) != getattr(known, f)] + [
        f"config.{f}" for f in COMPILED_CONFIG
        if getattr(metric.config, f) != getattr(known.config, f)]
    if differs:
        raise NotImplementedError(
            f"the ray-march kernel instance {metric.name!r} has the "
            f"registered metric compiled in; this one differs in "
            f"{', '.join(differs)}")


def build(name: str, flags=None) -> Path:
    """Compile ``csrc/raymarch.cu`` for the metric ``name`` with ``flags``
    (default: ``NVCC_FLAGS``) unless a library for the current sources and
    these flags exists.  Prints the ptxas register/spill report once."""
    struct, _ = _instance(name)
    flags = tuple(NVCC_FLAGS if flags is None else flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Named by the struct: a metric's name may hold spaces and parentheses.
    lib_path = BUILD_DIR / f"libgrt_raymarch_{struct}_{source_hash(flags)}.so"
    report_path = lib_path.with_suffix(".ptxas.txt")
    key = (name, flags)
    if lib_path.exists() and report_path.exists():
        BUILD_INFO.setdefault(key, dict(seconds=None,
                                        ptxas=report_path.read_text(),
                                        path=str(lib_path)))
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *flags, f"-DGRT_METRIC={struct}", "-o", str(tmp),
           str(CSRC / "raymarch.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    report = proc.stderr.strip()
    report_path.write_text(report)
    os.replace(tmp, lib_path)
    BUILD_INFO[key] = dict(seconds=seconds, ptxas=report, path=str(lib_path))
    print(f"[grt_torch] built {lib_path.name} in {seconds:.1f} s\n"
          + "\n".join(f"  {opt}: {v}" for opt, v in
                      sorted(ptxas_instances(report).items())), flush=True)
    return lib_path


def build_all(names=None, flags=None) -> float:
    """Build the libraries of ``names`` (default: every metric instance) at
    once, one ``nvcc`` process each.  Returns the wall seconds."""
    names = sorted(INSTANCES) if names is None else list(names)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(lambda n: build(n, flags), names))
    return time.perf_counter() - t0


def get_lib(name: str):
    """The kernel library of metric ``name`` for the current ``NVCC_FLAGS``,
    loaded (and built at first use)."""
    key = (name, tuple(NVCC_FLAGS))
    with _lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(build(*key)))
            vp, fp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
            lib.grt_raymarch.restype = ctypes.c_int
            lib.grt_raymarch.argtypes = [fp, fp, *[ctypes.c_int] * 6,
                                         *[vp] * 10]
            lib.grt_metric_name.restype = ctypes.c_char_p
            lib.grt_metric_name.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.grt_raymarch_config.restype = ctypes.c_int
            lib.grt_raymarch_config.argtypes = [
                ctypes.POINTER(ctypes.c_int)] * 2
            lib.grt_error_string.restype = ctypes.c_char_p
            lib.grt_error_string.argtypes = [ctypes.c_int]
            n_params = ctypes.c_int()
            built_for = lib.grt_metric_name(ctypes.byref(n_params)).decode()
            if (built_for, n_params.value) != (name, len(INSTANCES[name][1])):
                raise RuntimeError(
                    f"{BUILD_INFO[key]['path']} was built for {built_for!r} "
                    f"with {n_params.value} parameters, not for {name!r}")
            _libs[key] = lib
        return _libs[key]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.grt_error_string(rc).decode()} ({rc})")


def kernel_config(name: str) -> dict:
    """``{"threads", "blocks_per_sm"}`` of metric ``name``'s kernel (the
    instance of the default options): its block size and the blocks of it
    that one SM holds at once."""
    lib = get_lib(name)
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
    check_compiled_metric(metric)
    _, param_names = INSTANCES[metric.name]
    if any(isinstance(params[k], torch.Tensor) and params[k].requires_grad
           for k in param_names):
        # The kernel is forward-only: it takes the parameters as host
        # floats, and a gradient through them would be lost without a word.
        raise ValueError("trace_rays_cuda: a parameter requires grad; the "
                         "kernel takes detached host floats")

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
    # The 8 floats of csrc/march.cuh's Features.
    feats = (ctypes.c_float * 8)(*(float(v) for v in features),
                                 *schedule_constants(features))
    mparams = (ctypes.c_float * max(len(param_names), 1))(
        *(float(params[k]) for k in param_names))
    lib = get_lib(metric.name)
    dev = state.position.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_raymarch(
                   mparams, feats, int(opts.planar),
                   int(opts.integrator == "euler"),
                   int(opts.reparameterisation), n, width,
                   int(opts.max_steps), out.position.data_ptr(),
                   out.velocity.data_ptr(), out.acceleration.data_ptr(),
                   out.next_ds.data_ptr(), out.running_dlambda_dnew.data_ptr(),
                   out.status.data_ptr(), out.steps.data_ptr(),
                   f_in_x.data_ptr(),
                   None if trials is None else trials.data_ptr(),
                   stream)
    _raise_on(lib, rc, "ray-march kernel launch")
    LAUNCHES_BY_METRIC[metric.name] = LAUNCHES_BY_METRIC.get(metric.name,
                                                             0) + 1
    return out
