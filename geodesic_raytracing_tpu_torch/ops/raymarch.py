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

Besides the hand-written structs of ``csrc/`` (``INSTANCES``), a library
can hold a struct that ``ops/emit.py`` wrote from a torch metric function
(an emitted instance: a registered metric without a hand struct, such as a
content pack's, is emitted at its first use; ``emitted_instance`` emits
any metric on request), and either kind can be baked
(``baked_instance``): ``GRT_BAKED_PARAMS`` (a header line) makes the
kernel build its metric from compile-time constants, so that ``nvcc`` folds
the parameters through the step; a baked metric launches with its own
values, and a library whose compiled-in values are not its instance's is
refused when it is loaded.  A library is keyed on a hash of ``csrc/``, of the emitted
header, of the baked values and of the flags.

The wrapper launches on CUDA tensors or raises: there is no fallback, and a
metric without a kernel instance, or one that differs from the registered
metric its instance was written from (``check_compiled_metric``), raises
``NotImplementedError``; so does a metric the emitter cannot emit, naming
the op.  Its plain twin is ``integrate.trace_rays_reference``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
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

from ..metrics.base import BakedFn, Metric
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

# Kernel launches made by trace_rays_cuda (one per call), by the label of
# the instance launched (the metric's name for its default instance).
LAUNCHES_BY_METRIC: dict = {}


@dataclasses.dataclass(frozen=True)
class Instance:
    """The metric a kernel library is built for.  ``label``: its key in
    ``LAUNCHES_BY_METRIC`` and ``BUILD_INFO`` (the metric's name for the
    metric's default instance); ``metric``: the metric's name; ``struct``:
    the metric struct (in namespace ``grt``); ``params``: the parameters in
    the struct's order; ``header``: the emitted header's text, or None for a
    struct of ``csrc/``; ``baked``: the float32 parameter values compiled
    in, or None."""

    label: str
    metric: str
    struct: str
    params: tuple
    header: str | None = None
    baked: tuple | None = None


# (metric name, id(fn), what else the struct compiles in, baked values) ->
# (Instance, fn: kept so that its id is not reused)
_emitted: dict = {}

_lock = threading.Lock()
_libs: dict = {}  # (instance label, flags) -> (Instance, loaded library)
# (instance label, flags) -> {"seconds": nvcc wall time (None when the library
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
            f"{sorted(INSTANCES)}; a registered metric without one, such as "
            "a content pack's, is emitted)") from None


def hand_instance(name: str) -> Instance:
    """The instance of the hand-written struct of metric ``name``."""
    struct, params = _instance(name)
    return Instance(label=name, metric=name, struct=struct, params=params)


def _unbaked(metric: Metric) -> Metric:
    if isinstance(metric.fn, BakedFn):
        return dataclasses.replace(metric, fn=metric.fn.fn)
    return metric


def emitted_instance(metric: Metric, params=None) -> Instance:
    """The instance of ``metric``'s struct as ``ops/emit.py`` writes it from
    the metric's function: dynamic, or baked with ``params`` (labelled
    ``<name> [baked]``).  Raises NotImplementedError for what the emitter
    cannot emit."""
    from . import emit

    metric = _unbaked(metric)
    values = None if params is None else tuple(
        float(np.float32(params[k])) for k in metric.defaults)
    key = (metric.name, id(metric.fn), tuple(metric.defaults), metric.config,
           metric.depends_on, metric.spherically_symmetric, metric.structure,
           metric.diagonal, values)
    with _lock:
        hit = _emitted.get(key)
    if hit is None:
        h = emit.emit_metric(metric, params)
        label = metric.name if values is None else f"{metric.name} [baked]"
        inst = Instance(label=label, metric=metric.name, struct=h.struct,
                        params=h.params, header=h.text, baked=h.baked)
        with _lock:
            hit = _emitted.setdefault(key, (inst, metric.fn))
    return hit[0]


def baked_instance(metric: Metric, params) -> Instance:
    """``metric``'s instance with ``params`` compiled in: its hand struct
    built with ``GRT_BAKED_PARAMS`` defined, or else its emitted struct
    traced with the values as Python floats (``ops/emit.py``, baked
    mode)."""
    metric = _unbaked(metric)
    if metric.name not in INSTANCES:
        return emitted_instance(metric, params)
    inst = hand_instance(metric.name)
    return dataclasses.replace(
        inst, label=f"{metric.name} [baked]",
        baked=tuple(float(np.float32(params[k])) for k in inst.params))


def instance_of(metric: Metric) -> Instance:
    """The instance ``trace_rays_cuda`` launches for ``metric`` (checked by
    ``check_compiled_metric``): the hand struct of its name, or the emitted
    struct of a registered metric without one; baked where the metric is
    (``runtime.hotswap.bake``)."""
    check_compiled_metric(metric)
    if isinstance(metric.fn, BakedFn):
        return baked_instance(metric, dict(metric.fn.params))
    if metric.name in INSTANCES:
        return hand_instance(metric.name)
    return emitted_instance(metric)


def check_compiled_metric(metric: Metric) -> None:
    """Raise NotImplementedError unless ``metric`` is what the kernel
    instance of its name was written from: the registered metric's function,
    its rank-1 decomposition (which picks the acceleration path),
    ``depends_on``, symmetry flag (it sets the precision weights) and every
    ``COMPILED_CONFIG`` field.  A metric whose config was replaced has no
    instance, whatever its name.  A baked metric is held so by the function
    it was baked from."""
    from ..metrics import REGISTRY

    metric = _unbaked(metric)
    known = REGISTRY.get(metric.name)
    if metric.name not in INSTANCES and known is None:
        _instance(metric.name)
    differs = ["(not registered)"] if known is None else [
        f for f in ("fn", "rank1", "depends_on", "spherically_symmetric",
                    "diagonal", "structure")
        if getattr(metric, f) != getattr(known, f)] + [
        f"config.{f}" for f in COMPILED_CONFIG
        if getattr(metric.config, f) != getattr(known.config, f)]
    if differs:
        raise NotImplementedError(
            f"the ray-march kernel instance {metric.name!r} has the "
            f"registered metric compiled in; this one differs in "
            f"{', '.join(differs)}")


def baked_define(values) -> str:
    """The header line of a baked build: ``GRT_BAKED_PARAMS`` defined as
    the parameter values in hex-float literals, each followed by a comma
    (raymarch.cu pads the list).  It goes in with ``-include``: nvcc splits
    a ``-D`` value at its commas."""
    from .emit import lit

    return "#define GRT_BAKED_PARAMS " + "".join(f"{lit(v)}," for v in values)


def _as_instance(name) -> Instance:
    return name if isinstance(name, Instance) else hand_instance(name)


def library_path(name, flags=None) -> Path:
    """Where ``build`` puts the library of metric ``name`` (or of an
    ``Instance``) for ``flags`` (default: ``NVCC_FLAGS``): keyed on
    ``source_hash`` and on an emitted header's text and baked values.  Its
    ptxas report lies beside it (``.ptxas.txt``)."""
    inst = _as_instance(name)
    tag = source_hash(flags)
    if inst.header is not None or inst.baked is not None:
        baked = "" if inst.baked is None else baked_define(inst.baked)
        tag = hashlib.sha256("\0".join(
            (tag, inst.header or "", baked)).encode()).hexdigest()[:16]
    # Named by the struct: a metric's name may hold spaces and parentheses.
    return BUILD_DIR / f"libgrt_raymarch_{inst.struct}_{tag}.so"


def build(name, flags=None) -> Path:
    """Compile ``csrc/raymarch.cu`` for the metric ``name`` (or an
    ``Instance``) with ``flags`` (default: ``NVCC_FLAGS``) unless a library
    for the current sources, header, baked values and these flags exists.
    Prints the ptxas register/spill report once."""
    inst = _as_instance(name)
    flags = tuple(NVCC_FLAGS if flags is None else flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = library_path(inst, flags)
    report_path = lib_path.with_suffix(".ptxas.txt")
    key = (inst.label, flags)
    if lib_path.exists() and report_path.exists():
        BUILD_INFO.setdefault(key, dict(seconds=None,
                                        ptxas=report_path.read_text(),
                                        path=str(lib_path)))
        return lib_path
    extra = []
    if inst.baked is not None:
        define = lib_path.with_suffix(".baked.h")
        define.write_text(baked_define(inst.baked) + "\n")
        extra += ["-include", str(define)]
    if inst.header is not None:
        header = lib_path.with_suffix(".cuh")
        header.write_text(inst.header)
        extra += ["-I", str(CSRC), "-include", str(header)]
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *flags, *extra, f"-DGRT_METRIC={inst.struct}", "-o",
           str(tmp), str(CSRC / "raymarch.cu")]
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
    """Build the libraries of ``names`` (metric names or ``Instance``s;
    default: every metric instance of ``INSTANCES``) at once, one ``nvcc``
    process each.  Returns the wall seconds."""
    names = sorted(INSTANCES) if names is None else list(names)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(lambda n: build(n, flags), names))
    return time.perf_counter() - t0


def get_lib(name):
    """The kernel library of metric ``name`` (or of an ``Instance``) for the
    current ``NVCC_FLAGS``, loaded (and built at first use)."""
    inst = _as_instance(name)
    key = (inst.label, tuple(NVCC_FLAGS))
    with _lock:
        hit = _libs.get(key)
    if hit is not None and hit[0] == inst:
        return hit[1]
    path = build(inst)
    with _lock:
        if key not in _libs or _libs[key][0] != inst:
            lib = ctypes.CDLL(str(path))
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
            lib.grt_baked_params.restype = ctypes.POINTER(ctypes.c_float)
            lib.grt_baked_params.argtypes = [ctypes.POINTER(ctypes.c_int)]
            n_params = ctypes.c_int()
            built_for = lib.grt_metric_name(ctypes.byref(n_params)).decode()
            if (built_for, n_params.value) != (inst.metric, len(inst.params)):
                raise RuntimeError(
                    f"{path} was built for {built_for!r} with "
                    f"{n_params.value} parameters, not for {inst.metric!r}")
            n_baked = ctypes.c_int()
            ptr = lib.grt_baked_params(ctypes.byref(n_baked))
            baked = (None if n_baked.value < 0 else
                     tuple(ptr[i] for i in range(n_baked.value)))
            if baked != inst.baked:
                raise RuntimeError(f"{path} was built with the parameters "
                                   f"{baked} compiled in, not {inst.baked}")
            _libs[key] = (inst, lib)
        return _libs[key][1]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.grt_error_string(rc).decode()} ({rc})")


def kernel_config(name) -> dict:
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
    consecutive rays); the result is the same either way.  A baked metric
    (``runtime.hotswap.bake``) launches its baked library with the values
    it was baked with, as its function evaluates with them."""
    inst = instance_of(metric)
    if isinstance(metric.fn, BakedFn):
        params = dict(metric.fn.params)
    param_names = inst.params
    if any(isinstance(params[k], torch.Tensor) and params[k].requires_grad
           for k in param_names):
        # The kernel is forward-only: it takes the parameters as host
        # floats, and a gradient through them would be lost without a word.
        raise ValueError("trace_rays_cuda: a parameter requires grad; the "
                         "kernel takes detached host floats")
    values = tuple(float(np.float32(float(params[k]))) for k in param_names)

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
    mparams = (ctypes.c_float * max(len(param_names), 1))(*values)
    lib = get_lib(inst)
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
    LAUNCHES_BY_METRIC[inst.label] = LAUNCHES_BY_METRIC.get(inst.label, 0) + 1
    return out


def trace_rays_recorded_cuda(metric: Metric, state: RayState, params,
                             features: Features, opts: TraceOptions,
                             n_slots: int, steps_per_slot: int,
                             image_width: int | None = None
                             ) -> tuple[RayState, torch.Tensor]:
    """The recorded march (``integrate.trace_rays_recorded``) as ``n_slots``
    launches of the ray-march kernel, each with a budget of
    ``steps_per_slot`` trial iterations a ray (the kernel's ``max_steps``)
    and the launch state's |v^t| as every launch's ``f_in_x``.  Each
    launch's positions are copied into a ``(n_slots+1, N, 4)`` tensor on the
    card; nothing waits for the device between launches.  Returns ``(final
    RayState, path)``.  Its plain twin is
    ``integrate.trace_rays_recorded_reference``."""
    f_in_x = torch.abs(state.velocity[:, 0]).contiguous()
    slot = dataclasses.replace(opts, max_steps=steps_per_slot)
    n = state.position.shape[0]
    path = torch.empty((n_slots + 1, n, 4), dtype=state.position.dtype,
                       device=state.position.device)
    path[0].copy_(state.position)
    for j in range(n_slots):
        state = trace_rays_cuda(metric, state, params, features, slot,
                                f_in_x=f_in_x, image_width=image_width)
        path[j + 1].copy_(state.position)
    return state, path
