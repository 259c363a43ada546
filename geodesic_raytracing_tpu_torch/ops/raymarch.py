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
reparameterisation).  The metric is a struct that ``ops/emit.py`` writes
from the metric's torch function, the one source of the kernel's metric:
one library is built per emitted struct, each holding the six option
instances; the options travel as launch arguments and the library's entry
point picks the instance.

Build: ``nvcc`` into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so the build takes seconds), at a metric's first
use (``build_all`` builds every registered metric's at once, one ``nvcc``
each), into ``build/grt_torch/`` keyed on a hash of the sources in
``csrc/``, of the emitted header, of the baked values and of the flags, so
that a later process loads it without ``nvcc``.  ``NVCC_FLAGS`` are the
flags of the next build: no ``--use_fast_math`` (its sin and cos are too
coarse for photon-ring rays), and ``-fmad=false``, with which the kernel
follows the eager torch march op for op in float32.  ``with_flags`` derives
a variant for measurement.

``instance_of`` gives the instance a metric launches: its struct emitted at
the metric's first use in the process (``emitted_instance``), dynamic (the
parameters are launch arguments) or, for a baked metric
(``runtime.hotswap.bake``), baked: traced with its values as Python floats
and built with ``GRT_BAKED_PARAMS`` (a header line), so that the library
reports the values it has compiled in; a baked metric launches with its own
values, and a library whose compiled-in values are not its instance's is
refused when it is loaded.

Each library also holds the render-data kernel of its metric
(``csrc/render_data.cuh``; ``render_data_cuda``): after the march, the
snap of every endpoint to the universe sphere, the frame basis there,
z_shift and the texture coordinates in one launch, bit for bit
``render.pipeline.compute_render_data_reference`` on the card, in place of
its ~2,600 eager ops.  ``render.pipeline.compute_render_data`` takes it
for every state on the card but one that asks for a gradient.  So does the
observer tetrad at the camera's one point (``csrc/observer.cuh``;
``observer_tetrad_cuda``): the frame basis, orientation and boost in one
launch of one thread, bit for bit ``camera.observer_tetrad_reference`` on
the card in place of its ~2,760 eager ops, taken by
``camera.observer_tetrad``.  And so does every ray's launch state
(``csrc/launch_state.cuh``; ``launch_state_cuda``): the pixel's direction,
the planar rotation, the null fix, the launch acceleration, the step seed
and ku_uobsu in one launch, bit for bit
``render.pipeline.rays_for_pixels_reference`` on the card in place of its
eager jvp over the whole batch, taken by ``render.pipeline.rays_for_pixels``.
``asks_for_grad`` is the rule that sends a call to the eager twins instead:
the kernels are forward-only.

The wrappers launch on CUDA tensors or raise: there is no fallback, and an
unregistered metric, or one that differs from the registered metric of its
name (``check_compiled_metric``), raises ``NotImplementedError``; so does a
metric the emitter cannot emit, naming the op.  Its plain twin is
``integrate.trace_rays_reference``.
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
from ..utils import profiling
from .integrate import Features, RayState, TraceOptions, schedule_constants

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grt_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# What an emitted struct has compiled in besides the metric function: the
# MetricConfig fields the step branches on and the chart.  (The config's
# max_acceleration_change travels in Features, at run time.)
COMPILED_CONFIG = ("adaptive_precision", "detect_singularities", "singular",
                   "singular_terminator", "has_cylindrical_singularity",
                   "cylindrical_terminator", "unconditionally_nonsingular",
                   "coordinate_system", "to_polar", "from_polar",
                   "origin_distance")

# Kernel launches made by trace_rays_cuda (one per call), by the label of
# the instance launched (the metric's name for its dynamic instance); each
# also adds to the open frame's ``launches`` counter (``utils.profiling``).
LAUNCHES_BY_METRIC: dict = {}


@dataclasses.dataclass(frozen=True)
class Instance:
    """The metric a kernel library is built for.  ``label``: its key in
    ``LAUNCHES_BY_METRIC`` and ``BUILD_INFO`` (the metric's name for the
    metric's dynamic instance); ``metric``: the metric's name; ``struct``:
    the emitted struct (in namespace ``grt``); ``params``: the parameters in
    the struct's order; ``header``: the emitted header's text; ``baked``:
    the float32 parameter values compiled in, or None."""

    label: str
    metric: str
    struct: str
    params: tuple
    header: str
    baked: tuple | None = None


# (metric name, id(fn), id(rank1), what else the struct compiles in, baked
# values) -> (Instance, fn, rank1: kept so that their ids are not reused)
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


def _unbaked(metric: Metric) -> Metric:
    if isinstance(metric.fn, BakedFn):
        rank1 = metric.rank1
        return dataclasses.replace(
            metric, fn=metric.fn.fn,
            rank1=rank1.fn if isinstance(rank1, BakedFn) else rank1)
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
    key = (metric.name, id(metric.fn), id(metric.rank1),
           tuple(metric.defaults), metric.config, metric.depends_on,
           metric.spherically_symmetric, metric.structure, metric.diagonal,
           values)
    with _lock:
        hit = _emitted.get(key)
    if hit is None:
        h = emit.emit_metric(metric, params)
        label = metric.name if values is None else f"{metric.name} [baked]"
        inst = Instance(label=label, metric=metric.name, struct=h.struct,
                        params=h.params, header=h.text, baked=h.baked)
        with _lock:
            hit = _emitted.setdefault(key, (inst, metric.fn, metric.rank1))
    return hit[0]


def instance_of(metric: Metric) -> Instance:
    """The instance ``trace_rays_cuda`` launches for ``metric`` (checked by
    ``check_compiled_metric``): the struct emitted from its function, baked
    where the metric is (``runtime.hotswap.bake``)."""
    check_compiled_metric(metric)
    params = dict(metric.fn.params) if isinstance(metric.fn, BakedFn) \
        else None
    return emitted_instance(metric, params)


def check_compiled_metric(metric: Metric) -> None:
    """Raise NotImplementedError unless ``metric`` is the registered metric
    of its name, whose struct the kernel is built with: its function, its
    rank-1 decomposition (which picks the acceleration path),
    ``depends_on``, symmetry flag (it sets the precision weights) and every
    ``COMPILED_CONFIG`` field.  A metric whose config was replaced has no
    instance, whatever its name.  A baked metric is held so by the function
    it was baked from."""
    from ..metrics import REGISTRY

    metric = _unbaked(metric)
    known = REGISTRY.get(metric.name)
    if known is None:
        raise NotImplementedError(
            f"no ray-march kernel instance for metric {metric.name!r}: a "
            "registered metric's struct is emitted (a content pack registers "
            "its metrics)")
    differs = [
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


def library_path(inst: Instance, flags=None) -> Path:
    """Where ``build`` puts the library of ``inst`` for ``flags`` (default:
    ``NVCC_FLAGS``): keyed on ``source_hash``, the emitted header's text and
    the baked values.  Its ptxas report lies beside it (``.ptxas.txt``)."""
    baked = "" if inst.baked is None else baked_define(inst.baked)
    tag = hashlib.sha256("\0".join(
        (source_hash(flags), inst.header, baked)).encode()).hexdigest()[:16]
    # Named by the struct: a metric's name may hold spaces and parentheses.
    return BUILD_DIR / f"libgrt_raymarch_{inst.struct}_{tag}.so"


def build(inst: Instance, flags=None) -> Path:
    """Compile ``csrc/raymarch.cu`` for ``inst`` (its emitted header given
    with ``-include``) with ``flags`` (default: ``NVCC_FLAGS``) unless a
    library for the current sources, header, baked values and these flags
    exists.  Prints the ptxas register/spill report once."""
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


def build_all(instances=None, flags=None) -> float:
    """Build the libraries of ``instances`` (default: the instance of every
    registered metric) at once, one ``nvcc`` process each.  Returns the wall
    seconds."""
    from ..metrics import REGISTRY

    if instances is None:
        instances = [instance_of(REGISTRY[n]) for n in sorted(REGISTRY)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(instances)) as pool:
        list(pool.map(lambda i: build(i, flags), instances))
    return time.perf_counter() - t0


def get_lib(inst: Instance):
    """The kernel library of ``inst`` for the current ``NVCC_FLAGS``, loaded
    (and built at first use)."""
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
            lib.grt_render_data.restype = ctypes.c_int
            lib.grt_render_data.argtypes = [
                fp, fp, *[ctypes.c_int] * 3, *[vp] * 8,
                ctypes.POINTER(ctypes.c_longlong), *[vp] * 6]
            lib.grt_observer_tetrad.restype = ctypes.c_int
            lib.grt_observer_tetrad.argtypes = [fp, *[vp] * 7]
            lib.grt_launch_state.restype = ctypes.c_int
            lib.grt_launch_state.argtypes = [
                fp, fp, *[ctypes.c_int] * 2, *[vp] * 6,
                ctypes.POINTER(ctypes.c_longlong), *[vp] * 12]
            _libs[key] = (inst, lib)
        return _libs[key][1]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.grt_error_string(rc).decode()} ({rc})")


def kernel_config(inst: Instance) -> dict:
    """``{"threads", "blocks_per_sm"}`` of ``inst``'s kernel (the instance
    of the default options): its block size and the blocks of it that one
    SM holds at once."""
    lib = get_lib(inst)
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


def _check(name, t: torch.Tensor, shape, dtype, what="trace_rays_cuda",
           contiguous=True):
    if not t.is_cuda:
        raise ValueError(f"{what}: {name} is on {t.device}, "
                         "the kernel needs CUDA tensors")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} is {t.dtype} "
                         f"{tuple(t.shape)}, expected {dtype} {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def _param_values(metric: Metric, inst: Instance, params, what: str) -> tuple:
    """The float32 values of ``inst``'s parameters that a launch takes: a
    baked metric's own (``runtime.hotswap.bake``), as its function evaluates
    with them.  Raises for a parameter that requires grad."""
    if isinstance(metric.fn, BakedFn):
        params = dict(metric.fn.params)
    if any(isinstance(params[k], torch.Tensor) and params[k].requires_grad
           for k in inst.params):
        # The kernel is forward-only: it takes the parameters as host
        # floats, and a gradient through them would be lost without a word.
        raise ValueError(f"{what}: a parameter requires grad; the "
                         "kernel takes detached host floats")
    return tuple(float(np.float32(float(params[k]))) for k in inst.params)


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
    param_names = inst.params
    values = _param_values(metric, inst, params, "trace_rays_cuda")

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
    profiling.count("launches")
    return out


def render_data_cuda(metric: Metric, state: RayState, ku_uobsu: torch.Tensor,
                     polar: torch.Tensor, polar_vel: torch.Tensor, params,
                     features: Features,
                     inv_quat: torch.Tensor | None = None) -> tuple:
    """The render data of every endpoint of ``state`` by the render-data
    kernel of ``metric``'s library (``csrc/render_data.cuh``): one launch on
    the current stream, no wait for the device.  ``polar`` and
    ``polar_vel`` are the (4, N) polar position and velocity of the chart
    (``metric.to_polar``, ``to_polar_velocity``), read through their
    strides; ``inv_quat`` the planar rays' (4, N) inverse quaternions, or
    None.  Returns ``(tex_coord (N, 2), z_shift (N,), side (N,) int32,
    terminated (N,) int32, angles (N, 2))``, bit for bit the fields of
    ``render.pipeline.compute_render_data_reference`` on the card.  Each
    call adds to the open frame's ``render_data_kernel`` counter."""
    what = "render_data_cuda"
    inst = instance_of(metric)
    values = _param_values(metric, inst, params, what)
    n = state.position.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, shape, dtype in (
            ("position", state.position, (n, 4), f32),
            ("velocity", state.velocity, (n, 4), f32),
            ("running_dlambda_dnew", state.running_dlambda_dnew, (n,), f32),
            ("status", state.status, (n,), i32),
            ("ku_uobsu", ku_uobsu, (n,), f32)):
        _check(name, t, shape, dtype, what)
    quat = () if inv_quat is None else (("inv_quat", inv_quat),)
    for name, t in (("polar", polar), ("polar_vel", polar_vel), *quat):
        _check(name, t, (4, n), f32, what, contiguous=False)
    strides = (ctypes.c_longlong * 6)(
        *polar.stride(), *polar_vel.stride(),
        *((0, 0) if inv_quat is None else inv_quat.stride()))

    cfg = metric.config
    # The radii as the eager ops cast their Python scalars to float32.
    r_u, r_t = float(features.universe_size), float(cfg.singular_terminator)
    consts = (ctypes.c_float * 3)(r_u * r_u, r_t * r_t, 0.5 * (r_u + r_t))
    mparams = (ctypes.c_float * max(len(values), 1))(*values)
    dev = state.position.device
    tex = torch.empty((n, 2), dtype=f32, device=dev)
    z_shift = torch.empty((n,), dtype=f32, device=dev)
    side = torch.empty((n,), dtype=i32, device=dev)
    terminated = torch.empty((n,), dtype=i32, device=dev)
    angles = torch.empty((n, 2), dtype=f32, device=dev)
    lib = get_lib(inst)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_render_data(
            mparams, consts, int(cfg.singular),
            int(cfg.traversable_event_horizon), n,
            state.position.data_ptr(), state.velocity.data_ptr(),
            state.running_dlambda_dnew.data_ptr(), state.status.data_ptr(),
            ku_uobsu.data_ptr(), polar.data_ptr(), polar_vel.data_ptr(),
            None if inv_quat is None else inv_quat.data_ptr(), strides,
            tex.data_ptr(), z_shift.data_ptr(), side.data_ptr(),
            terminated.data_ptr(), angles.data_ptr(), stream)
    _raise_on(lib, rc, "render-data kernel launch")
    profiling.count("render_data_kernel")
    return tex, z_shift, side, terminated, angles


def observer_tetrad_cuda(metric: Metric, position: torch.Tensor, axes,
                         params,
                         basis_speed3: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """The observer tetrad at the generic ``position`` (4,) by the
    observer kernel of ``metric``'s library (``csrc/observer.cuh``): one
    launch of one thread on the current stream, no wait for the device.
    ``axes``: the generic axes ``(gx, gy, gz)`` (4,) of the chart part
    (``camera.generic_axes``); ``basis_speed3``: the frame 3-speed (3,),
    None at rest.  Returns ``es`` (4, 4), bit for bit
    ``camera.observer_tetrad_reference`` on the card.  Each call adds to the
    open frame's ``camera_kernel`` counter."""
    what = "observer_tetrad_cuda"
    inst = instance_of(metric)
    values = _param_values(metric, inst, params, what)
    speed = () if basis_speed3 is None else (basis_speed3,)
    ins = [t.contiguous() for t in (position, *axes, *speed)]
    for name, t, n in zip(("position", "gx", "gy", "gz", "basis_speed3"),
                          ins, (4, 4, 4, 4, 3)):
        _check(name, t, (n,), torch.float32, what)
    mparams = (ctypes.c_float * max(len(values), 1))(*values)
    dev = position.device
    es = torch.empty((4, 4), dtype=torch.float32, device=dev)
    lib = get_lib(inst)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_observer_tetrad(
            mparams, *(t.data_ptr() for t in ins[:4]),
            ins[4].data_ptr() if speed else None, es.data_ptr(), stream)
    _raise_on(lib, rc, "observer-tetrad kernel launch")
    profiling.count("camera_kernel")
    return es


def launch_state_cuda(metric: Metric, params, features: Features,
                      position: torch.Tensor, es: torch.Tensor, *,
                      sign: float, planar: bool = False,
                      pixels: tuple | None = None,
                      generic: tuple | None = None) -> tuple:
    """The launch state of every ray by the launch-state kernel of
    ``metric``'s library (``csrc/launch_state.cuh``): one launch on the
    current stream, no wait for the device.  ``position`` (4,) and ``es``
    (4, 4) are the camera's generic position and observer tetrad.  The rays
    are either ``pixels`` = ``(cx, cy, width, height, f_stop, quat)``: the
    pixel coordinates (N,) of the width x height image, the focal length (a
    0-d tensor, ``camera.focal_length``) and the camera quaternion (4,),
    traced with ``sign`` (``render.pipeline._trace_sign``) and, with
    ``planar``, rotated into the equator of the metric's identity chart; or
    ``generic`` = ``(pos, vel)``: generic positions and velocities (4, N),
    read through their strides (a chart's eager ``to_planar`` made them).
    Returns ``(state, ku_uobsu, inv_quat)``, bit for bit
    ``render.pipeline.rays_for_pixels_reference`` on the card (``inv_quat``
    (4, N) for planar pixel rays, else None).  Each call adds to the open
    frame's ``launch_state_kernel`` counter."""
    what = "launch_state_cuda"
    if (pixels is None) == (generic is None):
        raise ValueError(f"{what}: give pixels or generic rays, not both")
    inst = instance_of(metric)
    values = _param_values(metric, inst, params, what)
    f32, i32 = torch.float32, torch.int32
    position, es = position.contiguous(), es.contiguous()
    _check("position", position, (4,), f32, what)
    _check("es", es, (4, 4), f32, what)
    strides = (ctypes.c_longlong * 4)()
    if pixels is not None:
        cx, cy, width, height, f_stop, quat = pixels
        n = cx.shape[0]
        cx, cy = cx.contiguous(), cy.contiguous()
        quat, f_stop = quat.contiguous(), f_stop.reshape(1)
        for name, t, shape in (("cx", cx, (n,)), ("cy", cy, (n,)),
                               ("f_stop", f_stop, (1,)),
                               ("quat", quat, (4,))):
            _check(name, t, shape, f32, what)
        ins = (cx, cy, f_stop, quat, None, None)
    else:
        gpos, gvel = generic
        n = gpos.shape[1]
        for name, t in (("pos", gpos), ("vel", gvel)):
            _check(name, t, (4, n), f32, what, contiguous=False)
        strides[:] = (*gpos.stride(), *gvel.stride())
        width = height = 0
        ins = (None, None, None, None, gpos, gvel)
    # width / 2.0 and height / 2.0 as the eager ops cast them to float32.
    consts = (ctypes.c_float * 4)(width / 2.0, height / 2.0, float(sign),
                                  float(features.max_acceleration_change))
    mparams = (ctypes.c_float * max(len(values), 1))(*values)
    dev = position.device
    state = RayState(
        position=torch.empty((n, 4), dtype=f32, device=dev),
        velocity=torch.empty((n, 4), dtype=f32, device=dev),
        acceleration=torch.empty((n, 4), dtype=f32, device=dev),
        next_ds=torch.empty((n,), dtype=f32, device=dev),
        running_dlambda_dnew=torch.empty((n,), dtype=f32, device=dev),
        status=torch.empty((n,), dtype=i32, device=dev),
        steps=torch.empty((n,), dtype=i32, device=dev))
    ku = torch.empty((n,), dtype=f32, device=dev)
    inv_quat = (torch.empty((4, n), dtype=f32, device=dev)
                if planar and pixels is not None else None)
    lib = get_lib(inst)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grt_launch_state(
            mparams, consts, int(planar), n,
            *(None if t is None else t.data_ptr() for t in ins), strides,
            position.data_ptr(), es.data_ptr(),
            *(t.data_ptr() for t in state), ku.data_ptr(),
            None if inv_quat is None else inv_quat.data_ptr(), stream)
    _raise_on(lib, rc, "launch-state kernel launch")
    profiling.count("launch_state_kernel")
    return state, ku, inv_quat


def asks_for_grad(*tensors, params) -> bool:
    """Grad mode is on and one of ``tensors`` (None skipped) or a parameter
    requires grad: such a call takes the kernels' eager twins, which
    differentiate (the kernels take detached host floats)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (*tensors, *params.values()))


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
