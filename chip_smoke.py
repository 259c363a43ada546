"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py [--profile] [--kernel-flags "..."]
    python3 chip_smoke.py --sweep ["flags; flags; ..."]

Builds the ray-march kernel from ``geodesic_raytracing_tpu_torch/csrc`` (one
library per metric instance, all at once), checks it against its plain
eager-torch twin on the card, drives the port's main paths through
``render_frame`` at 1920x1080 ``kerr_boyer``: the dense frame (one launch,
its rays marched by the plain twin for their first ``PLAIN_DEPTH`` trial
iterations) and the adaptive flagship frame of ``flagship_config`` as it
comes (prepass, quarter grid and refinement: three launches in a first
frame, two in a steady one; the first frame's prepass launch and each launch
of the 480x270 frame marched once more by the plain twin).  It counts each
launch's work (steps, trial iterations, idle lanes), holds the kernel's time
against its bound, holds the adaptive frame against the dense one and the
kernel frames against the plain frames at 480x270, checks that a steady
adaptive frame never waits for the device, times both frames stage by stage,
and runs the CLI on the card.  Then the second path: every other kernel
instance (4-D and planar) and the step options (Euler, reparameterisation)
against the plain march; the ``schwarzschild`` frame in planar mode at
1920x1080, adaptive and dense, its dense, quarter and refine launches and
each launch of its 480x270 twin against the plain march; planar against 4-D;
the 128x128 golden scenes of every metric and ``kerr_redshift``; and a dense
1080p frame of every metric through ``render_frame``, its launch against the
plain march for ``DENSE_PLAIN_DEPTH`` trial iterations.
Then the third path: the differentiable fit at ``scripts/fit_bench.py``'s
size (``kerr_boyer`` 256x256, a 2048-step budget, an 896-iteration scan in
windows of 128): its target, the train step's probe launch against the plain
march and its scan against the probe, its gradient against the central
difference, a timed train step and the ``fit`` CLI; and the geodesic
camera: a 4096-step recording on the card against the CPU's (and where the
two part), the tetrad's transport, and the adaptive 1080p frame from that
camera, its 480x270 twin's launches against the plain march.  Then the
fourth, fifth and sixth paths: the adaptive 1080p frame of each metric of
catalogue slices A, B and C (first, warm and steady frames, launches counted,
against its dense frame, a steady frame without host synchronisation, stage
times) and the CLI's adaptive 1080p ``kerr_newman_boyer`` frame.  Slice B's
instances also enter phase 14 (after a probe of the forward-mode rules torch
applies on the card, ``tangent_rules``), 18 (with ``alcubierre_paper``) and
19, each scene with its preset camera and Features (``SCENES``); so do slice
C's six (the rank-1 Kerr-Schild acceleration and the complex pairs), whose
scenes take the flagship camera: with them the kernel has all 31 metric
instances of the JAX registry.  Every plain march on
the card replays its step from a CUDA graph (``trace_rays_reference``'s
default there), held bit for bit to the eager march in phases 2 and 14.
``--profile`` adds a ``torch.profiler`` trace of one steady frame of each
kind (kernel counts, device busy time, idle share).  ``--kernel-flags`` appends
nvcc flags to the kernel's build, to run every check on a variant of it.
Every failed check raises, so the script exits non-zero; it also refuses to
run (exit 2, no result) without a CUDA GPU.

``--sweep`` runs no check of the port: it builds the kernel once for each set
of nvcc flags (default ``SWEEP``: the steps of the kernel's design), marches
the 1080p and the 480x270 frame's rays with each in turns, and prints each
variant's registers, times, idle lanes and its agreement with the first.

Output, one line per phase, then the kernel table as one JSON line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import shlex
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Ray-set tolerances on the card: transcendentals differ in the last ulp
# between the kernel and torch's CUDA ops, and photon-ring rays amplify a
# 1e-7 seed by about one bit per step, so a few fates and step counts may
# differ; positions are compared where the step counts agree.
SET_A_MIN_STEPS_EQ = 62  # of 64, status equal on all
SET_B_MIN_STATUS_EQ = 0.995
SET_B_MIN_STEPS_EQ = 0.98
POS_TOL = 1e-4  # rtol and atol
# Phase 3 marches the 1080p frame's rays with the plain twin for this many
# trial iterations (its longest ray takes 10,230).
PLAIN_DEPTH = 2048
# Phase 14 holds the graphed plain march to the eager one on each
# instance's 64-ray set for this many trial iterations (phase 2: kerr_boyer's
# to the end).
GRAPH_CHECK_STEPS = 64
# The golden gate of tests/test_parity_images.py on sRGB uint8 images.
GATE_RMSE = 4.0
GATE_BAD_FRAC = 0.01
# Estimated shadow: ~22 deg angular radius of a 90 deg fov ~ 23% of pixels.
SHADOW_RANGE = (0.10, 0.40)

# The kernel's bound.  Peaks of one H100 SXM (NVIDIA's data sheet): float32
# outside the tensor cores, counting a fused multiply-add as two; HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Bytes per ray, read once and written once: 3 float4 rows, next_ds, rdl,
# status, steps (the launch |v^t| is read only).
RAY_BYTES_RW = 3 * 16 + 4 * 4
RAY_BYTES_RO = 4
# Float32 operations of one trial iteration, counted from csrc/march.cuh with
# the pruned duals of csrc/dual.cuh (an add, a multiply, a compare or select,
# and each of sin, cos, 1/x, sqrt, rsqrt as one; negations, |x| and products
# with a seed's 1 as none): 65 in the metric with its partials, 89 in the
# contraction and the pruned inverse, 111 in the trial step, the probe and
# the step controller.
OPS_PER_TRIAL = 65 + 89 + 111
# The same count for every instance, by the same rule, as (metric with its
# partials) + (contraction and pruned inverse) + (step, probe, controller),
# keyed by (metric, planar).  The adaptive Verlet step is Kerr's 111; planar
# mode drops theta's trial position and velocity (10); the scheduled step has
# 6 operations where the controller has 36; a singular terminator adds a
# compare; a cartesian chart's r adds 6.  PERF.md section 6 has the terms.
OPS_BY_INSTANCE = {
    ("kerr_boyer", False): OPS_PER_TRIAL,
    ("schwarzschild", False): 20 + 46 + 111,
    ("schwarzschild", True): 15 + 34 + 101,
    ("schwarzschild_fast", False): 20 + 46 + 82,
    ("schwarzschild_fast", True): 15 + 34 + 72,
    ("schwarzschild_skewed", False): 18 + 46 + 111,
    ("schwarzschild_ingoing_ef", False): 17 + 43 + 111,
    ("schwarzschild_ingoing_ef", True): 12 + 31 + 101,
    ("de_sitter", False): 22 + 46 + 81,
    ("de_sitter", True): 17 + 34 + 71,
    ("minkowski", False): 87,
    ("minkowski_skew", False): 87,
    # Catalogue slice A, by the same rule.  A constant entry (a literal) folds
    # away, and its products with it; a cylindrical chart's r adds 4, the
    # Misner chart's (two exp) 11; no singularity kill takes 2 less.
    ("wormhole (morris-thorne)", False): 13 + 24 + 81,
    ("wormhole (morris-thorne)", True): 8 + 16 + 71,
    ("black_hole_cosmic_string", False): 24 + 46 + 111,
    ("ernst", False): 69 + 59 + 111,
    ("kerr_newman_boyer", False): 129 + 89 + 111,
    ("kerr_ingoing_ef", False): 80 + 105 + 111,
    ("kerr_rational_polynomial", False): 73 + 89 + 111,
    ("misner_4d", False): 0 + 5 + 122,
    ("cosmic_string_spinning", False): 5 + 20 + 117,
    # Catalogue slice B, by the same rule, each libm call (exp, log, log1p,
    # tanh, powf) counted as one, as sin is; the polynomial arctan of the
    # reference is its 26 operations.  A tangent costs one operation a live
    # tangent for a unary rule, three for a product of two duals that both
    # carry it; tanh's fused 1 - y*y counts two.  No blow-up test takes 5
    # less; the cartesian chart's r adds 6 and alcubierre_origin (the
    # chart's two arctan2, two sincos) 89 more.
    ("janis_newman_winicour", False): 48 + 46 + 109,
    ("janis_newman_winicour", True): 42 + 34 + 99,
    ("schwarzschild_ingoing_ef_hawking", False): 47 + 51 + 111,
    ("schwarzschild_ingoing_ef_hawking", True): 41 + 39 + 101,
    ("configurable_wormhole", False): 77 + 24 + 109,
    ("configurable_wormhole", True): 71 + 16 + 99,
    ("ellis_drainhole", False): 84 + 80 + 81,
    ("ellis_drainhole", True): 78 + 60 + 71,
    ("symmetric_warp_drive", False): 116 + 46 + 112,
    ("alcubierre", False): 89 + 110 + 199,
    ("krasnikov_tube", False): 114 + 110 + 115,
    ("krasnikov_cylindrical", False): 89 + 85 + 113,
    ("godel_cylindrical", False): 29 + 30 + 116,
    # Catalogue slice C.  The Kerr-Schild instances by hand, by the same
    # rule: the decomposition (f, l) with three tangents (x, y, z; 159, and
    # 170 with the charge term), the rank-1 contraction and Sherman-Morrison
    # of csrc/march.cuh (97), the step with the cartesian chart's r (117).
    # The two-body instances: double_schwarzschild's metric by hand (260);
    # the complex potentials' metric with its two tangents counted by the
    # same rule by scripts/torch_opcount.py from the kernel's own code
    # (multibody.cuh and complex.cuh after inlining, the dead tangents and
    # the Zero imaginary parts folded away, common terms shared: 984, 1,563,
    # 1,182; the script gives 0.90-1.02 of the hand counts of the Kerr
    # family, double_schwarzschild and ernst); the contraction and the
    # pruned inverse of the five entries, each carrying both tangents, by
    # march.cuh's folding (92; 62 for the diagonal); the step with the
    # cylindrical chart's r (115, and 116 with the cylindrical terminator).
    # The double-Kerr instances spill (PERF.md section 6): their
    # local-memory traffic is not counted here.
    ("kerr_schild", False): 159 + 97 + 117,
    ("kerr_newman_schild", False): 170 + 97 + 117,
    ("double_schwarzschild", False): 260 + 62 + 116,
    ("double_kerr", False): 984 + 92 + 115,
    ("double_kerr_alt", False): 1563 + 92 + 115,
    ("double_unequal_kerr", False): 1182 + 92 + 115,
}
# The metrics of catalogue slice A, the fourth path (phase 26).
CATALOGUE_A = ("black_hole_cosmic_string", "cosmic_string_spinning", "ernst",
               "kerr_ingoing_ef", "kerr_newman_boyer",
               "kerr_rational_polynomial", "misner_4d",
               "wormhole (morris-thorne)")
# The metrics of catalogue slice B, the fifth path (phases 14, 18, 19, 26).
CATALOGUE_B = ("alcubierre", "configurable_wormhole", "ellis_drainhole",
               "godel_cylindrical", "janis_newman_winicour",
               "krasnikov_cylindrical", "krasnikov_tube",
               "schwarzschild_ingoing_ef_hawking", "symmetric_warp_drive")
# The metrics of catalogue slice C, the sixth path (phases 14, 18, 19, 26).
CATALOGUE_C = ("double_kerr", "double_kerr_alt", "double_schwarzschild",
               "double_unequal_kerr", "kerr_newman_schild", "kerr_schild")
CATALOGUES = CATALOGUE_A + CATALOGUE_B + CATALOGUE_C
# Phase 19 marches each metric's 1080p launch with the plain twin for this
# many trial iterations, against a kernel launch with that budget (a cut of
# depth: the longest rays of black_hole_cosmic_string, ernst and the Kerr
# family take 2,400-16,400, krasnikov_cylindrical's 6,037; every other
# metric's rays end within it, so those are held to the end).
DENSE_PLAIN_DEPTH = 1024
class RaySet(NamedTuple):
    """How phase 14 (and the host tests) adapt ``make_rays``' set to a
    metric: a factor on the phi velocity, the sign of v^t, the polar launch
    time, and how many rays at the front of the set start at r = 0.05 aimed
    at the centre (v^phi = 0)."""

    phi_scale: float = 1.0
    time_sign: float = 1.0
    t0: float = 0.0
    radial: int = 0


# Where make_rays' set would give a metric no escaped ray, or would miss a
# branch the metric sets: black_hole_cosmic_string's g_phph carries
# B^2 = 0.09, so the set's impact parameters shrink by B and every ray falls
# in (phi velocity / 0.3); misner_4d's chart ends at x = t, which a ray
# forward in time reaches before it escapes (the renderer traces backward in
# time); godel_cylindrical's rays launched next to the axis and aimed at it
# die at its cylindrical terminator (p < 0.005: from r = 7 the frame
# dragging of g_tphi gives a ray aimed at the axis an angular momentum that
# keeps it 0.03 away); symmetric_warp_drive at t = 10, its scene's time
# (at t = 0 rays linger inside the warp shell for the whole step budget).
RAY_SET = {"black_hole_cosmic_string": RaySet(phi_scale=1 / 0.3),
           "misner_4d": RaySet(time_sign=-1.0),
           "godel_cylindrical": RaySet(radial=4),
           "symmetric_warp_drive": RaySet(t0=10.0)}


def ray_set(name, n, tilt=0.0):
    """``make_rays(n)`` (polar position and velocity, numpy) adapted to the
    metric ``name`` by ``RAY_SET``; ``tilt`` is a theta velocity that takes
    the rays off the equator."""
    pos, vel = make_rays(n)
    rs = RAY_SET.get(name, RaySet())
    vel[:, 2] = tilt
    vel[:, 3] *= rs.phi_scale
    vel[:rs.radial, 3] = 0.0
    pos[:rs.radial, 1] = 0.05
    vel[:, 0] *= rs.time_sign
    pos[:, 0] = rs.t0
    return pos, vel


# The scenes of scripts/make_goldens.py that differ from the flagship camera
# (polar (t, r, theta, phi) = (0, 7, pi/2, -pi/2), pitch -90 degrees), as
# (camera polar position, Features overrides):
#   misner_4d at t = -2 (the reference's scripts/misner_4d.json:18, "Camera
#   time should be set < 0"; at t = 0 the camera sits on the branch cut of
#   polar_to_misner_4d, log((x - t) / 2) with x = 0);
#   alcubierre side-on at r = 4 (the bubble's lensing ring fills the frame;
#   from r = 7 it is nearly unlensed) and alcubierre_paper on the travel
#   axis (phi = 0) at r = 4, the bubble moving toward the camera;
#   the Krasnikov tubes at t = 20 and t = 10 (the tube forms with time: at
#   t = 0 the scene is flat space);
#   symmetric_warp_drive at t = 10 with universe and precision radius 100
#   (its scripts/symmetric_warp_drive.json:9 preset).
_SIDE = (7.0, math.pi / 2, -math.pi / 2)
SCENES = {
    "misner_4d": ((-2.0, *_SIDE), {}),
    "alcubierre": ((0.0, 4.0, math.pi / 2, -math.pi / 2), {}),
    "alcubierre_paper": ((0.0, 4.0, math.pi / 2, 0.0), {}),
    "krasnikov_tube": ((20.0, *_SIDE), {}),
    "krasnikov_cylindrical": ((10.0, *_SIDE), {}),
    "symmetric_warp_drive": ((10.0, *_SIDE), dict(
        universe_size=100.0, max_precision_radius=100.0)),
}
# Golden scenes of a metric under another key: key -> (metric, settings
# overrides).
SCENE_METRIC = {"kerr_redshift": ("kerr_boyer", dict(redshift=True)),
                "alcubierre_paper": ("alcubierre", {})}


# The planar frame against the 4-D one (tests/test_integrator.py's
# test_planar_mode_matches_full_4d): fates equal on this share of the pixels
# (the 4-D march has a polar-axis artifact the planar one has not), and the
# median angle between the escape directions, in degrees.
PLANAR_MIN_FATES_EQ = 0.95
PLANAR_MAX_MEDIAN_DEG = 1.0
# RMSE limits of golden scenes that differ from GATE_RMSE: de_sitter's rays
# cross its cosmological horizon (r = 17.3, inside the universe sphere) with a
# scheduled step and a tenth of them are flung to |r| of 1e3 to 6e4, so where
# they end amplifies the last ulp (tests/test_torch_render_simple.py).
GOLDEN_RMSE = {"de_sitter": 10.0}

# The adaptive 1080p frame against the dense one, as the JAX package's own
# test of its adaptive path states it: share of pixels whose largest channel
# difference is above 0.1, and the median of that difference.
ADAPTIVE_MAX_OFF_FRAC = 0.06
ADAPTIVE_MAX_MEDIAN = 0.01
# Above this idle-lane factor of the refine launch a cost sort of its rays is
# worth measuring (phase 13).
SORT_IDLE_FACTOR = 1.10

# --sweep: the kernel's design, step by step.  The first variant is the
# simple kernel (unpruned duals, separate sinf and cosf, 32 rays of a row per
# warp, no bound on registers); each later one is compared with it.
_ROWS = "-DGRT_MIN_BLOCKS=1 -DGRT_ROW_WARPS"
SWEEP = (
    f"{_ROWS} -DGRT_SEPARATE_TRIG -DGRT_FULL_TANGENTS",
    f"{_ROWS} -DGRT_SEPARATE_TRIG",
    _ROWS,
    "-DGRT_MIN_BLOCKS=1",
    "-DGRT_MIN_BLOCKS=3",
    "",
    "-DGRT_THREADS=64 -DGRT_MIN_BLOCKS=16",
    "-DGRT_THREADS=128 -DGRT_MIN_BLOCKS=8",
    "-DGRT_THREADS=512 -DGRT_MIN_BLOCKS=2",
    "-fmad=true",
)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_rays(n, r0=7.0):
    """The ray set of tests/test_integrator.py::make_rays."""
    pos = np.tile([0.0, r0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    angles = np.linspace(0.05, 0.8, n)
    vel = np.stack([np.ones(n), -np.cos(angles), np.zeros(n),
                    np.sin(angles) / r0], axis=-1).astype(np.float32)
    return pos, vel


def compare_states(k, p):
    """(status equal, steps equal, max |dpos| over escaped rays with equal
    steps, positions within POS_TOL there) of kernel vs plain states."""
    import torch

    st_eq = k.status == p.status
    sp_eq = k.steps == p.steps
    ok = (p.status == 1) & sp_eq
    kp, pp = k.position[ok], p.position[ok]
    err = float((kp - pp).abs().max()) if kp.numel() else 0.0
    close = bool(torch.allclose(kp, pp, rtol=POS_TOL, atol=POS_TOL))
    return int(st_eq.sum()), int(sp_eq.sum()), err, close


def idle_lane_factor(trials, width=None, tile=(8, 4)):
    """32 x (sum over warps of the warp's largest count) / (sum of counts),
    for a kernel that gives warp w the rays 32w .. 32w + 31 of ``trials``
    (N,) in index order; with ``width``, for ``tile`` (wide, high) pixel
    tiles of the row-major image of that width instead."""
    import torch

    t = trials.to(torch.int64)
    if width is not None:
        (tw, th), h = tile, t.numel() // width
        t = t.reshape(h, width)
        t = torch.nn.functional.pad(t, (0, -width % tw, 0, -h % th))
        t = t.reshape(t.shape[0] // th, th, t.shape[1] // tw, tw).permute(
            0, 2, 1, 3)
    t = torch.nn.functional.pad(t.reshape(-1), (0, -t.numel() % 32))
    return float(32 * t.reshape(-1, 32).max(dim=1).values.sum() / t.sum())


def bound_ms(n_rays: int, total_trials: int, ops_per_trial=OPS_PER_TRIAL):
    """(bound, operations bound, bytes bound) in ms of a launch that marches
    ``n_rays`` rays through ``total_trials`` trial iterations of
    ``ops_per_trial`` float32 operations each."""
    ops = total_trials * ops_per_trial / PEAK_FP32_FLOPS * 1e3
    byt = n_rays * (2 * RAY_BYTES_RW + RAY_BYTES_RO) / PEAK_BYTES_PER_S * 1e3
    return max(ops, byt), ops, byt


def median_launch_ms(metric, state, params, feats, opts, width, rounds=3):
    """Median kernel time (CUDA events) of ``rounds`` launches on
    ``state``."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import raymarch

    ms = []
    for _ in range(rounds):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        raymarch.trace_rays_cuda(metric, state, params, feats, opts,
                                 image_width=width)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(ms)


def launch_work(metric, state, params, feats, opts, width) -> dict:
    """One kernel launch on ``state`` (the pixels of a row-major image of
    ``width``) that counts its work: ``state`` (the output), ``per_ray``
    and ``trials`` (each ray's and all trial iterations), ``mean_steps``,
    ``max_steps`` (committed), and the idle-lane factor (lane turns of the
    march loop, busy or idle, over the trial iterations) of warps of 32 rays
    in index order (``idle_rows``), of 8x4 pixel tiles (``idle_tiles``) and
    of this launch (``idle_factor``: the rows' if the kernel was built with
    GRT_ROW_WARPS)."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import raymarch

    n = state.position.shape[0]
    trials = torch.zeros(n, dtype=torch.int32, device=state.position.device)
    out = raymarch.trace_rays_cuda(metric, state, params, feats, opts,
                                   trials=trials, image_width=width)
    torch.cuda.synchronize()
    rows, tiled = idle_lane_factor(trials), idle_lane_factor(trials, width)
    return {"state": out, "per_ray": trials, "rays": n,
            "active": int((state.status == 0).sum()),
            "trials": int(trials.sum(dtype=torch.int64)),
            "mean_steps": float(out.steps.float().mean()),
            "max_steps": int(out.steps.max()),
            "idle_factor": (rows if "-DGRT_ROW_WARPS" in raymarch.NVCC_FLAGS
                            else tiled),
            "idle_rows": rows, "idle_tiles": tiled}


@contextlib.contextmanager
def swapped_trace(integrate, fn):
    """Inside the block ``integrate.trace_rays`` is ``fn(real, metric, state,
    params, features, opts, image_width)``, ``real`` being the function it
    replaces."""
    real = integrate.trace_rays

    def trace_rays(metric, state, params, features, opts, image_width=None):
        return fn(real, metric, state, params, features, opts, image_width)

    integrate.trace_rays = trace_rays
    try:
        yield
    finally:
        integrate.trace_rays = real


@contextlib.contextmanager
def recorded_launches(integrate, with_opts=False):
    """Yields a list that receives ``(input state, output state, image
    width)`` of every ``integrate.trace_rays`` call made inside the block
    (and the call's trace options as a fourth item, ``with_opts``)."""
    launches = []

    def record(real, metric, state, params, features, opts, image_width):
        out = real(metric, state, params, features, opts, image_width)
        launches.append((state, out, image_width, opts) if with_opts
                        else (state, out, image_width))
        return out

    with swapped_trace(integrate, record):
        yield launches


def plain_marches(integrate, record=None):
    """Inside the block every march is made by the kernel's plain twin;
    ``record``, a list, receives ``(input state, output state)`` of each."""
    def plain(real, metric, state, params, features, opts, image_width):
        out = integrate.trace_rays_reference(metric, state, params, features,
                                             opts)
        if record is not None:
            record.append((state, out))
        return out

    return swapped_trace(integrate, plain)


# The adaptive frame's stages, in the order a first frame runs them.
STAGES = ("camera frame", "prepass", "quarter setup", "quarter trace",
          "refine setup", "refine trace", "finish")


@contextlib.contextmanager
def stage_events(pl, integrate):
    """CUDA events around the adaptive frame's stages, as ``render_frame``
    itself runs them.  Yields a function that returns ``{stage: ms}`` of the
    frames rendered inside the block so far and forgets them; ``prepass``
    holds its own ray init and launch."""
    import torch

    spans = []

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans.append((name, *ev))
            return out
        return wrapper

    targets = ((pl, "camera_frame", "camera frame"),
               (pl, "_prepass_dead_map", "prepass"),
               (pl, "_quarter_setup", "quarter setup"),
               (pl, "_refine_setup", "refine setup"),
               (pl, "_finish_shade", "finish"),
               (integrate, "trace_rays", "trace"))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def read():
        torch.cuda.synchronize()
        ms = {}
        # The marches in launch order: the prepass's own (inside the prepass
        # stage) when there are three, then quarter and refine.
        marches = [s for s in spans if s[0] == "trace"]
        for name, span in zip(("quarter trace", "refine trace"),
                              marches[-2:]):
            ms[name] = span[1].elapsed_time(span[2])
        if len(marches) == 3:
            ms["prepass launch"] = marches[0][1].elapsed_time(marches[0][2])
        for name, a, b in spans:
            if name != "trace":
                ms[name] = a.elapsed_time(b)
        spans.clear()
        return ms

    for mod, attr, name in targets:
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        yield read
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def timed_stages(frame, read):
    """``(total ms, {stage: ms})`` of one ``frame()`` inside
    ``stage_events`` (``read`` is what it yields); "other" is the rest."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    frame()
    ev[1].record()
    ms = read()
    total = ev[0].elapsed_time(ev[1])
    ms["other"] = total - sum(ms.get(s, 0.0) for s in STAGES)
    return total, ms


def stage_text(ms):
    return " + ".join(f"{s} {ms[s]:.3f}" for s in (*STAGES, "other")
                      if s in ms)


def born_dead_untouched(s_in, outs) -> int:
    """The number of rays of ``s_in`` that are not ACTIVE; raises unless
    every field of theirs is bit for bit the same in each state of
    ``outs``."""
    import torch

    rows = s_in.status != 0
    for out in outs:
        for name, a, b in zip(s_in._fields, s_in, out):
            if not torch.equal(a[rows].view(torch.int32),
                               b[rows].view(torch.int32)):
                raise AssertionError(f"a ray born DEAD changed its {name}")
    return int(rows.sum())


def cost_sorted_launch(metric, s_in, qsteps, sel, params, feats, opts,
                       grid_hw, rounds=5):
    """The refine launch with and without a cost sort of its rays: the key
    is the largest step count among the block's four quarter neighbours
    (``qsteps``, the quarter launch's), quantised to 64 buckets on a log
    scale over its range, descending, the rays born DEAD last; the rays are
    gathered into that order, marched and scattered back.  Returns ``{"ms":
    unsorted launch, "sorted_ms": sort + gather + launch + scatter,
    "sorted_launch_ms": that launch alone, "sorted_idle_factor",
    "identical": same bits as the unsorted launch}``, ms as medians of
    ``rounds`` in turns."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import integrate, packing, raymarch

    def sorted_launch(ev=None, trials=None):
        g = qsteps.reshape(grid_hw)
        cost = torch.maximum(
            torch.maximum(g, torch.roll(g, -1, 1)),
            torch.maximum(torch.roll(g, -1, 0),
                          torch.roll(g, (-1, -1), (0, 1)))).reshape(-1)
        lc = torch.log2(torch.clamp(cost[sel].float(), min=1.0)).repeat(3)
        live = s_in.status == 0
        hi = torch.where(live, lc, -1.0).max()
        lo = torch.where(live, lc, 1e9).min()
        bucket = torch.clamp(torch.floor(
            (hi - lc) * (63 / torch.clamp(hi - lo, min=1e-3))), 0, 63)
        bucket = torch.where(live, bucket.to(torch.int32), 64)
        perm, dest = packing.bucket_sort_perm(bucket)
        packed = integrate.RayState(*(t[perm] for t in s_in))
        if ev is not None:
            ev[0].record()
        out = raymarch.trace_rays_cuda(metric, packed, params, feats, opts,
                                       trials=trials)
        if ev is not None:
            ev[1].record()
        return integrate.RayState(*(t_[dest] for t_ in out))

    def ms_of(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out = fn(ev[2:])
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])

    def unsorted_launch(ev):
        ev[0].record()
        out = raymarch.trace_rays_cuda(metric, s_in, params, feats, opts)
        ev[1].record()
        return out

    plain, whole, inner = [], [], []
    for _ in range(rounds):
        a, ms, _ = ms_of(unsorted_launch)
        plain.append(ms)
        b, ms, launch_ms = ms_of(sorted_launch)
        whole.append(ms)
        inner.append(launch_ms)
    trials = torch.zeros_like(s_in.status)
    sorted_launch(trials=trials)
    torch.cuda.synchronize()
    return {"ms": statistics.median(plain),
            "sorted_ms": statistics.median(whole),
            "sorted_launch_ms": statistics.median(inner),
            "sorted_idle_factor": idle_lane_factor(trials),
            "identical": same_bits(a, b)}


def sass_stats(lib_path: str) -> dict:
    """Static counts from ``cuobjdump -sass`` of a kernel library, for its
    instance of the default options: ``instructions`` of the kernel, ``fp32`` of them FADD, FMUL or FFMA,
    ``loop`` (instructions from the target of its longest backward branch
    to the branch: the march loop with its slow paths) and ``reductions``
    (IMAD.WIDE.U32, one per inlined copy of the trigonometric range
    reduction's slow path)."""
    import re

    from geodesic_raytracing_tpu_torch.ops import raymarch

    tool = Path(raymarch.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    # The kernel instance of the default options (Verlet, no
    # reparameterisation, not planar) among the library's six.
    default = [f for f in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]
               if "StepOptionsILb0ELb0ELb0E" in f.split("\n", 1)[0]]
    assert len(default) == 1, len(default)
    sass = default[0]
    lines = re.findall(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", sass, re.M)
    loops = [(int(at, 16) - int(m.group(1), 16)) // 16 + 1
             for at, text in lines
             if (m := re.search(r"\bBRA\b.*\b0x([0-9a-f]+)", text))
             and int(m.group(1), 16) < int(at, 16)]
    return {"instructions": len(lines), "loop": max(loops, default=0),
            "fp32": sum(bool(re.match(r"(@!?U?P\w+ )?(FADD|FMUL|FFMA)\b", t))
                        for _, t in lines),
            "reductions": sum("IMAD.WIDE.U32" in t for _, t in lines)}


def sweep(variants, metric, params, camera, settings, feats, rounds=5):
    """Build the kernel once per set of nvcc flags in ``variants`` (all at
    once), march the 1080p and the 480x270 frame's rays with each, in turns
    over ``rounds`` rounds, and print one line per variant: registers and
    stack, blocks per SM, static SASS counts (``sass_stats``: instructions,
    march loop, range reductions), median and least kernel time at both
    sizes, the
    idle-lane factor at 1080p, and how its 1080p result agrees with the
    first variant's (fates, steps, largest position difference)."""
    import concurrent.futures

    import torch
    from geodesic_raytracing_tpu_torch.ops import raymarch
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    dev = torch.device("cuda")
    default_flags = raymarch.NVCC_FLAGS
    flags = [raymarch.with_flags(*shlex.split(v)) for v in variants]
    with concurrent.futures.ThreadPoolExecutor(len(flags)) as pool:
        list(pool.map(lambda f: raymarch.build("kerr_boyer", f),
                      dict.fromkeys(flags)))
    small = dataclasses.replace(settings, width=480, height=270)
    states = [(pl.init_camera_rays(metric, camera, params, s, feats,
                                   device=dev)[0], s.width)
              for s in (settings, small)]
    n = states[0][0].position.shape[0]

    infos, first = [], None
    for f in flags:
        raymarch.NVCC_FLAGS = f
        work = launch_work(metric, states[0][0], params, feats,
                           settings.trace, settings.width)
        out, per_ray = work.pop("state"), work.pop("per_ray")
        if first is None:
            first = out
            by_tile = {f"{w}x{h}": idle_lane_factor(per_ray, settings.width,
                                                    (w, h))
                       for w, h in ((32, 1), (16, 2), (8, 4), (4, 8), (2, 16))}
            print("[sweep] idle-lane factor at 1080p by warp tile: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in by_tile.items()))
        st, sp, err, _ = compare_states(out, first)
        same = same_bits(out, first)
        built = raymarch.BUILD_INFO["kerr_boyer", f]
        infos.append({**raymarch.ptxas_summary(built["ptxas"]),
                      **sass_stats(built["path"]),
                      **raymarch.kernel_config("kerr_boyer"), **work, "status_eq": st,
                      "steps_eq": sp, "max_dpos": err, "identical": same})
    times = [([], []) for _ in flags]
    for _ in range(rounds):
        for f, t in zip(flags, times):
            raymarch.NVCC_FLAGS = f
            for (state, width), ms in zip(states, t):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                raymarch.trace_rays_cuda(metric, state, params, feats,
                                         settings.trace, image_width=width)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
    bound = bound_ms(n, infos[0]["trials"])[0]
    print(f"[sweep] {n} rays, {infos[0]['trials']} trial iterations, bound "
          f"{bound:.3f} ms at {OPS_PER_TRIAL} operations each; {rounds} "
          "rounds in turns; ms = median (least)")
    for v, info, (big, sm) in zip(variants, infos, times):
        print(f"[sweep] {v or '(default)':48s} regs {info['registers']:3d} "
              f"stack {info['stack_bytes']:3d} spill "
              f"{info['spill_store_bytes']}+{info['spill_load_bytes']} "
              f"blocks/SM {info['blocks_per_sm']} x {info['threads']} | sass "
              f"{info['instructions']} fp32 {info['fp32']} loop "
              f"{info['loop']} reductions "
              f"{info['reductions']} | "
              f"1080p {statistics.median(big):7.3f} ({min(big):7.3f}) ms | "
              f"480x270 {statistics.median(sm):6.3f} ({min(sm):6.3f}) ms | "
              f"idle lanes {info['idle_factor']:.4f} | vs first: status "
              f"{info['status_eq']}/{n} steps {info['steps_eq']}/{n} max "
              f"|dpos| {info['max_dpos']:.3g} identical {info['identical']}")
    raymarch.NVCC_FLAGS = default_flags


def same_bits(a, b) -> bool:
    """Whether two RayStates hold the same bits in every field."""
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def golden_gate(a, b):
    """RMSE and fraction of pixels off by > 32 of two sRGB uint8 images."""
    d = np.abs(a.astype(int) - b.astype(int))
    return float(np.sqrt((d.astype(float) ** 2).mean())), float(
        (d > 32).mean())


def to_srgb8(img):
    from geodesic_raytracing_tpu_torch.render import colour

    s = colour.lin_to_srgb(img).cpu().numpy()
    return (np.clip(s, 0, 1) * 255).astype(np.uint8)


def profile_frame(frame, frame_ms: float, what: str) -> None:
    """``torch.profiler`` over one steady frame (``what`` names it): device
    kernels, their merged busy time, and the idle share against the profiled
    wall and against the unprofiled frame time ``frame_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("[6 profile] the profiler saw no device events: not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo = busy_us + (hi - lo), a
        hi = max(hi, b)
    busy_ms = (busy_us + (hi - lo)) / 1e3
    march = [e for e in dev if "raymarch_kernel" in e.name]
    march_ms = sum(e.time_range.elapsed_us() for e in march) / 1e3
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    print(f"[6 profile] one steady {what} frame: {len(kernels)} device kernels "
          f"({len(dev) - len(kernels)} memcpy/memset), raymarch_kernel "
          f"{len(march)} launch(es) {march_ms:.3f} ms; device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms profiled wall (idle share "
          f"{1 - busy_ms / wall_ms:.4f}); against the unprofiled "
          f"{frame_ms:.3f} ms frame, idle share {1 - busy_ms / frame_ms:.4f}")
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU
           and a.key.startswith("aten::")]
    top = sorted(ops, key=lambda a: -a.count)[:6]
    print(f"[6 profile] {what}: most-called host ops: " + ", ".join(
        f"{a.key} {a.count}" for a in top))


def bench_protocol_mrays(frame, n_pixels: int, passes=3, frames=4) -> float:
    """Mrays/s of ``frame`` by the protocol of the JAX package's
    ``bench.py``: ``passes`` passes of ``frames`` frames issued back to back
    and drained once, the best pass, host wall clock, ``n_pixels`` a
    frame."""
    import torch

    best = float("inf")
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / frames)
    return n_pixels / best / 1e6


# ---------------------------------------------------------------------------
# The second path: every kernel instance, planar-mode schwarzschild, goldens
# ---------------------------------------------------------------------------

def chart_rays(metric, params, feats, n, dev, tilt=0.0):
    """The ``ray_set(metric.name, n, tilt)`` set in the chart of ``metric``
    as a launch state."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import integrate

    pos, vel = ray_set(metric.name, n, tilt)
    p, v = torch.from_numpy(pos).to(dev).T, torch.from_numpy(vel).to(dev).T
    return integrate.init_ray_state(
        metric, metric.from_polar(p, params).T.contiguous(),
        metric.from_polar_velocity(p, v, params).T.contiguous(), params,
        feats)


def scene_camera(key, camera):
    """``camera`` at the position of the scene ``key`` (``SCENES``), or as
    it is."""
    import torch

    if key not in SCENES:
        return camera
    pos = torch.tensor(SCENES[key][0], dtype=torch.float32)
    return camera._replace(polar_position=pos.to(camera.polar_position.device))


def scene_features(key, metric):
    """The Features of the scene ``key`` (``SCENES``' overrides) for
    ``metric``."""
    from geodesic_raytracing_tpu_torch.ops import integrate

    over = SCENES[key][1] if key in SCENES else {}
    return integrate.Features.for_metric(metric, **over)


def golden_key(name):
    """The file name of a scene's golden (tests/test_parity_images.py)."""
    return name.replace(" ", "_").replace("(", "").replace(")", "")


def assert_equals_plain(what, k, p):
    """Kernel state ``k`` against plain state ``p``: status and steps equal
    on ALL rays, positions within POS_TOL.  Returns the largest position
    difference."""
    n = p.status.numel()
    st, sp, err, close = compare_states(k, p)
    print(f"{what}: {n} rays, kernel vs plain: status equal {st}/{n}, steps "
          f"equal {sp}/{n}, max |dpos| {err:.3g}, same bits "
          f"{same_bits(k, p)}")
    assert st == n and sp == n and close, (what, st, sp, err)
    return err


def graphed_equals_eager(what, metric, state, params, feats, opts) -> None:
    """The graphed plain march (the default on the card, every other
    phase's plain march) against the eager one on ``state``: every
    field of every ray equal bit for bit."""
    from geodesic_raytracing_tpu_torch.ops import integrate

    t0 = time.perf_counter()
    eager = integrate.trace_rays_reference(metric, state, params, feats,
                                           opts, graphed=False)
    t1 = time.perf_counter()
    graphed = integrate.trace_rays_reference(metric, state, params, feats,
                                             opts, graphed=True)
    t2 = time.perf_counter()
    same = same_bits(graphed, eager)
    print(f"{what}: graphed plain march vs eager, {opts.max_steps} trial "
          f"iterations, {state.status.numel()} rays: same bits {same} "
          f"(eager {t1 - t0:.2f} s, graphed {t2 - t1:.2f} s)")
    assert same, what


def tangent_rules(dev) -> dict:
    """Phase 14's probe of the forward-mode rules of the installed torch on
    the card: ``torch.func.jvp`` of each elementwise function that catalogue
    slice B's metrics call, on 2^20 seeded float32 inputs, against candidate
    orderings of its tangent evaluated op by op in float32 (a fused
    multiply-add in float64, rounded once).  Prints the number of inputs on
    which each candidate's bits differ and raises unless the rule of
    ``csrc/dual.cuh`` (the first candidate) matches on every input.
    Returns ``{function: {candidate: mismatches}}``."""
    import torch

    gen = torch.Generator().manual_seed(0)
    n = 1 << 20
    pos = (torch.rand(n, generator=gen) * 8 + 1e-2).to(dev)
    signed = (torch.rand(n, generator=gen) * 16 - 8).to(dev)
    t = torch.randn(n, generator=gen).to(dev)

    def fma(a, b, c):
        return (a.double() * b.double() + c).float()

    def bits(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    cases = {
        "sqrt": (torch.sqrt, pos, {
            "t / (2 y)": lambda x, y: t / (2 * y),
            "t * (0.5 / y)": lambda x, y: t * (0.5 / y)}),
        "exp": (torch.exp, signed, {"t * y": lambda x, y: t * y}),
        "log": (torch.log, pos, {"t / x": lambda x, y: t / x,
                                 "t * (1 / x)": lambda x, y: t * (1 / x)}),
        "log1p": (torch.log1p, pos, {
            "t / (x + 1)": lambda x, y: t / (x + 1),
            "t * (1 / (x + 1))": lambda x, y: t * (1 / (x + 1))}),
        "tanh": (torch.tanh, signed, {
            "t * fma(-y, y, 1)": lambda x, y: t * fma(-y, y, 1.0),
            "t * (1 - y y)": lambda x, y: t * (1 - y * y)}),
        "abs": (torch.abs, signed, {
            "t * sgn(x)": lambda x, y: t * torch.sgn(x)}),
        "clamp(min=0)": (lambda x: torch.clamp(x, min=0.0), signed, {
            "where(x >= 0, t, 0)": lambda x, y: torch.where(
                x >= 0, t, torch.zeros_like(t))}),
    }
    for e in (1.5, 4, 0.25, -0.75, 1.25, -1.75):
        cases[f"x ** {e}"] = (lambda x, e=e: x ** e, pos, {
            "t * (e * x ** (e - 1))": lambda x, y, e=e: t * (e * x ** (e - 1)),
            "t * e * x ** (e - 1)": lambda x, y, e=e: t * e * x ** (e - 1)})
    out = {}
    for name, (fn, x, cands) in cases.items():
        y, d = torch.func.jvp(fn, (x,), (t,))
        out[name] = {k: bits(c(x, y), d) for k, c in cands.items()}
        print(f"[14 rules] torch.func.jvp of {name} on {dev}, {n} inputs: "
              + ", ".join(f"{k} differs on {v}" for k, v in
                          out[name].items()))
        assert next(iter(out[name].values())) == 0, (name, out[name])
    return out


def check_instances(dev, skip=("kerr_boyer",)) -> dict:
    """Phase 14: each kernel instance but ``skip`` against the plain torch
    march on ``make_rays`` sets (64 and 4096 rays; 4096 once more off the
    equator; the spherically symmetric metrics in planar mode too), every
    7th ray born DEAD.  A metric's 4-D sets go to the kernel and to the
    plain twin as one state, and its planar sets as another: a ray's march
    depends on its own state alone, so this changes no bit, and the plain
    twin, whose time is the longest ray's steps, marches once per mode.
    ``branch_rays`` checks that ``godel_cylindrical``'s sets reach its
    cylindrical terminator and ``alcubierre``'s its bubble's wall.
    ``kerr_boyer`` is held at its paths' own shapes instead: the same 64-ray
    set in phase 2, every ray of the 1080p frame (on and off the equator) in
    phase 3, the adaptive and fit launches in phases 9, 11, 20 and 25.
    Returns ``{metric: largest position difference}``."""
    import torch
    from geodesic_raytracing_tpu_torch import metrics
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch

    errs = {}
    for name in sorted(set(raymarch.INSTANCES) - set(skip)):
        m = metrics.get_metric(name)
        params, feats = m.params(), integrate.Features.for_metric(m)
        modes = [(False, ((64, 0.0), (4096, 0.0), (4096, 0.03)))]
        if m.spherically_symmetric:
            modes.append((True, ((64, 0.0), (4096, 0.0))))
        for planar, sets in modes:
            parts = [chart_rays(m, params, feats, n, dev, tilt)
                     for n, tilt in sets]
            for part in parts:
                part.status[::7] = integrate.DEAD
            st = integrate.RayState(*(torch.cat(f) for f in zip(*parts)))
            opts = integrate.TraceOptions(max_steps=4096, planar=planar)
            graphed_equals_eager(
                f"[14 graph] {name} {'planar' if planar else '4-D'}", m,
                parts[0], params, feats,
                dataclasses.replace(opts, max_steps=GRAPH_CHECK_STEPS))
            k = raymarch.trace_rays_cuda(m, st, params, feats, opts)
            t0 = time.perf_counter()
            p = integrate.trace_rays_reference(m, st, params, feats, opts)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            born_dead_untouched(st, (k, p))
            lo = 0
            for n, tilt in sets:
                rows = slice(lo, lo + n)
                lo += n
                what = (f"[14 instances] {name} "
                        f"{'planar' if planar else '4-D'} {n} rays"
                        f"{' off the equator' if tilt else ''}")
                kr = integrate.RayState(*(t[rows] for t in k))
                pr = integrate.RayState(*(t[rows] for t in p))
                err = assert_equals_plain(what, kr, pr)
                errs[name] = max(errs.get(name, 0.0), err)
                branch_rays(what, m, integrate.RayState(
                    *(t[rows] for t in st)), kr, pr)
            print(f"[14 instances] {name} {'planar' if planar else '4-D'}: "
                  f"one plain march of the {lo} rays {plain_s:.1f} s")
    return errs


def branch_rays(what, metric, s_in, k, p) -> None:
    """Phase 14's checks that a set runs the branch its metric was given it
    for: ``godel_cylindrical``'s rays aimed at the axis die at the
    cylindrical terminator (p < 0.005), the same rays in the kernel and in
    the plain march; ``alcubierre``'s rays meet the bubble's wall (their
    escape direction is more than a degree off their launch direction:
    outside the wall the metric is flat, and a ray that misses it runs
    straight)."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import integrate

    if metric.name == "godel_cylindrical":
        term = [(s.status == integrate.DEAD)
                & (s.position[:, 1] < metric.config.cylindrical_terminator)
                for s in (k, p)]
        print(f"{what}: {int(term[0].sum())} rays died at the cylindrical "
              "terminator in the kernel, the same rays in the plain march "
              f"{bool(torch.equal(term[0], term[1]))}")
        assert int(term[0].sum()) >= 1 and torch.equal(term[0], term[1])
    if metric.name == "alcubierre":
        v0, v1 = s_in.velocity[:, 1:], k.velocity[:, 1:]
        cos = (v0 * v1).sum(-1) / (v0.norm(dim=-1) * v1.norm(dim=-1))
        met = (k.status == integrate.ESCAPED) & (
            cos < math.cos(math.radians(1.0)))
        print(f"{what}: {int(met.sum())} escaped rays met the bubble's wall "
              "(deflected by more than 1 degree)")
        assert int(met.sum()) >= 8


def check_step_options(dev) -> float:
    """Phase 15: the Euler integrator and Verlet with affine
    reparameterisation on ``schwarzschild``, 4-D and planar, kernel against
    plain."""
    from geodesic_raytracing_tpu_torch import metrics
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch

    m = metrics.get_metric("schwarzschild")
    params, feats = m.params(), integrate.Features.for_metric(m)
    st = chart_rays(m, params, feats, 4096, dev)
    worst = 0.0
    for kw in (dict(integrator="euler"), dict(reparameterisation=True)):
        for planar in (False, True):
            opts = integrate.TraceOptions(max_steps=4096, planar=planar, **kw)
            k = raymarch.trace_rays_cuda(m, st, params, feats, opts)
            p = integrate.trace_rays_reference(m, st, params, feats, opts)
            worst = max(worst, assert_equals_plain(
                f"[15 options] schwarzschild {kw} "
                f"{'planar' if planar else '4-D'}", k, p))
            if "reparameterisation" in kw:
                assert bool((k.running_dlambda_dnew != 1.0).any())
    return worst


def launches_vs_plain(tag, metric, params, feats, launches):
    """Each recorded launch ``(input, output, width, opts)`` against the
    plain twin on all rays.  Returns ``(largest position difference, [plain
    ms])``."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import integrate

    worst, plain_ms = 0.0, []
    for i, (s_in, s_out, _, opts) in enumerate(launches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        p = integrate.trace_rays_reference(metric, s_in, params, feats, opts)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms.append(ev[0].elapsed_time(ev[1]))
        dead = born_dead_untouched(s_in, (s_out, p))
        worst = max(worst, assert_equals_plain(
            f"{tag} launch {i} (planar {opts.planar}, {dead} born DEAD, "
            f"plain march {plain_ms[-1]:.1f} ms)", s_out, p))
    return worst, plain_ms


def work_row(name, metric, s_in, s_out, params, feats, opts, width, ms):
    """One launch's work and bound (by the instance's own operations per
    trial iteration) as a dict, printed."""
    lw = launch_work(metric, s_in, params, feats, opts, width)
    assert same_bits(lw.pop("state"), s_out), "two launches disagree"
    del lw["per_ray"]
    ops = OPS_BY_INSTANCE[metric.name, bool(opts.planar)]
    b, b_ops, b_bytes = bound_ms(lw["rays"], lw["trials"], ops)
    row = {"name": name, "rays": lw["rays"], "active_rays": lw["active"],
           "planar": bool(opts.planar), "image_width": width,
           "trial_iterations": lw["trials"], "mean_steps": lw["mean_steps"],
           "max_steps": lw["max_steps"], "idle_lane_factor":
           lw["idle_factor"], "ops_per_trial": ops, "ms": ms, "bound_ms": b,
           "bound_by": "operations" if b == b_ops else "bytes",
           "share_of_bound": b / ms}
    print(f"[work] {name}: {row['rays']} rays ({row['active_rays']} ACTIVE at "
          f"launch), trial iterations {row['trial_iterations']}, committed "
          f"steps mean {row['mean_steps']:.2f} max {row['max_steps']}, "
          f"idle-lane factor {row['idle_lane_factor']:.4f}; kernel {ms:.3f} "
          f"ms, bound {b:.3f} ms (by {row['bound_by']}: {ops} operations a "
          f"trial iteration; bytes {b_bytes:.3f} ms), share {b / ms:.4f}")
    return row


def second_path(dev, sky) -> dict:
    """Phase 16: ``schwarzschild`` in planar mode at 1920x1080 through
    ``render_frame``, the flagship settings with the metric swapped: the
    dense frame and four adaptive frames with a RefineBudgetController
    (its config has ``use_prepass=False``: no prepass launch).  The dense
    1080p launch, a steady frame's quarter and refine launches and every
    launch of the 480x270 twins are held against the plain march on all
    rays."""
    import torch
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    metric, params, camera, asettings, feats = flagship_config(
        device=dev, metric="schwarzschild")
    assert asettings.planar and pl._planar_enabled(metric, asettings)
    assert not metric.config.use_prepass
    settings = dataclasses.replace(asettings, adaptive_sampling=False)
    n_rays = settings.width * settings.height
    out = {}

    def checked(img, what):
        finite = bool(torch.isfinite(img).all())
        black = float((img == 0).all(dim=-1).float().mean())
        assert finite and tuple(img.shape) == (1080, 1920, 3), what
        assert SHADOW_RANGE[0] <= black <= SHADOW_RANGE[1], (what, black)
        return black

    # Dense: one launch, in planar mode.
    with recorded_launches(integrate, with_opts=True) as launch:
        raymarch.reset_launch_counts()
        dense_img = pl.render_frame(metric, camera, params, sky, settings,
                                    feats, device=dev)
        torch.cuda.synchronize()
        counts = dict(raymarch.LAUNCHES_BY_METRIC)
    black = checked(dense_img, "dense")
    assert counts == {"schwarzschild": 1}, counts
    (d_in, d_out, d_width, d_opts), = launch
    assert d_opts.planar and d_width == 1920
    assert bool((d_in.position[:, 2] == d_in.position[0, 2]).all())
    print(f"[16 dense] 1920x1080 schwarzschild, planar: kernel launches "
          f"{counts}, shadow fraction {black:.4f}, every ray at theta "
          f"{float(d_in.position[0, 2]):.7f}")
    out["dense_launches"] = 1

    # Adaptive: a fresh controller, four frames, 2 launches each.
    controller = pl.RefineBudgetController()

    def adaptive_frame():
        return pl.render_frame(metric, camera, params, sky, asettings, feats,
                               controller=controller, device=dev)

    path_launches, recorded, aimg = [], {}, None
    for i in range(4):
        with recorded_launches(integrate, with_opts=True) as launch:
            raymarch.reset_launch_counts()
            img = adaptive_frame()
            torch.cuda.synchronize()
            path_launches.append(raymarch.LAUNCHES_BY_METRIC.get(
                "schwarzschild", 0))
        black = checked(img, f"adaptive {i}")
        if i in (0, 3):
            recorded[i] = launch
        aimg = img if i == 0 else aimg
        print(f"[16 adaptive] frame {i}: kernel launches {path_launches[-1]} "
              f"({', '.join(str(l[0].status.numel()) for l in launch)} rays, "
              f"planar {[l[3].planar for l in launch]}), controller bucket "
              f"{controller.fraction(1.0):.4f}, shadow fraction {black:.4f}")
    assert path_launches == [2, 2, 2, 2], path_launches
    assert all(l[3].planar for ls in recorded.values() for l in ls)
    out["adaptive_launches"] = path_launches

    d = (aimg - dense_img).abs().max(dim=-1).values
    off_frac, median = float((d > 0.1).float().mean()), float(d.median())
    print(f"[16 dense] adaptive vs dense 1080p schwarzschild frame: pixels "
          f"with a channel off by >0.1 {off_frac:.5f} (limit "
          f"{ADAPTIVE_MAX_OFF_FRAC}), median difference {median:.3g} (limit "
          f"{ADAPTIVE_MAX_MEDIAN})")
    assert off_frac < ADAPTIVE_MAX_OFF_FRAC and median < ADAPTIVE_MAX_MEDIAN
    del d, aimg, dense_img

    # A steady frame never waits for the device.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adaptive_frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[16 sync] one steady adaptive 1080p schwarzschild frame under "
          "set_sync_debug_mode('error'): no host synchronisation")

    # Stage times by CUDA events.
    def timed_dense():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        e[0].record()
        s, ku, iq = pl.init_camera_rays(metric, camera, params, settings,
                                        feats, device=dev)
        e[1].record()
        fin = integrate.trace_rays(metric, s, params, feats, d_opts,
                                   image_width=settings.width)
        e[2].record()
        rd = pl.compute_render_data(metric, fin, ku, params, feats,
                                    inv_quat=iq)
        e[3].record()
        pl.shade(rd, sky, settings)
        e[4].record()
        torch.cuda.synchronize()
        return [e[i].elapsed_time(e[i + 1]) for i in range(4)]

    timed_dense()
    splits = [timed_dense() for _ in range(3)]
    for i, sp in enumerate(splits):
        print(f"[16 time] dense schwarzschild frame {i}: {sum(sp):.3f} ms = "
              f"ray init (with to_planar) {sp[0]:.3f} + trace kernel "
              f"{sp[1]:.3f} + render data (with unrotate) {sp[2]:.3f} + "
              f"shade {sp[3]:.3f} ms")
    out["dense_stages_ms"] = dict(zip(
        ("ray init", "trace kernel", "render data", "shade"),
        (statistics.median(c) for c in zip(*splits))))
    out["dense_frame_ms"] = statistics.median(sum(sp) for sp in splits)

    steady = []
    with stage_events(pl, integrate) as read:
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            adaptive_frame()
            ev[1].record()
            ms = read()
            total = ev[0].elapsed_time(ev[1])
            ms["other"] = total - sum(ms.get(st, 0.0) for st in STAGES)
            steady.append((total, ms))
    for i, (total, ms) in enumerate(steady):
        print(f"[16 time] steady adaptive schwarzschild frame {i}: "
              f"{total:.3f} ms = " + " + ".join(
                  f"{st} {ms[st]:.3f}" for st in (*STAGES, "other")
                  if st in ms) + " ms")
    out["adaptive_frame_ms"] = statistics.median(t for t, _ in steady)
    out["adaptive_stages_ms"] = steady[-1][1]
    mrays = bench_protocol_mrays(adaptive_frame, n_rays)
    dense_mrays = bench_protocol_mrays(
        lambda: pl.render_frame(metric, camera, params, sky, settings, feats,
                                device=dev), n_rays)
    print(f"[16 bench] by bench.py's protocol: adaptive {mrays:.4f} Mrays/s, "
          f"dense {dense_mrays:.4f} Mrays/s")
    out["bench_mrays"] = {"adaptive": mrays, "dense": dense_mrays}

    # Work and bound of every launch.
    rows = [work_row("dense", metric, d_in, d_out, params, feats, d_opts,
                     d_width, out["dense_stages_ms"]["trace kernel"])]
    for what, (s_in, s_out, width, opts) in zip(("quarter", "refine"),
                                                recorded[3]):
        rows.append(work_row(
            f"steady {what}", metric, s_in, s_out, params, feats, opts, width,
            statistics.median(ms[f"{what} trace"] for _, ms in steady)))
    out["launch"] = rows

    # The path's own launches against the plain march on all rays: the dense
    # 1080p launch and the steady adaptive frame's quarter and refine sets.
    worst, pms = launches_vs_plain(
        "[16 launches] 1080p (0 dense, 1 steady quarter, 2 steady refine)", metric,
        params, feats, [(d_in, d_out, d_width, d_opts), *recorded[3]])
    for row, ms in zip(rows, pms):
        row["plain_ms"] = ms
    del recorded, d_in, d_out

    # Every launch of the 480x270 twins against the plain march.
    small = dataclasses.replace(settings, width=480, height=270)
    asmall = dataclasses.replace(asettings, width=480, height=270)
    plain_ms = {}
    for what, cfg in (("dense", small), ("adaptive", asmall)):
        with recorded_launches(integrate, with_opts=True) as launch:
            fk = pl.render_frame(metric, camera, params, sky, cfg, feats,
                                 device=dev)
        with plain_marches(integrate):
            fp = pl.render_frame(metric, camera, params, sky, cfg, feats,
                                 device=dev)
        assert len(launch) == (1 if what == "dense" else 2)
        rmse, bad = golden_gate(to_srgb8(fk), to_srgb8(fp))
        print(f"[16 gate] 480x270 {what} schwarzschild frame, kernel vs "
              f"plain marches: RMSE {rmse:.4f}, pixels off by >32 {bad:.5f}")
        assert rmse < GATE_RMSE and bad < GATE_BAD_FRAC, (rmse, bad)
        err, pms = launches_vs_plain(f"[16 launches] 480x270 {what}", metric,
                                     params, feats, launch)
        worst, plain_ms[what] = max(worst, err), pms
    out["max_abs_err"], out["plain_ms_480x270"] = worst, plain_ms
    return out


def planar_vs_4d(dev, sky) -> dict:
    """Phase 17: the 480x270 ``schwarzschild`` frame planar and 4-D (fates,
    escape directions, images), and the 1080p launch of both with its
    work."""
    import torch
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    metric, params, camera, asettings, feats = flagship_config(
        device=dev, metric="schwarzschild")
    dense = dataclasses.replace(asettings, adaptive_sampling=False)
    out, rdata, imgs = {}, {}, {}
    for planar in (True, False):
        small = dataclasses.replace(dense, width=480, height=270,
                                    planar=planar)
        st, ku, iq = pl.init_camera_rays(metric, camera, params, small, feats,
                                         device=dev)
        opts = pl._trace_opts(metric, small)
        assert opts.planar == planar and (iq is not None) == planar
        fin = integrate.trace_rays(metric, st, params, feats, opts,
                                   image_width=480)
        rdata[planar] = pl.compute_render_data(metric, fin, ku, params, feats,
                                               inv_quat=iq)
        imgs[planar] = pl.shade(rdata[planar], sky, small)
    t4, tp = rdata[False].terminated, rdata[True].terminated
    fates_eq = float((t4 == tp).float().mean())
    both = (t4 == 1) & (tp == 1)
    v4 = pl._ang_to_vec(rdata[False].angles[both])
    vp = pl._ang_to_vec(rdata[True].angles[both])
    ang = torch.rad2deg(torch.acos(torch.clamp((v4 * vp).sum(-1), -1, 1)))
    median_deg = float(ang.median())
    rmse, bad = golden_gate(to_srgb8(imgs[True]), to_srgb8(imgs[False]))
    print(f"[17 planar] 480x270 schwarzschild, planar vs 4-D: fates equal "
          f"{fates_eq:.5f} (limit > {PLANAR_MIN_FATES_EQ}), median angle "
          f"between escape directions {median_deg:.3g} deg (limit "
          f"{PLANAR_MAX_MEDIAN_DEG}), 99th percentile "
          f"{float(ang.quantile(0.99)):.3g} deg; images: RMSE {rmse:.4f}, "
          f"pixels off by >32 {bad:.5f}")
    # What the reference's test of planar mode asks.  The two images are
    # printed as found and not held to the golden gate: the 4-D march has the
    # reference's polar-axis artifact (a stripe of wrong directions in the
    # image column through the sky poles), which planar mode is free of.
    assert fates_eq > PLANAR_MIN_FATES_EQ and median_deg < \
        PLANAR_MAX_MEDIAN_DEG
    out["gate"] = {"fates_equal": fates_eq, "median_deg": median_deg,
                   "rmse": rmse, "bad": bad}
    del rdata, imgs

    # The 1080p launch of both, timed in turns.
    states = {}
    for planar in (True, False):
        cfg = dataclasses.replace(dense, planar=planar)
        states[planar] = (pl.init_camera_rays(metric, camera, params, cfg,
                                              feats, device=dev)[0],
                          pl._trace_opts(metric, cfg))
    ms = {True: [], False: []}
    for _ in range(5):
        for planar, (st, opts) in states.items():
            ms[planar].append(median_launch_ms(metric, st, params, feats,
                                               opts, 1920, rounds=1))
    for planar, (st, opts) in states.items():
        k = integrate.trace_rays(metric, st, params, feats, opts,
                                 image_width=1920)
        out["planar" if planar else "4d"] = work_row(
            f"1080p dense schwarzschild {'planar' if planar else '4-D'} "
            "(median of 5 in turns)", metric, st, k, params, feats, opts,
            1920, statistics.median(ms[planar]))
    ratio = out["planar"]["ms"] / out["4d"]["ms"]
    print(f"[17 planar] 1080p launch, planar / 4-D: {ratio:.4f} in time, "
          f"{out['planar']['trial_iterations'] / out['4d']['trial_iterations']:.4f}"
          " in trial iterations")
    out["time_ratio"] = ratio
    return out


def golden_scenes(dev) -> dict:
    """Phase 18: the 128x128 scenes of scripts/make_goldens.py for every
    metric but ``kerr_boyer`` and for ``kerr_redshift`` and
    ``alcubierre_paper`` through the kernel path (each with its scene's
    camera and Features, ``SCENES``), against ``tests/golden/catalogue/
    *.png`` with the golden gate."""
    import torch
    from geodesic_raytracing_tpu_torch import cli, metrics
    from geodesic_raytracing_tpu_torch.camera import Camera
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.render import background as bg
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    sky = bg.checker_background(device=dev)
    camera = Camera.default(device=dev).rotate(pitch=-math.pi / 2)
    scenes = {n: (n, {}) for n in sorted(raymarch.INSTANCES)
              if n != "kerr_boyer"}
    scenes.update(SCENE_METRIC)
    out = {}
    for key, (name, sets_over) in scenes.items():
        m = metrics.get_metric(name)
        settings = pl.RenderSettings(
            width=128, height=128, anisotropy=4,
            trace=integrate.TraceOptions(max_steps=8192), **sets_over)
        raymarch.reset_launch_counts()
        img = pl.render_frame(m, scene_camera(key, camera), m.params(), sky,
                              settings, scene_features(key, m), device=dev)
        assert raymarch.LAUNCHES_BY_METRIC == {name: 1}
        assert bool(torch.isfinite(img).all())
        golden = cli.read_png(ROOT / "tests" / "golden" / "catalogue"
                              / f"{golden_key(key)}.png")
        rmse, bad = golden_gate(to_srgb8(img), golden)
        limit = GOLDEN_RMSE.get(key, GATE_RMSE)
        print(f"[18 goldens] {key}: RMSE {rmse:.4f} (limit {limit}), pixels "
              f"off by >32 {bad:.5f} (limit {GATE_BAD_FRAC})")
        assert rmse < limit and bad < GATE_BAD_FRAC, (key, rmse, bad)
        out[key] = {"rmse": rmse, "bad": bad}
    return out


def every_metric_dense(dev, sky, skip=("kerr_boyer",)):
    """Phase 19: one dense 1920x1080 frame of every other metric through
    ``render_frame`` (counts from 0; planar as the pipeline decides; the
    scene's camera time), the work of its launch and of its 480x270 twin,
    and the 1080p launch against the plain march on all rays for
    ``DENSE_PLAIN_DEPTH`` trial iterations (to the end where no ray takes
    more; ``depth``, the work of the cut launch, where one does).  Returns
    ``({metric: row},
    {metric of CATALOGUES: its dense frame})``."""
    import torch
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    rows, frames = {}, {}
    for name in sorted(raymarch.INSTANCES):
        if name in skip:
            continue
        metric, params, camera, asettings, _ = flagship_config(
            device=dev, metric=name)
        camera = scene_camera(name, camera)
        feats = scene_features(name, metric)
        settings = dataclasses.replace(asettings, adaptive_sampling=False)
        with recorded_launches(integrate, with_opts=True) as launch:
            raymarch.reset_launch_counts()
            img = pl.render_frame(metric, camera, params, sky, settings,
                                  feats, device=dev)
            torch.cuda.synchronize()
            counts = dict(raymarch.LAUNCHES_BY_METRIC)
        assert counts == {name: 1}, counts
        assert bool(torch.isfinite(img).all())
        assert tuple(img.shape) == (1080, 1920, 3)
        black = float((img == 0).all(dim=-1).float().mean())
        if name in CATALOGUES:
            frames[name] = img
        (s_in, s_out, width, opts), = launch
        assert opts.planar == bool(metric.spherically_symmetric)
        full = work_row(
            f"1080p dense {name}", metric, s_in, s_out, params, feats, opts,
            width, median_launch_ms(metric, s_in, params, feats, opts, width))
        # The plain twin marches every ray of the launch for its first
        # DENSE_PLAIN_DEPTH trial iterations, against a kernel launch with
        # that budget; the frame's launch equals that launch on every ray
        # that ended within it (on all rays where none went on).
        cut = dataclasses.replace(opts, max_steps=min(opts.max_steps,
                                                      DENSE_PLAIN_DEPTH))
        k_cut = raymarch.trace_rays_cuda(metric, s_in, params, feats, cut,
                                         image_width=width)
        err_full, (plain_ms,) = launches_vs_plain(
            f"[19 metrics] 1080p dense {name}, {cut.max_steps} trial "
            "iterations", metric, params, feats, [(s_in, k_cut, width, cut)])
        ended = k_cut.status != integrate.ACTIVE
        went_on = int((~ended).sum())
        assert same_bits(integrate.RayState(*(t[ended] for t in k_cut)),
                         integrate.RayState(*(t[ended] for t in s_out)))
        print(f"[19 metrics] 1080p dense {name}: the frame's launch equals "
              f"that launch on the {int(ended.sum())} rays that ended within "
              f"{cut.max_steps} trial iterations ({went_on} went on)")
        if went_on:
            full["plain_ms"] = None
            depth = work_row(
                f"1080p dense {name}, first {cut.max_steps} trial iterations",
                metric, s_in, k_cut, params, feats, cut, width,
                median_launch_ms(metric, s_in, params, feats, cut, width))
            depth["plain_ms"] = plain_ms
        else:
            full["plain_ms"], depth = plain_ms, None
        del launch, s_in, s_out, img, k_cut, ended

        small = dataclasses.replace(settings, width=480, height=270)
        st, _, _ = pl.init_camera_rays(metric, camera, params, small, feats,
                                       device=dev)
        k = raymarch.trace_rays_cuda(metric, st, params, feats, opts,
                                     image_width=480)
        ms = median_launch_ms(metric, st, params, feats, opts, 480)
        row = work_row(f"480x270 dense {name}", metric, st, k, params, feats,
                       opts, 480, ms)
        print(f"[19 metrics] {name}: 1080p frame finite, black fraction "
              f"{black:.4f}, kernel launches {counts}")
        rows[name] = {"launches": counts[name], "max_abs_err": err_full,
                      "black_fraction": black, "small": row, "full": full,
                      "depth": depth}
    return rows, frames


def catalogue_paths(dev, sky, dense) -> dict:
    """Phase 26: every metric of catalogue slices A, B and C (the fourth,
    fifth and sixth paths) through the main path, ``render_frame``'s adaptive
    1920x1080 frame with the flagship settings (``flagship_config(
    metric=name)``, the scene's camera and Features) and a fresh
    RefineBudgetController: a first frame (three launches where the config
    asks for the prepass, else two), three warm frames and a steady one (two
    launches each), the counts set to 0 before each frame and read after
    it; the first frame against ``dense[name]``, phase 19's dense frame of
    the metric, by the gate of phase 10; a steady frame under
    ``set_sync_debug_mode("error")``; stage times of three steady frames
    and of a first frame by CUDA events.  Returns ``{metric: paths}``."""
    import torch
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    out = {}
    for name in CATALOGUES:
        metric, params, camera, asettings, _ = flagship_config(
            device=dev, metric=name)
        camera = scene_camera(name, camera)
        feats = scene_features(name, metric)
        assert asettings.adaptive_sampling and asettings.shade_traced_only
        first_n = 3 if metric.config.use_prepass else 2
        controller = pl.RefineBudgetController()

        def frame(ctrl=controller):
            return pl.render_frame(metric, camera, params, sky, asettings,
                                   feats, controller=ctrl, device=dev)

        launches, first = [], None
        for i in range(5):
            raymarch.reset_launch_counts()
            img = frame()
            torch.cuda.synchronize()
            counts = dict(raymarch.LAUNCHES_BY_METRIC)
            launches.append(counts.get(name, 0))
            assert set(counts) == {name}, counts
            assert bool(torch.isfinite(img).all())
            assert tuple(img.shape) == (1080, 1920, 3)
            first = img if i == 0 else first
        assert launches == [first_n, 2, 2, 2, 2], (name, launches)
        black = float((first == 0).all(dim=-1).float().mean())
        d = (first - dense[name]).abs().max(dim=-1).values
        off_frac, median = float((d > 0.1).float().mean()), float(d.median())
        off_max, median_max = ADAPTIVE_MAX_OFF_FRAC, ADAPTIVE_MAX_MEDIAN
        print(f"[26 adaptive] {name}: 1920x1080 frames finite, kernel "
              f"launches {launches} (first, warm, steady), black fraction "
              f"{black:.4f}; first frame vs the dense frame: pixels with a "
              f"channel off by >0.1 {off_frac:.5f} (limit {off_max}), median "
              f"difference {median:.3g} (limit {median_max})")
        assert off_frac < off_max and median < median_max, (name, off_frac,
                                                             median)
        del d, first, img

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            frame()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"[26 sync] one steady adaptive 1080p {name} frame under "
              "set_sync_debug_mode('error'): no host synchronisation")

        with stage_events(pl, integrate) as read:
            steady = [timed_stages(frame, read) for _ in range(3)]
            first_total, first_ms = timed_stages(
                lambda: frame(pl.RefineBudgetController()), read)
        for i, (total, ms) in enumerate(steady):
            print(f"[26 time] steady adaptive {name} frame {i}: {total:.3f} "
                  f"ms = {stage_text(ms)} ms")
        print(f"[26 time] first adaptive {name} frame: {first_total:.3f} ms "
              f"= {stage_text(first_ms)} ms")
        out[name] = {
            "adaptive_first": {"launches": launches[0],
                               "frame_ms": first_total,
                               "stages_ms": first_ms},
            "adaptive_steady": {"launches": launches[-1],
                                "frame_ms": statistics.median(
                                    t for t, _ in steady),
                                "stages_ms": steady[-1][1]},
            "adaptive_vs_dense": {"off_frac": off_frac, "median": median,
                                  "limits": [off_max, median_max]},
        }
    return out


def cli_catalogue_a(dev) -> dict:
    """Phase 26's CLI run: ``--list`` names every ported metric, then one
    adaptive 1920x1080 ``kerr_newman_boyer`` frame on the card to a PNG (two
    launches: its config has no prepass)."""
    from geodesic_raytracing_tpu_torch import cli, metrics
    from geodesic_raytracing_tpu_torch.ops import raymarch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--list"])
    listed = buf.getvalue().split("\n")
    assert rc == 0 and set(CATALOGUES) <= set(listed), listed
    assert set(listed) >= set(metrics.list_metrics())
    png = ROOT / "build" / "chip_smoke" / "kerr_newman_cli_adaptive.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    raymarch.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--metric", "kerr_newman_boyer", "--adaptive",
                       "--width", "1920", "--height", "1080", "--pitch",
                       "-90", "--device", "cuda", "--out", str(png)])
    seconds = time.perf_counter() - t0
    counts = dict(raymarch.LAUNCHES_BY_METRIC)
    img = cli.read_png(png)
    black = float((img == 0).all(axis=-1).mean())
    print(f"[26 cli] --metric kerr_newman_boyer --adaptive 1920x1080 on "
          f"cuda: exit {rc} in {seconds:.1f} s, kernel launches {counts}, PNG "
          f"{img.shape}, black fraction {black:.4f}; --list names "
          f"{len(listed) - 1} metrics")
    assert rc == 0 and img.shape == (1080, 1920, 3), img.shape
    assert counts == {"kerr_newman_boyer": 2}, counts
    assert 0.0 < black < 0.9 and img.max() > 0, black
    return {"launches": counts["kerr_newman_boyer"], "seconds": seconds,
            "black_fraction": black}


# ---------------------------------------------------------------------------
# The third path: the differentiable fit, then the geodesic camera
# ---------------------------------------------------------------------------

# scripts/fit_bench.py's production train step: kerr_boyer at 256^2, a 2048
# step budget, recomputation windows of 128, soft step cap 512, target rs 1.1,
# start rs 0.95, learning rate 0.02.
FIT_SIZE, FIT_MAX_STEPS, FIT_REMAT, FIT_CAP = 256, 2048, 128, 512
FIT_TRUE_RS, FIT_START_RS, FIT_LR = 1.1, 0.95, 0.02
FIT_SCAN_STEPS = 896  # 1.25 x the hard cap 661, in whole windows of 128
# The gradient against the central difference of the same weighted loss with
# the probe frozen (tests/test_gradients.py's protocol and tolerance).
FIT_FD_EPS, FIT_FD_RTOL = 2e-3, 0.2
# The geodesic camera: the flagship camera falling in at 0.3 c, recorded for
# 4096 steps (cli --geodesic-camera), ridden at proper time 2; the card's
# recording against the CPU's: positions within this (rtol and atol).
GEO_SPEED, GEO_STEPS, GEO_TAU, GEO_POS_TOL = (-0.3, 0.0, 0.0), 4096, 2.0, 1e-4
GEO_SMALL = (480, 270)  # the twin frame's width and height


@contextlib.contextmanager
def train_step_events(integrate, mesh):
    """Inside the block every ``integrate.trace_rays`` call and every
    backward pass of the train step (``mesh._gradients``) is bracketed by
    CUDA events; yields a list that receives ``(what, start, end)`` with
    ``what`` "probe launch" (the ``while`` driver), "scan forward" or
    "backward"."""
    import torch

    marks = []

    def timed(what, fn, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*a, **kw)
        ev[1].record()
        marks.append((what, *ev))
        return out

    def trace(real, metric, state, params, features, opts, image_width):
        what = "probe launch" if opts.method == "while" else "scan forward"
        return timed(what, real, metric, state, params, features, opts,
                     image_width)

    real_grad = mesh._gradients
    mesh._gradients = lambda loss, leaves: timed("backward", real_grad, loss,
                                                 leaves)
    try:
        with swapped_trace(integrate, trace):
            yield marks
    finally:
        mesh._gradients = real_grad


def fit_path(dev) -> dict:
    """Phases 20-24: the differentiable fit at ``scripts/fit_bench.py``'s
    production size on the card.  20: the target render (the scan driver
    under ``no_grad``) and the train step's probe launch held to the plain
    march on all 65,536 rays; 21: the differentiable scan's forward against
    the probe on every kept lane; 22: the train step's gradient against the
    central difference of the same loss; 23: the first train step (phase
    20's), timed and split into probe launch, scan forward and backward, and
    the loss after it below the loss before; 24: the ``fit`` CLI on
    ``cuda``, twice, the second run resuming from the first's checkpoint
    and taking one more step.
    Returns the row's ``paths.fit`` and the largest position difference."""
    import tempfile

    import torch
    from geodesic_raytracing_tpu_torch import fit, metrics
    from geodesic_raytracing_tpu_torch.camera import Camera
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.parallel import (
        make_train_step, mesh, train_step_schedule)
    from geodesic_raytracing_tpu_torch.render import background as bg
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    metric = metrics.get_metric("kerr_boyer")
    feats = integrate.Features.for_metric(metric)
    settings = pl.RenderSettings(
        width=FIT_SIZE, height=FIT_SIZE, trace=integrate.TraceOptions(
            max_steps=FIT_MAX_STEPS, method="scan", remat_every=FIT_REMAT))
    camera = Camera.default(device=dev).rotate(pitch=-np.pi / 2)
    sky = bg.checker_background(256, 512, device=dev)
    n = FIT_SIZE * FIT_SIZE
    hard_cap, scan_opts, probe_opts = train_step_schedule(settings, FIT_CAP)
    assert scan_opts.max_steps == FIT_SCAN_STEPS, scan_opts

    # -- 20. target and probe -------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raymarch.reset_launch_counts()
    target = fit._render_target(metric, camera, metric.params(rs=FIT_TRUE_RS),
                                sky, settings, feats, grad_step_cap=FIT_CAP,
                                device=dev)
    torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    assert raymarch.launches() == 0  # the scan driver: eager torch
    assert tuple(target.shape) == (FIT_SIZE, FIT_SIZE, 3)
    assert bool(torch.isfinite(target).all())
    sky_frac = float((target.sum(-1) > 0).float().mean())
    assert 0.3 < sky_frac < 0.95, sky_frac
    step = make_train_step(metric, settings, feats, grad_step_cap=FIT_CAP,
                           device=dev)
    start = metric.params(rs=FIT_START_RS)
    # The first train step, timed (phase 23), its two marches recorded:
    # the probe launch and the differentiable scan.
    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_launches(integrate, with_opts=True) as calls, \
            train_step_events(integrate, mesh) as marks:
        raymarch.reset_launch_counts()
        t0 = time.perf_counter()
        first, loss0 = step(start, camera, target, sky, FIT_LR)
        loss0 = float(loss0)  # waits for the step
        step_s = time.perf_counter() - t0
        launches = raymarch.launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    assert launches == 1, launches  # the probe; the scan launches nothing
    assert [w for w, _, _ in marks] == ["probe launch", "scan forward",
                                        "backward"], marks
    split = {w: a.elapsed_time(b) for w, a, b in marks}
    (p_in, p_out, width, popts), (s_in, s_out, _, sopts) = calls
    s_out = integrate.RayState(*(t.detach() for t in s_out))
    assert (popts.method, popts.max_steps, width) == ("while", FIT_MAX_STEPS,
                                                      FIT_SIZE)
    assert (sopts.method, sopts.max_steps) == ("scan", FIT_SCAN_STEPS)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    plain = integrate.trace_rays_reference(metric, p_in, start, feats, popts)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    err = assert_equals_plain(
        f"[20 fit] probe launch at rs {FIT_START_RS}, {FIT_SIZE}^2, "
        f"{FIT_MAX_STEPS} steps (plain march {plain_ms:.1f} ms)", p_out, plain)
    del plain
    probe = launch_work(metric, p_in, start, feats, popts, FIT_SIZE)
    assert same_bits(probe.pop("state"), p_out)
    del probe["per_ray"]
    probe_bound, b_ops, b_bytes = bound_ms(n, probe["trials"])
    print(f"[20 fit] target at rs {FIT_TRUE_RS}: {target_s:.3f} s (scan "
          f"driver, {FIT_MAX_STEPS} iterations, no launch), sky fraction "
          f"{sky_frac:.4f}; probe: trial iterations {probe['trials']}, steps "
          f"mean {probe['mean_steps']:.2f} max {probe['max_steps']}, bound "
          f"{probe_bound:.3f} ms (operations {b_ops:.3f}, bytes "
          f"{b_bytes:.3f}); loss at rs {FIT_START_RS} {loss0:.6g}")

    # -- 21. the differentiable scan against the kernel on kept lanes ---------
    polar_r = torch.abs(metric.to_polar(p_out.position.T, start)[1])
    keep = ((p_out.status == integrate.ESCAPED)
            & (polar_r >= 0.5 * feats.universe_size)
            & (p_out.steps <= hard_cap))
    assert torch.equal(s_in.status == integrate.ACTIVE, keep)
    kept = int(keep.sum())
    k = integrate.RayState(*(t[keep] for t in p_out))
    s = integrate.RayState(*(t[keep] for t in s_out))
    st_eq, sp_eq, scan_err, close = compare_states(s, k)
    print(f"[21 scan] {FIT_SCAN_STEPS}-iteration scan forward vs the probe "
          f"launch on the {kept} kept lanes of {n}: status equal "
          f"{st_eq}/{kept}, steps equal {sp_eq}/{kept}, max |dpos| "
          f"{scan_err:.3g}, same bits {same_bits(s, k)}")
    assert kept > n // 4 and st_eq == kept and sp_eq == kept and close
    del calls, p_in, s_in, s_out, s, k

    # -- 22. the gradient against the central difference ---------------------
    t0 = time.perf_counter()
    at = metric.params(rs=1.0)
    loss1, grads = step.loss_and_grad(at, camera, target, sky)
    g = float(grads["rs"])
    lo, hi = (float(step.loss(metric.params(rs=1.0 + d), camera, target, sky,
                              probe_params=at))
              for d in (-FIT_FD_EPS, FIT_FD_EPS))
    fd = (hi - lo) / (2 * FIT_FD_EPS)
    print(f"[22 grad] ({time.perf_counter() - t0:.1f} s) d loss / d rs at "
          f"rs 1.0: autograd {g:.6g}, central "
          f"difference (eps {FIT_FD_EPS}, probe frozen) {fd:.6g}, relative "
          f"difference {abs(g - fd) / abs(fd):.4f} (limit {FIT_FD_RTOL}); "
          f"d loss / d a {float(grads['a']):.6g}")
    assert np.isfinite(g) and abs(g) > 1e-6 and np.isfinite(float(grads["a"]))
    assert abs(g - fd) <= FIT_FD_RTOL * abs(fd), (g, fd)

    # -- 23. the first train step (phase 20's): its time and its effect ------
    rs = [FIT_START_RS, float(first["rs"])]
    loss1 = float(step.loss(first, camera, target, sky))
    print(f"[23 train] step 0: {step_s:.3f} s = probe launch "
          f"{split['probe launch']:.3f} + scan forward "
          f"{split['scan forward']:.3f} + backward {split['backward']:.3f} ms "
          f"+ the rest at {FIT_SIZE}^2/{FIT_MAX_STEPS} (remat {FIT_REMAT}, "
          f"cap {FIT_CAP}, scan {FIT_SCAN_STEPS} iterations); peak memory "
          f"{peak / 2**30:.3f} GiB; rs {rs[0]:.5f} -> {rs[1]:.5f}, loss "
          f"{loss0:.6g} -> {loss1:.6g}")
    assert np.isfinite(loss0) and loss1 < loss0, (loss0, loss1)
    assert rs[0] < rs[1] <= FIT_TRUE_RS, rs

    # -- 24. the fit CLI on the card, then resumed ----------------------------
    outs = []
    with tempfile.TemporaryDirectory() as ck:
        for steps in (2, 3):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "geodesic_raytracing_tpu_torch.fit",
                 "--device", "cuda", "--metric", "schwarzschild", "--size",
                 "32", "--true", "rs=1.1", "--start", "rs=0.9", "--steps",
                 str(steps), "--checkpoint", ck, "--checkpoint-every", "2"],
                cwd=ROOT, capture_output=True,
                text=True, timeout=300)
            outs.append(run.stdout)
            print(f"[24 cli] fit --device cuda --steps {steps}: exit "
                  f"{run.returncode} in {time.perf_counter() - t0:.1f} s; "
                  + "; ".join(ln.strip() for ln in run.stdout.splitlines()
                              if ln.startswith(("resumed", "step", "fit"))))
            assert run.returncode == 0, run.stderr[-2000:]
    assert "resumed" not in outs[0] and "step   1 loss" in outs[0]
    assert "resumed from step 2" in outs[1] and "step   2 loss" in outs[1]
    assert "step   0 loss" not in outs[1]

    return {
        "config": {"metric": "kerr_boyer", "size": FIT_SIZE,
                   "max_steps": FIT_MAX_STEPS, "remat_every": FIT_REMAT,
                   "grad_step_cap": FIT_CAP, "grad_hard_cap": hard_cap,
                   "scan_steps": FIT_SCAN_STEPS},
        "probe": {"rays": n, "ms": split["probe launch"], "plain_ms": plain_ms,
                  "trial_iterations": probe["trials"],
                  "mean_steps": probe["mean_steps"],
                  "max_steps": probe["max_steps"],
                  "idle_lane_factor": probe["idle_factor"],
                  "bound_ms": probe_bound, "bound_by": "operations"
                  if probe_bound == b_ops else "bytes"},
        "launches_per_step": 1, "kept_lanes": kept, "scan_vs_probe_err":
        scan_err, "target_s": target_s, "s_per_step": step_s,
        "stages_ms": split, "peak_memory_bytes": peak,
        "losses": [loss0, loss1], "rs": rs, "grad": g, "grad_fd": fd,
    }, err


def first_difference(a, b):
    """The first node at which two recordings (one on the CPU) differ in any
    bit of position, velocity or step, or None."""
    import torch

    differ = torch.zeros(a.ds.shape[0], dtype=torch.bool)
    for x, y in ((a.positions, b.positions), (a.velocities, b.velocities),
                 (a.ds[:, None], b.ds[:, None])):
        differ |= (x.cpu().view(torch.int32)
                   != y.cpu().view(torch.int32)).any(dim=1)
    idx = torch.nonzero(differ).flatten()
    return int(idx[0]) if idx.numel() else None


def recording_gap(card_frame, cpu_frame, path, cpath):
    """Where the card's geodesic recording parts from the CPU's (ROADMAP
    Queue 3): the two launch frames (x0 and the tetrad es0, each built on
    its own device), the first node at which the recordings differ and the
    step there, and, on 2^20 seeded float32 values, how many results of
    each elementwise function the step uses differ between torch on the CPU
    and on the card.  Returns the numbers printed."""
    import torch

    (x0, es0), (cx0, ces0) = card_frame, cpu_frame
    dev = x0.device
    frame_err = {"x0": float((x0.cpu() - cx0).abs().max()),
                 "es0": float((es0.cpu() - ces0).abs().max())}
    frame_same = {k: bool(torch.equal(a.cpu().view(torch.int32),
                                      b.view(torch.int32)))
                  for k, a, b in (("x0", x0, cx0), ("es0", es0, ces0))}
    node = first_difference(path, cpath)
    out = {"frame_max_abs": frame_err, "frame_same_bits": frame_same,
           "first_node": node}
    at = ""
    if node is not None:
        at = (f", there ds {float(path.ds[node]):.9g} on the card, "
              f"{float(cpath.ds[node]):.9g} on the CPU")
    print(f"[25 gap] launch frame card vs CPU: x0 {x0.tolist()}, max |dx0| "
          f"{frame_err['x0']:.3g}, max |des0| {frame_err['es0']:.3g}, same "
          f"bits {frame_same}; first node that differs {node}{at}")
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.uniform(1e-3, 64.0, 1 << 20).astype(
        np.float32))
    ops = {"sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "sin": torch.sin,
           "cos": torch.cos, "exp": lambda v: torch.exp(-v),
           "log": torch.log, "reciprocal": torch.reciprocal,
           "x / 3": lambda v: v / 3.0}
    out["ops_differ"] = {}
    for name_, fn in ops.items():
        a, b = fn(vals), fn(vals.to(dev)).cpu()
        out["ops_differ"][name_] = int((a.view(torch.int32)
                                        != b.view(torch.int32)).sum())
    print(f"[25 gap] of {vals.numel()} float32 values, results that differ "
          f"between torch on the CPU and on the card: "
          + ", ".join(f"{k} {v}" for k, v in out["ops_differ"].items()))
    return out


def geodesic_camera_path(dev, sky) -> dict:
    """Phase 25: the geodesic camera.  The flagship camera's worldline
    falling in at 0.3 c is recorded on the card and on the CPU (the same
    count, positions within GEO_POS_TOL), its tetrad transported and ridden
    at proper time GEO_TAU; then the adaptive 1920x1080 frame from that
    camera through ``render_frame`` (a first frame: prepass, quarter and
    refine launches), and every launch of its 480x270 twin against the
    plain march.  Returns the row's ``paths.geodesic_camera`` and the
    largest position difference."""
    import torch
    from geodesic_raytracing_tpu_torch import physics
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.ops import tetrad as tet
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    metric, params, camera, asettings, feats = flagship_config(device=dev)
    camera = camera._replace(basis_speed=torch.tensor(
        GEO_SPEED, dtype=torch.float32, device=dev))

    def launch_frame(cam):
        x0 = pl.camera_to_generic(metric, cam, params)
        gab = metric.fn(x0, params)
        es0 = tet.boost_tetrad(tet.frame_basis(gab)[0], cam.basis_speed, gab)
        return x0, es0

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    x0, es0 = launch_frame(camera)
    path, record_s = timed(physics.record_geodesic, metric, x0, es0[0],
                           params, feats, GEO_STEPS)
    cpu_cam = camera.to("cpu")
    cx0, ces0 = launch_frame(cpu_cam)
    t0 = time.perf_counter()
    cpath = physics.record_geodesic(metric, cx0, ces0[0], params, feats,
                                    GEO_STEPS)
    cpu_record_s = time.perf_counter() - t0
    count, ccount = int(path.count), int(cpath.count)
    pos_err = float((path.positions.cpu() - cpath.positions).abs().max())
    print(f"[25 geodesic] {GEO_STEPS}-step recording of the flagship camera "
          f"at speed {GEO_SPEED}: card {record_s:.3f} s, CPU "
          f"{cpu_record_s:.3f} s; valid nodes {count} (CPU {ccount}), max "
          f"|dpos| {pos_err:.3g}, r {float(path.positions[0, 1]):.4f} -> "
          f"{float(path.positions[count - 1, 1]):.4f}, proper time "
          f"{float(path.proper_time[count - 1]):.4f}")
    gap = recording_gap((x0, es0), (cx0, ces0), path, cpath)
    assert count == ccount and count > 1
    assert torch.allclose(path.positions.cpu(), cpath.positions,
                          rtol=GEO_POS_TOL, atol=GEO_POS_TOL)
    tets, transport_s = timed(physics.parallel_transport_tetrads, metric,
                              path, es0, params)
    (pos, _, frame), interp_s = timed(physics.interpolate_camera, path, tets,
                                      GEO_TAU)
    assert bool(torch.isfinite(tets).all()) and bool(
        torch.isfinite(frame).all())
    gcam = camera.on_geodesic(pos, frame)
    print(f"[25 geodesic] transport of the tetrad along {count} nodes "
          f"{transport_s:.3f} s, interpolation at tau {GEO_TAU} "
          f"{interp_s * 1e3:.3f} ms: position "
          f"{[round(float(v), 4) for v in pos]}")

    with recorded_launches(integrate, with_opts=True) as launch:
        raymarch.reset_launch_counts()
        (img, frame_s) = timed(
            lambda: pl.render_frame(metric, gcam, params, sky, asettings,
                                    feats, device=dev))
        frame_launches = raymarch.launches()
    del launch
    assert frame_launches == 3, frame_launches  # prepass, quarter, refine
    assert tuple(img.shape) == (asettings.height, asettings.width, 3)
    assert bool(torch.isfinite(img).all())
    lit = float((img.sum(-1) > 0).float().mean())
    print(f"[25 geodesic] {asettings.width}x{asettings.height} adaptive frame "
          f"from the geodesic camera: "
          f"{frame_s * 1e3:.3f} ms (a first frame), kernel launches "
          f"{frame_launches}, lit fraction {lit:.4f}")
    small = dataclasses.replace(asettings, width=GEO_SMALL[0],
                                height=GEO_SMALL[1])
    with recorded_launches(integrate, with_opts=True) as launch:
        pl.render_frame(metric, gcam, params, sky, small, feats, device=dev)
    assert len(launch) == 3
    err, plain_ms = launches_vs_plain("[25 geodesic] 480x270 adaptive",
                                      metric, params, feats, launch)
    return {"record_steps": GEO_STEPS, "valid_nodes": count,
            "record_s": record_s, "cpu_record_s": cpu_record_s,
            "record_pos_err": pos_err, "transport_s": transport_s,
            "interpolate_ms": interp_s * 1e3, "frame_ms": frame_s * 1e3,
            "launches": frame_launches, "small_plain_ms": plain_ms,
            "record_gap": gap}, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="trace one steady 1080p frame with torch.profiler")
    ap.add_argument("--kernel-flags", default="",
                    help="nvcc flags appended to the kernel's build")
    ap.add_argument("--sweep", nargs="?", const=";".join(SWEEP),
                    help="time kernel variants, one per ';'-separated set of "
                    "nvcc flags, and stop")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2

    from geodesic_raytracing_tpu_torch import cli
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.render import background as bg
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    t_start = t_last = time.perf_counter()

    def took(phases):
        """Print the wall time of ``phases`` and of the run so far."""
        nonlocal t_last
        now = time.perf_counter()
        print(f"[time] phase {phases}: {now - t_last:.1f} s (run "
              f"{now - t_start:.1f} s)")
        t_last = now

    # The flagship settings as they come (the adaptive frame), and their
    # dense twin for the dense path.
    metric, params, camera, asettings, feats = flagship_config(device=dev)
    assert asettings.adaptive_sampling and asettings.shade_traced_only
    settings = dataclasses.replace(asettings, adaptive_sampling=False)
    if args.sweep is not None:
        print(f"[sweep] {smi} | torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
        sweep([v.strip() for v in args.sweep.split(";")], metric, params,
              camera, settings, feats)
        return 0

    # -- 1. device and build ------------------------------------------------
    # Every metric's library at once, one nvcc each.
    raymarch.NVCC_FLAGS = raymarch.with_flags(*shlex.split(args.kernel_flags))
    build_all_s = raymarch.build_all()
    t0 = time.perf_counter()
    raymarch.get_lib("kerr_boyer")
    build_s = time.perf_counter() - t0
    built = raymarch.BUILD_INFO["kerr_boyer", raymarch.NVCC_FLAGS]
    ptxas = raymarch.ptxas_summary(built["ptxas"])
    config = raymarch.kernel_config("kerr_boyer")
    print(f"[1 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} | nvcc build of "
          f"{len(raymarch.INSTANCES)} libraries at once {build_all_s:.2f} s, "
          f"kerr_boyer's {built['seconds']} s (load {build_s:.2f} s)")
    print(f"[1 device] nvcc {' '.join(raymarch.NVCC_FLAGS)} | ptxas {ptxas} "
          f"| {config}")
    assert ptxas["spill_store_bytes"] == 0 and ptxas["spill_load_bytes"] == 0
    ptxas_by_metric = {}
    for mname in sorted(raymarch.INSTANCES):
        info = raymarch.BUILD_INFO[mname, raymarch.NVCC_FLAGS]
        inst = raymarch.ptxas_instances(info["ptxas"])
        assert len(inst) == 6, (mname, sorted(inst))
        ptxas_by_metric[mname] = {"build_s": info["seconds"], "instances": {
            "".join(c for c, on in zip("PER", opt) if on) or "default": v
            for opt, v in sorted(inst.items())}}
        print(f"[1 build] {mname}: nvcc {info['seconds']} s; registers / "
              "stack / spill bytes by options (P planar, E Euler, R "
              "reparameterisation): " + ", ".join(
                  f"{k} {v['registers']}/{v['stack_bytes']}/"
                  f"{v['spill_store_bytes'] + v['spill_load_bytes']}"
                  for k, v in ptxas_by_metric[mname]["instances"].items()))
    spilling = [(m, k) for m, d in ptxas_by_metric.items()
                for k, v in d["instances"].items()
                if v["spill_store_bytes"] or v["spill_load_bytes"]]
    print(f"[1 build] instances that spill: {spilling or 'none'}")
    took("1")

    sky = bg.checker_background(device=dev)

    def kernel_and_plain(state, max_steps):
        opts = integrate.TraceOptions(max_steps=max_steps)
        k = raymarch.trace_rays_cuda(metric, state, params, feats, opts)
        p = integrate.trace_rays_reference(metric, state, params, feats, opts)
        torch.cuda.synchronize()
        return k, p

    # -- 2. kernel vs plain: the make_rays(64) set ---------------------------
    # (4096 of the flagship camera's pixels are held in phase 3, as a sample
    # of the frame's own launch and then all of it.)
    pos, vel = make_rays(64)
    sa = integrate.init_ray_state(metric, torch.from_numpy(pos).to(dev),
                                  torch.from_numpy(vel).to(dev), params, feats)
    sa.status[::7] = integrate.DEAD
    k, p = kernel_and_plain(sa, 4096)
    st, sp, err_a, close = compare_states(k, p)
    print(f"[2 rays] 64 rays, max_steps 4096: status equal {st}/64, "
          f"steps equal {sp}/64, max |dpos| {err_a:.3g}")
    assert st == 64 and sp >= SET_A_MIN_STEPS_EQ and close, (st, sp, err_a)
    graphed_equals_eager("[2 graph] 64 rays", metric, sa, params, feats,
                         integrate.TraceOptions(max_steps=4096))

    took("2")

    # -- 3. the main path at 1920x1080 ---------------------------------------
    # The frame's own march is recorded (its input and the kernel's output)
    # so that the plain twin can march the same rays.
    with recorded_launches(integrate) as launch:
        raymarch.reset_launch_counts()
        img = pl.render_frame(metric, camera, params, sky, settings, feats,
                              device=dev)
        torch.cuda.synchronize()
        launches = raymarch.launches()
    dense_img = img
    finite = bool(torch.isfinite(img).all())
    black = float((img == 0).all(dim=-1).float().mean())
    print(f"[3 frame] {settings.width}x{settings.height} kerr_boyer: "
          f"shape {tuple(img.shape)}, finite {finite}, kernel launches "
          f"{launches}, shadow fraction {black:.4f}")
    assert launches == 1, launches
    assert finite and tuple(img.shape) == (settings.height, settings.width, 3)
    assert SHADOW_RANGE[0] <= black <= SHADOW_RANGE[1], black
    (s_in, s_out, _), = launch
    n_rays = settings.width * settings.height
    assert s_in.position.shape == (n_rays, 4), s_in.position.shape
    # The plain twin marches every ray of the frame for its first
    # PLAIN_DEPTH trial iterations, against a kernel launch on the same
    # input with the same budget (a cut of depth: the whole plain march takes
    # 96-98 s, the longest ray's 10,230 steps at ~9 ms an eager step); the
    # frame's own launch is held to that launch on every ray that ended
    # within it (a ray's march is the same whatever budget is left).
    cut = dataclasses.replace(settings.trace, max_steps=PLAIN_DEPTH)
    k_cut = raymarch.trace_rays_cuda(metric, s_in, params, feats, cut,
                                     image_width=settings.width)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    p_all = integrate.trace_rays_reference(metric, s_in, params, feats, cut)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    rows = torch.from_numpy(np.sort(np.random.default_rng(1).choice(
        n_rays, 4096, replace=False))).to(dev)
    err_f = 0.0
    for what, pick in ((f"4096 of the frame's {n_rays}", rows),
                       (f"all {n_rays}", slice(None))):
        k = integrate.RayState(*(t[pick] for t in k_cut))
        p = integrate.RayState(*(t[pick] for t in p_all))
        n = k.status.numel()
        st, sp, err, close = compare_states(k, p)
        print(f"[3 frame] {what} kernel rays vs plain, {PLAIN_DEPTH} trial "
              f"iterations: status equal {st / n:.4f}, steps equal "
              f"{sp / n:.4f}, max |dpos| {err:.3g}, same bits "
              f"{same_bits(k, p)}; plain march {plain_ms:.1f} ms")
        assert st >= SET_B_MIN_STATUS_EQ * n, st
        assert sp >= SET_B_MIN_STEPS_EQ * n, sp
        assert close, err
        err_f = max(err_f, err)
    ended = k_cut.status != integrate.ACTIVE
    assert same_bits(integrate.RayState(*(t[ended] for t in k_cut)),
                     integrate.RayState(*(t[ended] for t in s_out)))
    print(f"[3 frame] the frame's launch equals that launch on the "
          f"{int(ended.sum())} rays that ended within {PLAIN_DEPTH} trial "
          f"iterations ({n_rays - int(ended.sum())} went on)")
    del p_all, p, k_cut, ended

    # The work of that launch, from one more launch on the same input (the
    # output must be the same again, in whatever order the warps ran).
    work = launch_work(metric, s_in, params, feats, settings.trace,
                       settings.width)
    k = work.pop("state")
    del work["per_ray"]
    assert same_bits(k, s_out), "two launches on one input disagree"
    print(f"[3 work] {n_rays} rays: committed steps mean "
          f"{work['mean_steps']:.2f} max {work['max_steps']}, trial "
          f"iterations {work['trials']} (mean {work['trials'] / n_rays:.2f});"
          f" idle-lane factor of the launch {work['idle_factor']:.4f} (a "
          f"warp per 8x4 pixel tile has {work['idle_tiles']:.4f}, per 32 "
          f"pixels of a row {work['idle_rows']:.4f})")
    del launch, s_in, s_out, k
    took("3")

    # -- 4. kernel frame vs plain frame at 480x270 ---------------------------
    small = dataclasses.replace(settings, width=480, height=270)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    state, ku, _ = pl.init_camera_rays(metric, camera, params, small, feats,
                                       device=dev)
    torch.cuda.synchronize()
    ev[0].record()
    fk = raymarch.trace_rays_cuda(metric, state, params, feats, small.trace,
                                  image_width=small.width)
    ev[1].record()
    fp = integrate.trace_rays_reference(metric, state, params, feats,
                                        small.trace)
    ev[2].record()
    torch.cuda.synchronize()
    small_ms = ev[0].elapsed_time(ev[1])
    small_plain_ms = ev[1].elapsed_time(ev[2])
    small_work = launch_work(metric, state, params, feats, small.trace,
                             small.width)
    small_bound, _, _ = bound_ms(small.width * small.height,
                                 small_work["trials"])
    imgs = [pl.shade(pl.compute_render_data(metric, f, ku, params, feats),
                     sky, small) for f in (fk, fp)]
    rmse, bad = golden_gate(to_srgb8(imgs[0]), to_srgb8(imgs[1]))
    print(f"[4 gate] 480x270 kernel vs plain frame: RMSE {rmse:.4f}, "
          f"pixels off by >32 {bad:.5f}; trace kernel {small_ms:.3f} ms, "
          f"plain {small_plain_ms:.1f} ms")
    assert rmse < GATE_RMSE and bad < GATE_BAD_FRAC, (rmse, bad)
    took("4")

    # -- 5. timing the 1080p frame -------------------------------------------
    def timed_frame():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        e[0].record()
        s, ku_, _ = pl.init_camera_rays(metric, camera, params, settings,
                                        feats, device=dev)
        e[1].record()
        fin = integrate.trace_rays(metric, s, params, feats, settings.trace,
                                   image_width=settings.width)
        e[2].record()
        rd = pl.compute_render_data(metric, fin, ku_, params, feats)
        e[3].record()
        pl.shade(rd, sky, settings)
        e[4].record()
        torch.cuda.synchronize()
        return [e[i].elapsed_time(e[i + 1]) for i in range(4)]

    timed_frame()  # warm
    splits = [timed_frame() for _ in range(3)]
    totals = [sum(s) for s in splits]
    for i, (s, t) in enumerate(zip(splits, totals)):
        print(f"[5 time] frame {i}: {t:.3f} ms ({n_rays / t / 1e3:.4f} "
              f"Mrays/s) = ray init {s[0]:.3f} + trace kernel {s[1]:.3f} + "
              f"render data {s[2]:.3f} + shade {s[3]:.3f} ms")
    kernel_ms = statistics.median(s[1] for s in splits)
    bound, bound_ops, bound_bytes = bound_ms(n_rays, work["trials"])
    print(f"[5 bound] 1080p trace kernel {kernel_ms:.3f} ms (median of "
          f"{len(splits)}); bound {bound:.3f} ms = {work['trials']} trial "
          f"iterations x {OPS_PER_TRIAL} operations / "
          f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s (bound by operations; the "
          f"bytes bound is {bound_bytes:.3f} ms); share of the bound "
          f"{bound / kernel_ms:.4f}; 480x270: {small_ms:.3f} ms, bound "
          f"{small_bound:.3f} ms, share {small_bound / small_ms:.4f}")
    assert bound == bound_ops
    dense_mrays = bench_protocol_mrays(
        lambda: pl.render_frame(metric, camera, params, sky, settings, feats,
                                device=dev), n_rays)
    print(f"[5 bench] dense 1080p frame by bench.py's protocol (3 passes of "
          f"4 frames issued back to back and drained once, best pass, host "
          f"wall clock): {dense_mrays:.4f} Mrays/s "
          f"({n_rays / dense_mrays / 1e3:.3f} ms a frame)")

    # -- 7. the CLI on the card: bench protocol, then one 1080p PNG ----------
    cli_args = ["--width", "1920", "--height", "1080", "--pitch", "-90",
                "--device", "cuda"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--bench", "kerr_boyer", "--frames", "2", *cli_args])
    bench = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("Frametime Elapsed: ")]
    assert rc == 0 and len(bench) == 2, buf.getvalue()
    png = ROOT / "build" / "chip_smoke" / "kerr_cli.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--metric", "kerr_boyer", *cli_args, "--out",
                       str(png)])
    cli_img = cli.read_png(png)
    cli_black = float((cli_img == 0).all(axis=-1).mean())
    print(f"[7 cli] --bench kerr_boyer 1920x1080 on cuda: "
          f"{'; '.join(bench)}; PNG {cli_img.shape}, shadow fraction "
          f"{cli_black:.4f}")
    assert rc == 0 and cli_img.shape == (1080, 1920, 3), cli_img.shape
    assert SHADOW_RANGE[0] <= cli_black <= SHADOW_RANGE[1], cli_black
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--bench", "kerr_boyer", "--adaptive", "--frames", "2",
                       *cli_args])
    bench = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("Frametime Elapsed: ")]
    assert rc == 0 and len(bench) == 2, buf.getvalue()
    apng = png.with_name("kerr_cli_adaptive.png")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--metric", "kerr_boyer", "--adaptive", *cli_args,
                       "--out", str(apng)])
    cli_aimg = cli.read_png(apng)
    cli_black = float((cli_aimg == 0).all(axis=-1).mean())
    cli_rmse, cli_bad = golden_gate(cli_aimg, cli_img)
    print(f"[7 cli] --bench kerr_boyer --adaptive 1920x1080 on cuda: "
          f"{'; '.join(bench)}; PNG {cli_aimg.shape}, shadow fraction "
          f"{cli_black:.4f}; against the dense PNG: RMSE {cli_rmse:.4f}, "
          f"pixels off by >32 {cli_bad:.5f}")
    assert rc == 0 and cli_aimg.shape == (1080, 1920, 3), cli_aimg.shape
    assert SHADOW_RANGE[0] <= cli_black <= SHADOW_RANGE[1], cli_black
    took("5-7")

    # -- 8. the adaptive flagship frame at 1920x1080, first and steady --------
    # flagship_config as it comes, a fresh controller, six frames; the first
    # frame's three launches and a steady frame's two are recorded.
    nq = n_rays // 4
    controller = pl.RefineBudgetController()
    demands = []
    observe = controller.observe

    def observing(demand):
        demands.append(demand)
        observe(demand)

    controller.observe = observing

    def adaptive_frame():
        return pl.render_frame(metric, camera, params, sky, asettings, feats,
                               controller=controller, device=dev)

    recorded, path_launches, aimg = {}, [], None
    for i in range(6):
        with recorded_launches(integrate) as launch:
            raymarch.reset_launch_counts()
            img = adaptive_frame()
            torch.cuda.synchronize()
            path_launches.append(raymarch.launches())
        if i in (0, 5):
            recorded[i] = launch
        aimg = img if i == 0 else aimg
        finite = bool(torch.isfinite(img).all())
        black = float((img == 0).all(dim=-1).float().mean())
        k = launch[-1][0].status.numel() // 3
        print(f"[8 adaptive] frame {i}: kernel launches {path_launches[-1]} "
              f"({', '.join(str(s.status.numel()) for s, _, _ in launch)} "
              f"rays), k {k} of {nq} blocks, demand "
              f"{float(demands[-1]):.6f}, controller bucket "
              f"{controller.fraction(1.0):.4f}; shape {tuple(img.shape)}, "
              f"finite {finite}, shadow fraction {black:.4f}")
        assert finite and tuple(img.shape) == (1080, 1920, 3)
        assert SHADOW_RANGE[0] <= black <= SHADOW_RANGE[1], black
        del launch
    assert path_launches == [3, 2, 2, 2, 2, 2], path_launches
    assert [w for _, _, w in recorded[0]] == [120, 960, None]
    assert [w for _, _, w in recorded[5]] == [960, None]

    # -- 9. the adaptive launches at 1080p: work, and the plain twin ----------
    # The prepass is marched once more by the plain twin; the quarter grid is
    # an image launch like the dense frame's, which phase 3 held, and the
    # refine set (the launch that is no image and holds rays born DEAD) costs
    # the plain twin 60-70 s at 1080p: both are held at 480x270 in phase 11
    # with the prepass, and the refine set's kernel output is held to a
    # second launch here.
    err_ad, first = 0.0, []
    for what, (s_in, s_out, width) in zip(("prepass", "quarter", "refine"),
                                          recorded[0]):
        n = s_in.status.numel()
        lw = launch_work(metric, s_in, params, feats, asettings.trace,
                           width)
        assert same_bits(lw.pop("state"), s_out)
        del lw["per_ray"]
        if what != "prepass":
            born_dead = born_dead_untouched(s_in, (s_out,))
            print(f"[9 launches] first frame, {what}: {n} rays ({born_dead} "
                  "born DEAD, untouched by the kernel), a second launch on "
                  "the same input gives the same bits")
        else:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            p = integrate.trace_rays_reference(metric, s_in, params, feats,
                                               asettings.trace)
            ev[1].record()
            torch.cuda.synchronize()
            lw["plain_ms"] = ev[0].elapsed_time(ev[1])
            born_dead = born_dead_untouched(s_in, (s_out, p))
            st, sp, err, close = compare_states(s_out, p)
            print(f"[9 launches] first frame, {what}: {n} rays ({born_dead} "
                  f"born DEAD, untouched by kernel and plain twin), kernel "
                  f"vs plain: status equal {st / n:.4f}, steps equal "
                  f"{sp / n:.4f}, max |dpos| {err:.3g}; plain march "
                  f"{lw['plain_ms']:.1f} ms")
            assert st >= SET_B_MIN_STATUS_EQ * n, st
            assert sp >= SET_B_MIN_STEPS_EQ * n, sp
            assert close, err
            err_ad = max(err_ad, err)
            del p
        lw.update(name=what, image_width=width, born_dead=born_dead)
        first.append(lw)
    assert first[0]["born_dead"] == 0 and first[2]["born_dead"] > 0
    took("8-9")

    # -- 10. adaptive against dense at 1080p ---------------------------------
    d = (aimg - dense_img).abs().max(dim=-1).values
    off_frac, median = float((d > 0.1).float().mean()), float(d.median())
    a_rmse, a_bad = golden_gate(to_srgb8(aimg), to_srgb8(dense_img))
    print(f"[10 dense] adaptive vs dense 1080p frame: pixels with a channel "
          f"off by >0.1 {off_frac:.5f} (limit {ADAPTIVE_MAX_OFF_FRAC}), "
          f"median difference {median:.3g} (limit {ADAPTIVE_MAX_MEDIAN}), "
          f"mean {float(d.mean()):.5f}; sRGB RMSE {a_rmse:.4f}, pixels off "
          f"by >32 {a_bad:.5f}")
    assert off_frac < ADAPTIVE_MAX_OFF_FRAC and median < ADAPTIVE_MAX_MEDIAN
    del d, dense_img

    # -- 11. adaptive kernel frame vs plain frame at 480x270 -----------------
    asmall = dataclasses.replace(asettings, width=480, height=270)
    with recorded_launches(integrate) as launch:
        raymarch.reset_launch_counts()
        fk = pl.render_frame(metric, camera, params, sky, asmall, feats,
                             device=dev)
        small_launches = raymarch.launches()
    plain = []
    with plain_marches(integrate, plain):
        fp = pl.render_frame(metric, camera, params, sky, asmall, feats,
                             device=dev)
    assert small_launches == 3 and raymarch.launches() == 3
    rmse, bad = golden_gate(to_srgb8(fk), to_srgb8(fp))
    print(f"[11 gate] 480x270 adaptive frame, kernel vs plain marches: RMSE "
          f"{rmse:.4f}, pixels off by >32 {bad:.5f}")
    assert rmse < GATE_RMSE and bad < GATE_BAD_FRAC, (rmse, bad)
    for what, (s_in, s_out, _), (p_in, p) in zip(
            ("prepass", "quarter", "refine"), launch, plain):
        # The plain frame has marched these very rays when its input holds
        # the same bits as the kernel launch's.
        if not same_bits(p_in, s_in):
            p = integrate.trace_rays_reference(metric, s_in, params, feats,
                                               asmall.trace)
        n = s_in.status.numel()
        born_dead = born_dead_untouched(s_in, (s_out, p))
        st, sp, err, close = compare_states(s_out, p)
        print(f"[11 launches] 480x270 adaptive frame, {what}: {n} rays "
              f"({born_dead} born DEAD, untouched by kernel and plain twin), "
              f"kernel vs plain: status equal {st / n:.4f}, steps equal "
              f"{sp / n:.4f}, max |dpos| {err:.3g}")
        assert st >= SET_B_MIN_STATUS_EQ * n, st
        assert sp >= SET_B_MIN_STEPS_EQ * n, sp
        assert close, err
        err_ad = max(err_ad, err)
    del launch, plain, p
    took("10-11")

    # -- 12. a steady adaptive frame never waits for the device --------------
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adaptive_frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[12 sync] one steady adaptive 1080p frame under "
          "set_sync_debug_mode('error'): no host synchronisation")

    # -- 13. timing and work of the adaptive frame ---------------------------

    with stage_events(pl, integrate) as read:
        steady = [timed_stages(adaptive_frame, read) for _ in range(3)]
        fresh = pl.RefineBudgetController()
        first_total, first_ms = timed_stages(
            lambda: pl.render_frame(metric, camera, params, sky, asettings,
                                    feats, controller=fresh, device=dev),
            read)
    for i, (total, ms) in enumerate(steady):
        print(f"[13 time] steady adaptive frame {i}: {total:.3f} ms "
              f"({n_rays / total / 1e3:.4f} Mrays/s at {n_rays} pixels) = "
              f"{stage_text(ms)} ms")
    print(f"[13 time] first adaptive frame (fresh controller): "
          f"{first_total:.3f} ms = {stage_text(first_ms)} ms (prepass launch "
          f"{first_ms['prepass launch']:.3f} ms of its stage)")
    adaptive_mrays = bench_protocol_mrays(adaptive_frame, n_rays)
    print(f"[13 bench] adaptive 1080p frame by bench.py's protocol (3 passes "
          f"of 4 frames issued back to back and drained once, best pass, "
          f"host wall clock): {adaptive_mrays:.4f} Mrays/s "
          f"({n_rays / adaptive_mrays / 1e3:.3f} ms a frame); the dense "
          f"frame in this run: {dense_mrays:.4f} Mrays/s")

    def launch_row(work, ms):
        b, b_ops, _ = bound_ms(work["rays"], work["trials"])
        assert b == b_ops
        row = {"name": work["name"], "rays": work["rays"],
               "active_rays": work["active"], "image_width":
               work["image_width"], "trial_iterations": work["trials"],
               "mean_steps": work["mean_steps"], "max_steps":
               work["max_steps"], "idle_lane_factor": work["idle_factor"],
               "ms": ms, "bound_ms": b, "share_of_bound": b / ms}
        if "plain_ms" in work:
            row["plain_ms"] = work["plain_ms"]
        print(f"[13 work] {work['name']}: {row['rays']} rays "
              f"({row['active_rays']} ACTIVE at launch), trial iterations "
              f"{row['trial_iterations']}, committed steps mean "
              f"{row['mean_steps']:.2f} max {row['max_steps']}, idle-lane "
              f"factor {row['idle_lane_factor']:.4f}; kernel {ms:.3f} ms, "
              f"bound {b:.3f} ms (by operations), share {b / ms:.4f}")
        return row

    first_rows = [launch_row(w, first_ms[t]) for w, t in zip(
        first, ("prepass launch", "quarter trace", "refine trace"))]
    steady_rows = []
    for what, (s_in, s_out, width) in zip(("quarter", "refine"),
                                          recorded[5]):
        lw = launch_work(metric, s_in, params, feats, asettings.trace,
                           width)
        assert same_bits(lw.pop("state"), s_out)
        del lw["per_ray"]
        lw.update(name=what, image_width=width)
        steady_rows.append(launch_row(lw, statistics.median(
            ms[f"{what} trace"] for _, ms in steady)))

    # A cost sort of the refine launch's rays is measured only where the
    # launch leaves more than SORT_IDLE_FACTOR of its lane turns idle.
    sort = None
    refine_idle = steady_rows[1]["idle_lane_factor"]
    if refine_idle > SORT_IDLE_FACTOR:
        # The recorded steady frame's selection, from its quarter launch.
        (_, q_out, _), (r_in, _, _) = recorded[5]
        cam_frame = pl.camera_frame(metric, camera, params)
        _, ku, _ = pl.rays_for_pixels(metric, camera, *cam_frame, params,
                                      asettings, feats,
                                      *pl._qcoords(asettings, dev))
        _, _, _, sel, _, r_again, _, _ = pl._refine_setup(
            metric, camera, cam_frame, params, asettings, feats, q_out, ku,
            None, r_in.status.numel() // 3)
        assert same_bits(r_again, r_in)
        sort = cost_sorted_launch(metric, r_in, q_out.steps, sel, params,
                                  feats, asettings.trace, (540, 960))
        print(f"[13 sort] refine launch, idle-lane factor {refine_idle:.4f} "
              f"> {SORT_IDLE_FACTOR}: unsorted {sort['ms']:.3f} ms; cost-"
              f"sorted {sort['sorted_ms']:.3f} ms with its sort, gather and "
              f"scatter (launch alone {sort['sorted_launch_ms']:.3f} ms, "
              f"idle-lane factor {sort['sorted_idle_factor']:.4f}), same "
              f"bits {sort['identical']}; the frame marches them unsorted")
        assert sort["identical"]
    else:
        print(f"[13 sort] refine launch, idle-lane factor {refine_idle:.4f} "
              f"<= {SORT_IDLE_FACTOR}: no cost sort measured")
    steady_total = statistics.median(t for t, _ in steady)
    # Both traces come after every timing, so that the profiler cannot
    # disturb one.
    if args.profile:
        profile_frame(timed_frame, sum(totals) / len(totals), "dense")
        profile_frame(adaptive_frame, steady_total, "adaptive")
    del recorded
    took("12-13")

    # -- 14-19. the second path ------------------------------------------------
    rules = tangent_rules(dev)
    instance_err = check_instances(dev)
    took("14")
    options_err = check_step_options(dev)
    took("15")
    schw = second_path(dev, sky)
    took("16")
    planar = planar_vs_4d(dev, sky)
    took("17")
    goldens = golden_scenes(dev)
    took("18")
    per_metric, dense_a = every_metric_dense(dev, sky)
    took("19")

    # -- 20-25. the third path -------------------------------------------------
    fit_row, fit_err = fit_path(dev)
    took("20-24")
    geo_row, geo_err = geodesic_camera_path(dev, sky)
    took("25")

    # -- 26. the fourth, fifth and sixth paths: catalogue slices A, B and C's
    # adaptive 1080p frames ----------------------------------------------
    catalogue = catalogue_paths(dev, sky, dense_a)
    del dense_a
    fourth_cli = cli_catalogue_a(dev)
    took("26")

    def instance_row(mname):
        """The row of an instance other than ``kerr_boyer``: ms, plain_ms and
        bound_ms of its dense 1080p launch through ``render_frame`` (the
        same rays for all three), as ``kerr_boyer``'s row, or of that
        launch cut to ``DENSE_PLAIN_DEPTH`` trial iterations where a ray
        takes more (``measured_at``); its 480x270 launch under ``small``,
        its 1080p one under ``full``, the cut one under ``depth``; for
        catalogue slices A, B and C, ``launches`` and ``paths`` of phase 26's
        adaptive 1080p frames."""
        r = per_metric[mname]
        at = r["depth"] or r["full"]
        row = {
            "name": f"raymarch_{mname}",
            "route": "cuda",
            "source": "geodesic_raytracing_tpu_torch/csrc/raymarch.cu",
            "replaces": "geodesic_raytracing_tpu/ops/pallas/raymarch.py:488",
            "launches": r["launches"],
            "max_abs_err": max(r["max_abs_err"], instance_err[mname]),
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "share_of_bound": at["share_of_bound"],
            "measured_at": "1920x1080" if at is r["full"] else (
                f"1920x1080, first {DENSE_PLAIN_DEPTH} trial iterations"),
            "library_ms": None,  # no PyTorch call computes a geodesic march
            "rays": r["full"]["rays"],
            "planar": r["full"]["planar"],
            "trial_iterations": r["full"]["trial_iterations"],
            "mean_steps": r["full"]["mean_steps"],
            "max_steps": r["full"]["max_steps"],
            "idle_lane_factor": r["full"]["idle_lane_factor"],
            "ops_per_trial": r["full"]["ops_per_trial"],
            "small": r["small"],
            "full": r["full"],
            "depth": r["depth"],
            "ptxas": ptxas_by_metric[mname],
            "golden": goldens[mname],
        }
        if mname in catalogue:
            row["launches"] = catalogue[mname]["adaptive_first"]["launches"]
            row["paths"] = catalogue[mname]
            if mname == "kerr_newman_boyer":
                row["paths"]["cli"] = fourth_cli
        if mname == "alcubierre":
            row["golden_alcubierre_paper"] = goldens["alcubierre_paper"]
        if mname == "schwarzschild":
            row["max_abs_err"] = max(row["max_abs_err"], options_err,
                                     schw["max_abs_err"])
            row["paths"] = schw
            row["planar_vs_4d"] = planar
        return row

    table = {"kernels": [{
        "name": "raymarch_kerr_boyer",
        "route": "cuda",
        "source": "geodesic_raytracing_tpu_torch/csrc/raymarch.cu",
        "replaces": "geodesic_raytracing_tpu/ops/pallas/raymarch.py:488",
        "launches": launches,
        "max_abs_err": max(err_a, err_f, err_ad,
                           fit_err, geo_err),
        # Of the main path's launch, the 1080p frame's 2,073,600 rays.
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "plain_max_steps": PLAIN_DEPTH,
        "bound_ms": bound,
        "bound_by": "operations",
        "share_of_bound": bound / kernel_ms,
        "library_ms": None,  # no PyTorch call computes an adaptive march
        "rays": n_rays,
        "trial_iterations": work["trials"],
        "mean_steps": work["mean_steps"],
        "max_steps": work["max_steps"],
        "idle_lane_factor": work["idle_factor"],
        # Of the 480x270 frame's launch (one wave of blocks: its time is
        # that of its longest ray).
        "small": {
            "rays": small.width * small.height, "ms": small_ms,
            "plain_ms": small_plain_ms, "bound_ms": small_bound,
            "share_of_bound": small_bound / small_ms},
        "build_flags": " ".join(raymarch.NVCC_FLAGS),
        "ptxas": {**ptxas, **config, **ptxas_by_metric["kerr_boyer"]},
        "golden_kerr_redshift": goldens["kerr_redshift"],
        # Phase 14's probe: inputs on which each candidate tangent rule
        # differs from torch.func.jvp on the card (the first is dual.cuh's).
        "tangent_rules": rules,
        # Launches of one frame of each path through render_frame, counted
        # from 0 just before it; the adaptive launches one by one.
        "paths": {
            "dense": {"launches": launches, "frame_ms":
                      statistics.median(totals), "bench_mrays": dense_mrays},
            "adaptive_first": {"launches": path_launches[0], "frame_ms":
                               first_total, "stages_ms": first_ms,
                               "launch": first_rows},
            "adaptive_steady": {"launches": path_launches[-1], "frame_ms":
                                steady_total, "stages_ms": steady[-1][1],
                                "bench_mrays": adaptive_mrays,
                                "launch": steady_rows, "refine_sort": sort},
            # The train step's probe (one launch a step) and the fit.
            "fit": fit_row,
            # A first adaptive frame from the camera on its geodesic.
            "geodesic_camera": geo_row,
        },
    }, *(instance_row(m) for m in sorted(per_metric))]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
