"""The kernel's bound: published peaks of one H100, operations per step of
each kernel instance, and the bytes a launch must move.

The ray-march kernel's roofline share is the least time the card could take
for a frame's launches, the larger of operations over the float32 peak and
bytes over the memory bandwidth, over the kernel's measured time.

* Operations: the steps each ray ACTIVE at a launch committed (the
  ``RayState.steps`` of the march that the correctness check accepts:
  the reference's), summed over the frame's launches, times the operations
  of one step of the launched instance.  The table is a frozen copy of
  ``chip_smoke.OPS_BY_INSTANCE`` at commit e647ccc: float32 operations of
  one trial iteration counted from ``csrc/march.cuh`` and the metric's
  header (an add, a multiply, a compare or select, and each of sin, cos,
  1/x, sqrt, rsqrt as one), keyed by (metric, planar).  It counts a trial
  iteration; committed steps leave out the rejected trials (Kerr takes
  about 1.002 trials a step), so the share reads a little low.
* Bytes: 132 a ray ACTIVE at launch (its 64-byte state read and written
  once, and its launch |v^t| read) and 4 for any other ray (the status the
  kernel reads to skip it).
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: float32 outside
# the tensor cores, counting a fused multiply-add as two; HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
RAY_BYTES_ACTIVE = 2 * 64 + 4
RAY_BYTES_INACTIVE = 4

OPS_BY_INSTANCE = {
    ("kerr_boyer", False): 65 + 89 + 111,
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


def bound_s(launches, ops_per_step: int) -> tuple[float, float, float]:
    """``(bound, operations bound, bytes bound)`` in seconds of launches
    with fields ``rays``, ``active`` and ``steps``."""
    ops = sum(l.steps for l in launches) * ops_per_step / PEAK_FP32_FLOPS
    byt = sum(l.active * RAY_BYTES_ACTIVE
              + (l.rays - l.active) * RAY_BYTES_INACTIVE
              for l in launches) / PEAK_BYTES_PER_S
    return max(ops, byt), ops, byt
