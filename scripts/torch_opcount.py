"""Count the float operations of the ray-march kernel's metric instances from
the kernel's own code.

For each instance, a small C++ file instantiates two functions of
``geodesic_raytracing_tpu_torch/csrc/march.cuh`` on host types: ``metric``,
the metric with its dual partials as one trial iteration evaluates them
(``M::g`` on the seeded coordinates, or ``M::fl`` for a Kerr-Schild
decomposition), and ``accel``, the whole geodesic acceleration
(``acceleration<M, false>``: the metric, the contraction and the inverse or
Sherman-Morrison).  g++ compiles them with optimisation (inlining, constant
folding, dead tangents and the ``Zero`` imaginary parts gone, common terms
shared, no FMA contraction, no vectorisation) and dumps its final GIMPLE;
this script counts the operations there by the kernel's rule
(``chip_smoke.OPS_PER_TRIAL``): an add, a subtract, a multiply, a divide, a
compare, a min or max, a select and each call of sqrt, sin, cos, exp, log,
log1p, tanh, pow, atan as one; negations, |x| and conversions as none.  A
select is a float conditional expression or a float PHI node that merges
two values after a branch.

The count of ``accel`` less that of ``metric`` is the contraction and the
inverse.  The step, the probe and the controller are not counted here (see
``chip_smoke.OPS_BY_INSTANCE``).

Usage (needs g++; no GPU, no torch):

    python scripts/torch_opcount.py [metric ...]

With no names it counts every instance of ``ops/raymarch.INSTANCES``.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "geodesic_raytracing_tpu_torch" / "csrc"

SHIM = r"""
#include "march.cuh"

using M = grt::GRT_METRIC;

namespace {

constexpr int kI[10] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3};
constexpr int kJ[10] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3};

template <class D>
void put_dual(const D& d, float* out) {
  out[0] = d.v;
  for (int k = 0; k < grt::kTangents; ++k) out[1 + k] = d.d[k];
}

template <class G, int... E>
void put(const G& g, float* out, std::integer_sequence<int, E...>) {
  ((out[E] = grt::to_float(grt::gval<kI[E], kJ[E]>(g))), ...);
  auto tangents = [&](auto k) {
    constexpr int K = decltype(k)::value;
    if constexpr (K < M::n_deps) {
      float* o = out + 10 * (1 + K);
      ((o[E] = grt::to_float(grt::gtan<K, kI[E], kJ[E]>(g))), ...);
    }
  };
  tangents(std::integral_constant<int, 0>{});
  tangents(std::integral_constant<int, 1>{});
  tangents(std::integral_constant<int, 2>{});
  tangents(std::integral_constant<int, 3>{});
}

// A template, so that the branch a metric does not take is discarded.
template <class MM>
inline void metric(const MM* m, const float* x, float* out) {
  if constexpr (grt::HasRank1<MM>::value) {
    const auto d = m->fl(grt::coordinate<MM, false, 1>(x[1]),
                         grt::coordinate<MM, false, 2>(x[2]),
                         grt::coordinate<MM, false, 3>(x[3]));
    put_dual(d.f, out);
    put_dual(d.l1, out + 5);
    put_dual(d.l2, out + 10);
    put_dual(d.l3, out + 15);
  } else {
    const auto g = m->g(grt::coordinate<MM, false, 0>(x[0]),
                        grt::coordinate<MM, false, 1>(x[1]),
                        grt::coordinate<MM, false, 2>(x[2]),
                        grt::coordinate<MM, false, 3>(x[3]));
    put(g, out, std::make_integer_sequence<int, 10>{});
  }
}

}  // namespace

extern "C" __attribute__((noinline)) void grt_opcount_metric(
    const M* m, const float* x, float* out) {
  metric(m, x, out);
}

extern "C" __attribute__((noinline)) void grt_opcount_accel(
    const M* m, const float* x, const float* v, float* out) {
  grt::acceleration<M, false>(*m, x, v, out);
}
"""

FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fno-math-errno",
         "-fno-tree-vectorize", "-fno-tree-slp-vectorize")

# Calls counted as one operation each (g++'s builtins, libm names and
# internal functions), and those counted as two (a merged sin and cos).
CALLS_ONE = re.compile(
    r"\b(?:__builtin_)?(?:sqrtf|sinf|cosf|expf|logf|log1pf|tanhf|powf|atanf|"
    r"atan2f|acosf|asinf|coshf|sinhf|expm1f|cbrtf)\s*\(|\.SQRT\s*\(")
CALLS_TWO = re.compile(r"\b(?:__builtin_)?(?:sincosf|cexpif)\s*\(")
BINARY = re.compile(r"^\s*(\S+) = (\S+) ([-+*/]) (\S+);$")
COMPARE = re.compile(r"(?:^\s*\S+ = |if \()\S+ (?:<|<=|>|>=|==|!=) \S+")
MINMAX = re.compile(r"\b(?:MIN|MAX)_EXPR\b")
COND = re.compile(r"^\s*(\S+) = \S+ \? \S+ : \S+;$")
PHI = re.compile(r"^\s*#\s*(\S+) = PHI <")


def instances() -> dict[str, str]:
    """``ops/raymarch.INSTANCES`` (metric name -> struct), read from the
    source without importing the package."""
    tree = ast.parse((REPO / "geodesic_raytracing_tpu_torch" / "ops" /
                      "raymarch.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "INSTANCES"):
            return {k: v[0] for k, v in ast.literal_eval(node.value).items()}
    raise RuntimeError("INSTANCES not found in ops/raymarch.py")


def function_bodies(dump: str) -> dict[str, str]:
    """The GIMPLE body of every function in the dump, by the name its call
    sites use (``grt::kerr_boyer_g<...>``, ``grt_opcount_metric``)."""
    out = {}
    for m in re.finditer(r"^;; Function (.*?) \(\S+, funcdef_no=.*?\n(.*?)"
                         r"(?=^;; Function |\Z)", dump, re.M | re.S):
        out[m.group(1)] = m.group(2)
    return out


def float_names(body: str) -> set[str]:
    """SSA names and variables the body declares as float or double."""
    names = set()
    for m in re.finditer(r"^\s*(?:const )?(?:float|double) ([^;]+);", body,
                         re.M):
        names.update(n.strip() for n in m.group(1).split(","))
    return {re.sub(r"\(D\)$", "", n) for n in names}


def count_ops(body: str) -> dict[str, int]:
    """Operations of one GIMPLE function body by the rule above, calls of
    other functions of the dump not included.  A loop (a branch back to an
    earlier block) raises: a static count would be short by its trips."""
    floats = float_names(body)

    def is_float(name):
        base = re.sub(r"\(D\)$", "", name)
        return (base in floats or re.fullmatch(r"_\d+", base) is None
                and re.fullmatch(r"-?[0-9.]+e?[-+]?[0-9]*", base) is not None
                and "." in base)

    if has_loop(body):
        raise RuntimeError("a loop in the optimised code")
    counts = dict(arith=0, calls=0, compares=0, selects=0)
    for line in body.splitlines():
        if (m := BINARY.match(line)) and is_float(m.group(1)):
            counts["arith"] += 1
            continue
        if CALLS_TWO.search(line):
            counts["calls"] += 2
            continue
        if CALLS_ONE.search(line):
            counts["calls"] += 1
            continue
        if MINMAX.search(line):
            lhs = line.split("=")[0].strip()
            counts["compares" if not is_float(lhs) else "selects"] += 1
            continue
        if (m := COMPARE.search(line)):
            operands = re.findall(r"(\S+) (?:<|<=|>|>=|==|!=) (\S+)", line)
            if operands and any(is_float(o.rstrip(")"))
                                for o in operands[0]):
                counts["compares"] += 1
            continue
        if (m := COND.match(line)) and is_float(m.group(1)):
            counts["selects"] += 1
            continue
        if (m := PHI.match(line)) and is_float(m.group(1)):
            counts["selects"] += 1
    return counts


def has_loop(body: str) -> bool:
    """Whether the control-flow graph of a GIMPLE body has a cycle: its
    blocks (``<bb N>``), each with the targets of its gotos and, where its
    last statement is no jump or return, the next block."""
    blocks = re.split(r"^\s*<bb (\d+)>[^\n]*\n", body, flags=re.M)
    ids = [int(b) for b in blocks[1::2]]
    succ = {}
    for i, (b, text) in enumerate(zip(ids, blocks[2::2])):
        out = [int(t) for t in re.findall(r"goto <bb (\d+)>", text)]
        last = [ln.strip() for ln in text.splitlines() if ln.strip()]
        ends = last and (last[-1].startswith(("goto", "return"))
                         or last[-1].startswith("else goto")
                         or "__builtin_unreachable" in last[-1])
        if not ends and i + 1 < len(ids):
            out.append(ids[i + 1])
        succ[b] = out
    state = {}

    def visit(b):
        state[b] = 1
        for t in succ.get(b, ()):
            if state.get(t) == 1 or (t not in state and visit(t)):
                return True
        state[b] = 2
        return False

    return bool(ids) and visit(ids[0])


def count_function(name: str, bodies: dict[str, str]) -> dict[str, int]:
    """``count_ops`` of the function ``name`` with, at each call site of
    another function of the dump, that function's count (recursively)."""
    counts = count_ops(bodies[name])
    for line in bodies[name].splitlines():
        for callee in bodies:
            if callee != name and f"{callee} (" in line:
                for k, v in count_function(callee, bodies).items():
                    if k != "total":
                        counts[k] += v
    counts["total"] = sum(v for k, v in counts.items() if k != "total")
    return counts


def count_instance(struct: str, work: Path) -> dict[str, dict[str, int]]:
    src = work / f"opcount_{struct}.cpp"
    src.write_text(SHIM)
    subprocess.run(["g++", *FLAGS, f"-DGRT_METRIC={struct}", "-I", str(CSRC),
                    "-c", str(src), "-o", str(work / f"{struct}.o"),
                    "-fdump-tree-optimized", f"-dumpbase", struct,
                    "-dumpdir", f"{work}/"],
                   check=True, capture_output=True, text=True, timeout=300)
    dumps = list(work.glob(f"{struct}*.optimized"))
    assert len(dumps) == 1, dumps
    bodies = function_bodies(dumps[0].read_text())
    return {k: count_function(f"grt_opcount_{k}", bodies)
            for k in ("metric", "accel")}


def main(argv: list[str]) -> None:
    table = instances()
    names = argv or sorted(table)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        print(f"{'instance':34s} {'metric':>7s} {'accel':>7s} "
              f"{'contraction':>11s}   metric: arith calls compares selects")
        for name in names:
            c = count_instance(table[name], work)
            m, a = c["metric"], c["accel"]
            print(f"{name:34s} {m['total']:7d} {a['total']:7d} "
                  f"{a['total'] - m['total']:11d}   {m['arith']} "
                  f"{m['calls']} {m['compares']} {m['selects']}")


if __name__ == "__main__":
    main(sys.argv[1:])
