"""Metric structs for the ray-march kernel, emitted from torch metrics.

The JAX reference has no counterpart file: JAX traces a metric, built-in or
from a content pack, into the Pallas kernel's body.  The CUDA kernel
(``csrc/raymarch.cu``) is a template over a metric struct, and every
metric's struct, registered or a content pack's, is written here from its
torch function, as a C++ header that the kernel's build includes
(``ops/raymarch.py``: ``-include <header> -DGRT_METRIC=<struct>``):
the metric function is the one source of the kernel's metric.

How.  The metric function is recorded as an aten graph by ``make_fx`` (fake
tensors: Python control flow on a coordinate's value raises), with
``metrics.base.sym_metric`` handing over its entry dict instead of
assembling the matrix: an absent entry is the structural zero, a Python
float entry a constant one, and an entry the metric's declared structure
(``Metric.nonzeros``) holds but the dict lacks is the constant 0 that the
plain march's ``sym_metric`` fills in.  Each entry is then written as a
chain of ``csrc/dual.cuh`` calls in the graph's order; the tangents come
from the ``Dual<MASK>`` types, whose rules are torch's forward-mode rules
op for op, so no jvp graph is emitted.  The functions with a custom
derivative record one node each (``geometry.arctan`` / ``arctan2``, and
``ops/complexify``'s ``cabs`` and ``csqrt`` of a pair, written as
``csrc/complex.cuh``'s dual-pair functions), as do those that read a
parameter on the host (``geometry.param_pow``: a ``PowRule`` member set in
``from_params``; ``complexify.cpow`` of parameters: complex.cuh's double
``cpow`` there), and ``sin`` and ``cos`` of one node share one
``grt_sincos``.  The chart's ``polar_r`` (``to_polar(x)[1]``) and, where
the config's origin is not ``at_origin``, ``origin_distance`` are emitted
the same way on constant duals.  A rank-1 metric (``Metric.rank1``, a
pack's ``RANK1``) is emitted from its decomposition instead: ``fl(x, y,
z)`` returns ``Rank1{f, l1, l2, l3}`` (``csrc/sym.cuh``) and the
march takes its rank-1 acceleration; l_0 must be the constant 1 and the
decomposition must depend on x, y and z.

A custom ``torch.autograd.Function`` of a pack is traced through its
forward, whose ops' rules are not its own ``jvp``: ``emit_metric`` holds
``torch.func.jvp`` of the recorded graph (what the struct computes) to
``torch.func.jvp`` of the function on seeded events of the chart and
raises ``NotImplementedError`` naming the entry where they part.

Op set: exactly what ``dual.cuh`` carries (``OPS``); any other aten op
raises ``NotImplementedError`` naming it.

Two modes, the reference's split between its dynamic program and ``bake``:

* dynamic (``params=None``): traced with the parameters as 0-d float32
  tensors.  They are members of the struct, set by ``from_params`` from the
  launch's parameters; a node of parameters alone is evaluated there once
  where its op is correctly rounded (``+ - * /``, sqrt, ...) and in ``g``
  otherwise (a transcendental, which the card evaluates with its own
  libm).  Its plain twin is the plain march with the parameters as 0-d
  float32 tensors on the rays' device (``tensor_params``).
* baked (``params`` given): traced with the parameters as Python floats,
  so Python folds their arithmetic in double, exactly as the eager march
  with float parameters does; the values meet the graph as literals.  Its
  plain twin is the plain march with those float parameters.

Literals are written in hex-float, so no bit moves.  A division by a Python
number is written as the card evaluates it, a product with the float32
reciprocal (torch's CUDA ``div`` of a CPU scalar; the CPU divides).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import operator
import re
import threading
from typing import Callable

import numpy as np
import torch

from ..metrics import base as mbase
from . import complexify, geometry

_lib = torch.library.Library("grt_emit", "DEF")
_lib.define("arctan(Tensor x) -> Tensor")
_lib.define("arctan2(Tensor y, Tensor x) -> Tensor")
_lib.impl("arctan", lambda x: geometry._arctan_poly(x),
          "CompositeExplicitAutograd")
_lib.impl("arctan2", lambda y, x: geometry._arctan2_poly(y, x),
          "CompositeExplicitAutograd")
_lib.impl("arctan", lambda x: torch.empty_like(x), "Meta")
_lib.impl("arctan2",
          lambda y, x: torch.empty(torch.broadcast_shapes(y.shape, x.shape),
                                   dtype=torch.result_type(y, x),
                                   device=y.device), "Meta")
# geometry.param_pow with a tensor exponent, complexify's cabs and csqrt of
# a pair (the pair's parts have one shape) and cpow of a pair of parameters.
_lib.define("param_pow(Tensor x, Tensor e) -> Tensor")
_lib.define("cabs(Tensor re, Tensor im) -> Tensor")
_lib.define("csqrt(Tensor re, Tensor im) -> (Tensor, Tensor)")
_lib.define("cpow(Tensor re, Tensor im, float c) -> (Tensor, Tensor)")
_lib.impl("param_pow", lambda x, e: x ** float(e), "CompositeExplicitAutograd")
_lib.impl("cabs", lambda re, im: complexify.cabs((re, im)),
          "CompositeExplicitAutograd")
_lib.impl("csqrt", lambda re, im: complexify.csqrt((re, im)),
          "CompositeExplicitAutograd")
_lib.impl("cpow", lambda re, im, c: complexify.cpow((re, im), c),
          "CompositeExplicitAutograd")
_lib.impl("param_pow", lambda x, e: torch.empty_like(x), "Meta")
_lib.impl("cabs", lambda re, im: torch.empty_like(re), "Meta")
_lib.impl("csqrt", lambda re, im: (torch.empty_like(re),
                                   torch.empty_like(re)), "Meta")
_lib.impl("cpow", lambda re, im, c: (torch.empty_like(re),
                                     torch.empty_like(re)), "Meta")

# The aten ops the emitter writes, by overload packet.
OPS = ("add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sin", "cos",
       "sqrt", "exp", "log", "log1p", "tanh", "pow", "abs", "where", "clamp",
       "clamp_min", "clamp_max", "gt", "lt", "ge", "le", "eq", "ne",
       "logical_and", "logical_or", "logical_not", "atan", "asin", "acos",
       "sinh", "cosh", "arctan", "arctan2", "param_pow", "cabs", "csqrt",
       "cpow")
# Shape and dtype bookkeeping that changes no value of an elementwise scalar.
_PASS = ("alias", "clone", "detach", "expand", "view", "_unsafe_view",
         "lift_fresh_copy", "squeeze", "unsqueeze", "_to_copy", "to",
         "expand_copy", "contiguous")
_FILL = ("zeros_like", "ones_like", "full_like", "scalar_tensor", "full",
         "zeros", "ones")
# Ops of parameters alone that from_params evaluates on the host: the
# correctly rounded ones (the card's result is the host's).
_EXACT = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt",
          "abs", "where", "clamp", "clamp_min", "clamp_max", "gt", "lt",
          "ge", "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
          "cabs"}
_UNARY_DUAL = {"reciprocal": "grt_recip", "sqrt": "grt_sqrt",
               "exp": "grt_exp", "log": "grt_log", "log1p": "grt_log1p",
               "tanh": "grt_tanh", "abs": "grt_abs", "arctan": "grt_arctan",
               "atan": "grt_atan", "asin": "grt_asin", "acos": "grt_acos",
               "sinh": "grt_sinh", "cosh": "grt_cosh"}
_UNARY_F32 = {"reciprocal": "1.0f / {}", "sqrt": "sqrtf({})",
              "exp": "expf({})", "log": "logf({})", "log1p": "log1pf({})",
              "tanh": "tanhf({})", "abs": "fabsf({})", "sin": "sinf({})",
              "cos": "cosf({})", "arctan": "grt_arctan({})",
              "atan": "atanf({})", "asin": "asinf({})", "acos": "acosf({})",
              "sinh": "sinhf({})", "cosh": "coshf({})"}
_UNARY_F64 = {"reciprocal": "1.0 / {}", "sqrt": "sqrt({})", "exp": "exp({})",
              "log": "log({})", "log1p": "log1p({})", "tanh": "tanh({})",
              "abs": "fabs({})", "sin": "sin({})", "cos": "cos({})",
              "atan": "atan({})", "asin": "asin({})", "acos": "acos({})",
              "sinh": "sinh({})", "cosh": "cosh({})"}
# Keyword arguments an op may carry (any other raises).
_KWARGS = {"add": {"alpha"}, "sub": {"alpha"}}
_CMP = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==", "ne": "!="}

_trace_lock = threading.Lock()


def lit(v: float, dtype=torch.float32) -> str:
    """A C++ literal of ``v`` rounded to ``dtype``, in hex-float."""
    if dtype == torch.float32:
        v = float(np.float32(v))
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return ("-" if v < 0 else "") + "INFINITY"
    return v.hex() + ("f" if dtype == torch.float32 else "")


def tensor_params(params, device) -> dict:
    """The parameters as 0-d float32 tensors on ``device``: how the plain
    march takes them to be the twin of an emitted dynamic instance."""
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class Header:
    """An emitted metric struct: its name in namespace ``grt``, the
    parameters in the order of ``from_params``, the C++ text, and the
    parameter values compiled in (baked) or None (dynamic)."""

    struct: str
    params: tuple
    text: str
    baked: tuple | None = None


class _Trace:
    """What the lower layers hand to a trace (``geometry.emitting()``):
    the entry dicts of ``metrics.base.sym_metric`` (``entries``, which is
    also what it returns), and one node for each ``geometry.arctan`` /
    ``arctan2`` / ``param_pow`` and ``complexify.cabs`` / ``csqrt`` /
    ``cpow`` of tensors."""

    def __init__(self):
        self.entries: list = []

    def sym_metric(self, entries):
        self.entries.append(entries)
        return self.entries

    @staticmethod
    def arctan(x):
        return torch.ops.grt_emit.arctan(x)

    @staticmethod
    def arctan2(y, x):
        y, x = (v if isinstance(v, torch.Tensor)
                else torch.full_like(x if isinstance(x, torch.Tensor) else y,
                                     float(v)) for v in (y, x))
        return torch.ops.grt_emit.arctan2(y, x)

    @staticmethod
    def param_pow(x, e):
        return torch.ops.grt_emit.param_pow(x, e)

    @staticmethod
    def cabs(re, im):
        return torch.ops.grt_emit.cabs(re, im)

    @staticmethod
    def csqrt(re, im):
        return tuple(torch.ops.grt_emit.csqrt(re, im))

    @staticmethod
    def cpow(re, im, c):
        return tuple(torch.ops.grt_emit.cpow(re, im, float(c)))


def _record(fn: Callable, n_params: int):
    """``make_fx`` of ``fn(x0, x1, x2, x3, *params)`` over (2,) float32
    coordinates and 0-d float32 parameters, in fake mode."""
    ex = [torch.zeros(2) + i for i in range(4)]
    ex += [torch.zeros(()) for _ in range(n_params)]
    from torch.fx.experimental.proxy_tensor import make_fx

    with _trace_lock:
        geometry.EMITTING.trace = _Trace()
        try:
            return make_fx(fn, tracing_mode="fake")(*ex)
        except NotImplementedError:
            raise
        except Exception as e:  # data-dependent Python, a failed op
            raise NotImplementedError(
                f"ops.emit: the function cannot be traced: "
                f"{type(e).__name__}: {e}") from e
        finally:
            geometry.EMITTING.trace = None


def _trace_entries(metric: mbase.Metric, param_names, baked):
    """The graph of the metric function whose outputs are the tensor
    entries of its ``sym_metric`` dict, and the dict's keys with either the
    output index of a tensor entry or a Python float."""
    layout: list = []

    def fn(x0, x1, x2, x3, *p):
        params = dict(baked) if baked is not None else dict(
            zip(param_names, p))
        trace = geometry.emitting()
        trace.entries = captured = []
        out = metric.fn(torch.stack([x0, x1, x2, x3]), params)
        if len(captured) != 1 or out is not captured:
            raise NotImplementedError(
                f"ops.emit: {metric.name}'s function does not return the "
                "result of one sym_metric / diag_metric call (only such a "
                "metric is emitted)")
        tensors = []
        layout.clear()
        for key, v in captured[0].items():
            if isinstance(v, torch.Tensor):
                layout.append((tuple(key), len(tensors)))
                tensors.append(v)
            else:
                layout.append((tuple(key), float(v)))
        return tuple(tensors)

    gm = _record(fn, 0 if baked is not None else len(param_names))
    return gm, layout


def _trace_rank1(metric: mbase.Metric, param_names, baked):
    """The graph of the metric's rank-1 decomposition whose outputs are f,
    l0, l1, l2 and l3, and their names."""
    def fn(x0, x1, x2, x3, *p):
        params = dict(baked) if baked is not None else dict(
            zip(param_names, p))
        f, lv = metric.rank1(torch.stack([x0, x1, x2, x3]), params)
        return (f, *(lv[i] for i in range(4)))

    gm = _record(fn, 0 if baked is not None else len(param_names))
    return gm, ["f", "l0", "l1", "l2", "l3"]


def _coordinates_reaching(gm, outputs) -> set:
    """The coordinates (placeholders 0-3) that the graph outputs of the
    indices ``outputs`` depend on: an element of a stack depends on what
    that element does."""
    deps: dict = {}

    def of(a):
        d = deps.get(a, set()) if isinstance(a, torch.fx.Node) else set()
        return set().union(*d) if isinstance(d, list) else d

    places = 0
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            deps[n] = {places} if places < 4 else set()
            places += 1
        elif n.op == "call_function":
            op = _packet(n)
            src = deps.get(n.args[0]) if n.args else None
            if op == "stack":
                deps[n] = [of(a) for a in n.args[0]]
            elif op == "select" and isinstance(src, list) \
                    and n.args[1] == 0:
                deps[n] = src[n.args[2]]
            elif n.target is operator.getitem and isinstance(src, list):
                deps[n] = src[n.args[1]]
            elif op == "unbind" and isinstance(src, list):
                deps[n] = src
            else:
                deps[n] = set().union(*(of(a) for a in n.all_input_nodes))
    out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    return set().union(*(of(out[i]) for i in outputs))


def _replay(gm):
    """The recorded graph with each op of ``grt_emit`` replaced by the
    function it stands for, whose derivative is the rule the struct
    applies (what ``torch.func.jvp`` of the graph then computes is the
    struct's tangent)."""
    ops = torch.ops.grt_emit
    table = {ops.arctan.default: geometry.arctan,
             ops.arctan2.default: geometry.arctan2,
             ops.param_pow.default: geometry.param_pow,
             ops.cabs.default: lambda re, im: complexify.cabs((re, im)),
             ops.csqrt.default: lambda re, im: complexify.csqrt((re, im)),
             ops.cpow.default: lambda re, im, c: complexify.cpow((re, im),
                                                                 c)}
    graph = torch.fx.Graph()
    graph.output(graph.graph_copy(gm.graph, {}))
    for n in graph.nodes:
        if n.op == "call_function" and n.target in table:
            n.target = table[n.target]
    return torch.fx.GraphModule(gm, graph)


# The tangent check: seeded events of the chart (polar t, r, theta, phi
# mapped by the metric's from_polar), in pairs (the graphs are recorded on
# (2,) coordinates), and the tolerance between the two tangents.
CHECK_EVENTS = 6
CHECK_RTOL = 1e-3


def check_tangents(metric: mbase.Metric, gm, layout, param_names,
                   baked) -> None:
    """Raise NotImplementedError where ``torch.func.jvp`` of the recorded
    graph ``gm`` (the struct's tangents, its custom ops' rules being their
    functions') and of the metric function part by more than rounding, on
    the ``CHECK_EVENTS`` seeded events with the default (or baked)
    parameters, by each coordinate the metric is differentiated by,
    where both are finite.  ``layout``: the graph's outputs as
    ``_trace_entries`` or ``_trace_rank1`` give them."""
    rank1 = metric.rank1 is not None
    fparams = dict(baked) if baked is not None else metric.params()
    tparams = (fparams if baked is not None
               else tensor_params(fparams, "cpu"))
    pvals = [] if baked is not None else [tparams[k] for k in param_names]
    rng = np.random.default_rng(0)
    n = CHECK_EVENTS
    polar = torch.from_numpy(np.stack([
        rng.uniform(-2.0, -0.5, n), rng.uniform(3.0, 12.0, n),
        rng.uniform(0.4, 2.7, n), rng.uniform(-3.0, 3.0, n)]
    ).astype(np.float32))
    with torch.no_grad():
        events = metric.from_polar(polar, fparams).float()
    if rank1:
        names = list(layout)

        def ref(x):
            f, lv = metric.rank1(x, tparams)
            return (f, *(lv[i] for i in range(4)))
    else:
        tensor_keys = [key for key, w in layout if not isinstance(w, float)]
        names = [f"g{key}" for key in tensor_keys]

        def ref(x):
            g = metric.fn(x, tparams)
            return tuple(g[i, j] for i, j in tensor_keys)

    replay = _replay(gm)
    deps = (1, 2, 3) if rank1 else tuple(metric.depends_on)
    got = {k: ([], []) for k in deps}
    for c in range(0, n - 1, 2):
        xs = tuple(events[i, c:c + 2].contiguous() for i in range(4))
        for k in deps:
            seed = tuple(torch.ones(2) if i == k else torch.zeros(2)
                         for i in range(4))
            try:
                _, t_graph = torch.func.jvp(lambda *x: replay(*x, *pvals),
                                            xs, seed)
                _, t_fn = torch.func.jvp(lambda *x: ref(torch.stack(x)),
                                         xs, seed)
            except Exception as e:
                raise NotImplementedError(
                    f"ops.emit: {metric.name}: torch.func.jvp of its "
                    f"function failed: {type(e).__name__}: {e}") from e
            for side, ts in zip(got[k], (t_graph, t_fn)):
                side.append(torch.stack([torch.broadcast_to(t.float(), (2,))
                                         for t in ts]))
    for k, (a, b) in got.items():
        a, b = torch.cat(a, 1), torch.cat(b, 1)
        fin = torch.isfinite(a) & torch.isfinite(b)
        a, b = torch.where(fin, a, 0.0), torch.where(fin, b, 0.0)
        scale = torch.maximum(a.abs(), b.abs())
        floor = scale.amax(1, keepdim=True) * 1e-6
        bad = (a - b).abs() > CHECK_RTOL * scale + floor
        if bad.any():
            o, e = (int(v) for v in bad.nonzero()[0])
            raise NotImplementedError(
                f"ops.emit: {metric.name}: the tangent of its entry "
                f"{names[o]} by x{k} on its recorded ops ({float(a[o, e])!r}"
                f") is not its function's ({float(b[o, e])!r}): a custom "
                "torch.autograd.Function with its own jvp is traced through "
                "its forward, and the struct would differentiate that "
                "(write the function of ops it records)")


class _Emitter:
    """Writes the nodes of one graph as C++ statements."""

    def __init__(self, gm, dynamic: bool, hoist: bool, prefix: str):
        self.gm = gm
        self.dynamic = dynamic
        self.hoist = hoist  # parameter-only nodes to from_params
        self.prefix = prefix
        # node -> (kind, C++ expression or elements, is a member): kind
        # "dual", "f32", "f64", "bool", "vec" (a stack), "tuple", "pyc" (a
        # constant known in Python).
        self.vals: dict = {}
        self.body: list = []
        self.members: list = []  # (c type, name)
        self.init: list = []  # from_params statements
        self.rules: dict = {}  # exponent node -> its PowRule member
        self.placeholders = [n for n in gm.graph.nodes
                             if n.op == "placeholder"]

    # -- operands ---------------------------------------------------------
    def kind(self, a):
        if isinstance(a, torch.fx.Node):
            return self.vals[a][0]
        if isinstance(a, bool):
            return "pybool"
        if isinstance(a, (int, float)):
            return "py"
        raise NotImplementedError(f"ops.emit: an operand {a!r} of type "
                                  f"{type(a).__name__}")

    def scalar(self, a, dtype) -> str:
        """Operand ``a`` as a float (or double) expression."""
        k = self.kind(a)
        if k == "py":
            return lit(float(a), dtype)
        if k == "pybool":
            return "true" if a else "false"
        expr = self.vals[a][1]
        want = "f32" if dtype == torch.float32 else "f64"
        if k == want:
            return expr
        if k in ("f32", "f64"):
            return (f"static_cast<float>({expr})" if want == "f32"
                    else f"static_cast<double>({expr})")
        raise NotImplementedError(f"ops.emit: a {k} operand where a scalar "
                                  "is needed")

    def operand(self, a, dtype=torch.float32) -> str:
        """A dual's expression, or a scalar one."""
        if isinstance(a, torch.fx.Node) and self.vals[a][0] == "dual":
            return self.vals[a][1]
        return self.scalar(a, dtype)

    # -- statements -------------------------------------------------------
    def bind(self, node, kind, expr, *, param_only=False, exact=True):
        """Give ``node`` the value ``expr``: a member set in from_params
        (a parameter-only, correctly rounded op of the dynamic mode), or a
        local of the function body."""
        name = f"{self.prefix}{len(self.vals)}"
        ctype = {"dual": "const auto", "f32": "const float",
                 "f64": "const double", "bool": "const bool"}[kind]
        # A double expression of parameters goes to from_params whatever
        # its op: it is evaluated there once, on the host's libm, as Python
        # evaluates it.
        if param_only and (exact or kind == "f64") and self.hoist \
                and kind != "dual":
            mtype = {"f32": "float", "f64": "double", "bool": "bool"}[kind]
            self.members.append((mtype, name))
            self.init.append(f"[[maybe_unused]] const {mtype} {name} = "
                             f"m.{name} = {expr};")
            self.vals[node] = (kind, f"{name}", True)
        else:
            self.body.append(f"{ctype} {name} = {expr};")
            self.vals[node] = (kind, name, False)

    def run(self, inputs: dict):
        """Emit every node that reaches an output.  ``inputs``: placeholder
        index -> (kind, expr, member)."""
        graph = self.gm.graph
        live = set()
        out = next(n for n in graph.nodes if n.op == "output")
        stack = [out]
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            src = n.args[0] if n.op == "call_function" and n.args else None
            if _packet(n) == "select" and isinstance(src, torch.fx.Node) \
                    and _packet(src) == "stack" and n.args[1] == 0:
                # An element of a stack needs that element alone.
                live.add(src)
                elem = src.args[0][n.args[2]]
                stack.extend([elem] if isinstance(elem, torch.fx.Node)
                             else [])
                continue
            stack.extend(n.all_input_nodes)
        sincos = {}
        for n in graph.nodes:
            if n in live and n.op == "call_function" and _packet(n) in (
                    "sin", "cos"):
                sincos.setdefault(n.args[0], {})[_packet(n)] = n
        for i, n in enumerate(self.placeholders):
            self.vals[n] = inputs[i]
        for n in graph.nodes:
            if n not in live or n.op in ("placeholder", "output"):
                continue
            if n.op == "get_attr":
                t = getattr(self.gm, n.target)
                if t.numel() != 1:
                    raise NotImplementedError(
                        f"ops.emit: a constant tensor of shape "
                        f"{tuple(t.shape)}")
                self.vals[n] = ("pyc", float(t.reshape(())), False)
                continue
            if n.op != "call_function":
                raise NotImplementedError(f"ops.emit: a graph node {n.op}")
            self.node(n, sincos)
        return out.args[0]

    def node(self, n, sincos):
        op = _packet(n)
        args = [self._const(a) for a in n.args]
        val = n.meta.get("val")
        dtype = val.dtype if isinstance(val, torch.Tensor) else None
        if op == "stack":
            self.vals[n] = ("vec", list(args[0]), False)
            return
        if op == "select":
            vec = self.vals[args[0]]
            if vec[0] != "vec" or args[1] != 0:
                raise NotImplementedError("ops.emit: aten.select of anything "
                                          "but a stack of scalars")
            self.vals[n] = self._element(vec[1][args[2]])
            return
        if op == "unbind":
            self.vals[n] = ("tuple", self.vals[args[0]][1], False)
            return
        if n.target is operator.getitem:
            self.vals[n] = self._element(self.vals[args[0]][1][args[1]])
            return
        ins = [a for a in _flat(args) if isinstance(a, torch.fx.Node)]
        has_dual = any(self.vals[a][0] == "dual" for a in ins
                       if self.vals[a][0] != "vec")
        param_only = (self.dynamic and not has_dual and bool(ins)
                      and all(self.vals[a][0] in ("f32", "f64", "bool")
                              and self.vals[a][2] for a in ins))
        if op in _PASS:
            src = self.vals[args[0]]
            if dtype is not None and src[0] == "dual" \
                    and dtype != torch.float32:
                raise NotImplementedError(
                    f"ops.emit: a coordinate expression cast to {dtype}")
            if dtype in (torch.float32, torch.float64) and src[0] in (
                    "f32", "f64"):
                want = "f32" if dtype == torch.float32 else "f64"
                if want != src[0]:
                    self.bind(n, want, self.scalar(args[0], dtype),
                              param_only=param_only)
                    return
            self.vals[n] = src
            return
        if op in _FILL:
            v = {"zeros_like": 0.0, "ones_like": 1.0, "zeros": 0.0,
                 "ones": 1.0}.get(op)
            if v is None:
                v = float(args[1] if op in ("full_like", "full") else args[0])
            self.vals[n] = ("pyc", v, False)
            return
        if op not in OPS:
            raise NotImplementedError(
                f"ops.emit: aten.{op} is not in the emitted op set "
                f"(csrc/dual.cuh: {', '.join(OPS)})")
        extra = set(n.kwargs) - _KWARGS.get(op, set())
        if extra:
            raise NotImplementedError(
                f"ops.emit: aten.{op} with {', '.join(sorted(extra))}=")
        if "alpha" in n.kwargs:
            args = args[:2] + [n.kwargs["alpha"]]
        if op in ("csqrt", "cpow"):
            self._pair(n, op, args, val[0].dtype, has_dual, param_only)
            return
        if dtype not in (torch.float32, torch.float64, torch.bool):
            raise NotImplementedError(f"ops.emit: aten.{op} of {dtype}")
        if has_dual and dtype == torch.float64:
            raise NotImplementedError(
                f"ops.emit: aten.{op}: a coordinate expression in float64")
        exact = op in _EXACT
        if op in _CMP or op.startswith("logical_"):
            self.bind(n, "bool", self._bool(op, args), param_only=param_only)
            return
        kind = "dual" if has_dual else ("f64" if dtype == torch.float64
                                        else "f32")
        expr = (self._dual(n, op, args, sincos) if kind == "dual"
                else self._scalar_op(op, args, dtype))
        self.bind(n, kind, expr, param_only=param_only, exact=exact)

    def _pair(self, n, op, args, dtype, has_dual, param_only):
        """complexify's csqrt of a pair (of coordinates: complex.cuh's dual
        csqrt; of parameters: its double one, in from_params) or cpow of a
        pair of parameters (complex.cuh's double cpow, in from_params)."""
        name = f"{self.prefix}{len(self.vals)}"
        if has_dual or dtype == torch.float32:
            if op == "cpow":
                raise NotImplementedError(
                    "ops.emit: complexify.cpow of a coordinate expression or "
                    "of float32 parameters (a pair of parameters in double "
                    "is emitted)")
            re, im = (f"as_dual({self.operand(a)})" for a in args[:2])
            self.body.append(f"const auto {name} = csqrt_dual({re}, {im});")
            v = "" if has_dual else ".v"
            kind = "dual" if has_dual else "f32"
            self.vals[n] = ("tuple", [(kind, f"{name}.re{v}", False),
                                      (kind, f"{name}.im{v}", False)], False)
            return
        re, im = (self.scalar(a, torch.float64) for a in args[:2])
        expr = (f"csqrt_double({re}, {im})" if op == "csqrt" else
                f"cpow(Cx<double, double>{{{re}, {im}}}, "
                f"{lit(float(args[2]), torch.float64)})")
        if param_only and self.hoist:
            self.init.append(f"const auto {name} = {expr};")
            for part in ("re", "im"):
                self.members.append(("double", f"{name}_{part}"))
                self.init.append(f"[[maybe_unused]] const double {name}_"
                                 f"{part} = m.{name}_{part} = {name}.{part};")
            self.vals[n] = ("tuple", [("f64", f"{name}_re", True),
                                      ("f64", f"{name}_im", True)], True)
            return
        self.body.append(f"const auto {name} = {expr};")
        self.vals[n] = ("tuple", [("f64", f"{name}.re", False),
                                  ("f64", f"{name}.im", False)], False)

    def _rule(self, e) -> str:
        """The ``PowRule`` of a parameter exponent ``e``: a member set in
        from_params where ``e`` is one, else an expression."""
        if self.kind(e) == "dual":
            raise NotImplementedError(
                "ops.emit: geometry.param_pow with an exponent of "
                "coordinates (torch.pow of two tensors is emitted)")
        expr = f"pow_rule({self.scalar(e, torch.float64)})"
        if not (isinstance(e, torch.fx.Node) and self.vals[e][2]):
            return expr
        if e not in self.rules:
            self.rules[e] = name = f"{self.prefix}r{len(self.rules)}"
            self.members.append(("PowRule", name))
            self.init.append(f"m.{name} = {expr};")
        return self.rules[e]

    def _element(self, e):
        if isinstance(e, tuple):  # (kind, expression, member) of a pair op
            return e
        if isinstance(e, torch.fx.Node):
            return self.vals[e]
        return ("pyc", float(e), False)

    def _const(self, a):
        if isinstance(a, torch.fx.Node) and self.vals.get(a, (None,))[0] \
                == "pyc":
            return self.vals[a][1]
        if isinstance(a, (list, tuple)):
            return type(a)(self._const(x) if not isinstance(x, torch.fx.Node)
                           or self.vals.get(x, (None,))[0] == "pyc" else x
                           for x in a)
        return a

    def _bool(self, op, args):
        if op == "logical_not":
            return f"!({self._truth(args[0])})"
        if op in ("logical_and", "logical_or"):
            j = " && " if op == "logical_and" else " || "
            return f"({self._truth(args[0])}){j}({self._truth(args[1])})"
        dt = _compute_dtype(self, args[:2])
        a, b = (f"value({self.operand(x, dt)})" for x in args[:2])
        return f"{a} {_CMP[op]} {b}"

    def _truth(self, a):
        if isinstance(a, torch.fx.Node) and self.vals[a][0] == "bool":
            return self.vals[a][1]
        raise NotImplementedError("ops.emit: a logical op of a non-boolean")

    def _scalar_op(self, op, args, dtype):
        s = lambda a: self.scalar(a, dtype)  # noqa: E731
        f32 = dtype == torch.float32
        if op in ("add", "sub"):
            c = _alpha(op, args)
            if c != 1.0:  # torch's kernel fuses a + c * b
                fma = "fmaf" if f32 else "fma"
                c = -c if op == "sub" else c
                return f"{fma}({lit(c, dtype)}, {s(args[1])}, {s(args[0])})"
            return f"{s(args[0])} {'+' if op == 'add' else '-'} {s(args[1])}"
        if op == "rsub":
            _alpha(op, args)
            return f"{s(args[1])} - {s(args[0])}"
        if op == "mul":
            return f"{s(args[0])} * {s(args[1])}"
        if op == "div":
            if self.kind(args[1]) == "py":
                return f"{s(args[0])} * {_inv(args[1], dtype)}"
            return f"{s(args[0])} / {s(args[1])}"
        if op == "neg":
            return f"-{s(args[0])}"
        if op == "where":
            return f"{self._truth(args[0])} ? {s(args[1])} : {s(args[2])}"
        if op in ("clamp", "clamp_min", "clamp_max"):
            lo, hi = _bounds(op, args)
            e = s(args[0])
            if lo is not None:
                b = s(lo)
                e = f"({e} < {b} ? {b} : {e})"
            if hi is not None:
                b = s(hi)
                e = f"({e} > {b} ? {b} : {e})"
            return e
        if op == "cabs":
            if f32:
                return f"sqrtf({s(args[0])} * {s(args[0])} + " \
                       f"{s(args[1])} * {s(args[1])})"
            return f"cabs(Cx<double, double>{{{s(args[0])}, {s(args[1])}}})"
        if op == "param_pow":
            if not f32:
                raise NotImplementedError("ops.emit: a float64 param_pow")
            return f"torch_pow({s(args[0])}, {self._rule(args[1])}.value)"
        if op == "pow" and isinstance(args[1], torch.fx.Node):
            if not f32:
                raise NotImplementedError(
                    "ops.emit: a float64 pow with a tensor exponent")
            return f"powf({s(args[0])}, {s(args[1])})"
        if op == "pow":
            e = _exponent(args)
            if f32:
                return (f"torch_pow({s(args[0])}, "
                        f"torch_pow_plan({lit(e, torch.float64)}))")
            if e == 2.0:
                return f"{s(args[0])} * {s(args[0])}"
            if e == 0.5:
                return f"sqrt({s(args[0])})"
            raise NotImplementedError(f"ops.emit: a float64 pow by {e}")
        if op == "arctan2":
            if not f32:
                raise NotImplementedError("ops.emit: a float64 arctan2")
            return f"grt_arctan2({s(args[0])}, {s(args[1])})"
        table = _UNARY_F32 if f32 else _UNARY_F64
        if op in table:
            return table[op].format(s(args[0]))
        raise NotImplementedError(f"ops.emit: aten.{op} of parameters")

    def _dual(self, n, op, args, sincos):
        o = lambda a: self.operand(a)  # noqa: E731
        d = lambda a: f"as_dual({o(a)})"  # noqa: E731
        if op in ("add", "sub"):
            c = _alpha(op, args)
            if c != 1.0:
                return f"grt_{op}_alpha({d(args[0])}, {d(args[1])}, {lit(c)})"
            return f"{o(args[0])} {'+' if op == 'add' else '-'} {o(args[1])}"
        if op == "rsub":
            _alpha(op, args)
            return f"{o(args[1])} - {o(args[0])}"
        if op == "mul":
            return f"{o(args[0])} * {o(args[1])}"
        if op == "div":
            if self.kind(args[1]) == "py":
                return f"{o(args[0])} * {_inv(args[1], torch.float32)}"
            return f"grt_div({o(args[0])}, {o(args[1])})"
        if op == "neg":
            return f"-{o(args[0])}"
        if op in ("sin", "cos"):
            pair = sincos.get(n.args[0], {})
            if len(pair) == 2:
                key = ("sincos", n.args[0])
                if key not in self.vals:
                    s_name = f"{self.prefix}s{len(self.vals)}"
                    c_name = f"{self.prefix}c{len(self.vals)}"
                    x = o(args[0])
                    self.body.append(f"std::decay_t<decltype({x})> {s_name}, "
                                     f"{c_name};")
                    self.body.append(f"grt_sincos({x}, {s_name}, {c_name});")
                    self.vals[key] = (s_name, c_name)
                return self.vals[key][0 if op == "sin" else 1]
            return f"grt_{op}({o(args[0])})"
        if op in _UNARY_DUAL:
            return f"{_UNARY_DUAL[op]}({o(args[0])})"
        if op == "pow" and isinstance(args[1], torch.fx.Node):
            return f"grt_pow_tensor({d(args[0])}, {d(args[1])})"
        if op == "pow":
            return (f"grt_pow({o(args[0])}, "
                    f"pow_rule({lit(_exponent(args), torch.float64)}))")
        if op == "param_pow":
            return f"grt_pow({o(args[0])}, {self._rule(args[1])})"
        if op == "cabs":
            return f"cabs_dual({d(args[0])}, {d(args[1])})"
        if op == "where":
            c = self._truth(args[0])
            a, b = o(args[1]), o(args[2])
            if not any(self.kind(x) == "dual" for x in args[1:3]):
                return f"{c} ? {a} : {b}"
            return f"grt_where({c}, {a}, {b})"
        if op in ("clamp", "clamp_min", "clamp_max") \
                and n.target._overloadname == "Tensor":
            lo, hi = _bounds(op, args)
            x = d(args[0])
            if op != "clamp":  # clamp_min / clamp_max: >= and <=
                return f"grt_{op}_tensor({x}, {d(lo if hi is None else hi)})"
            if lo is not None and hi is not None:
                return f"grt_clamp_tensor({x}, {d(lo)}, {d(hi)})"
            if lo is not None:
                return f"grt_clamp_tensor_min({x}, {d(lo)})"
            return f"grt_clamp_tensor_max({x}, {d(hi)})"
        if op in ("clamp", "clamp_min", "clamp_max"):
            lo, hi = _bounds(op, args)
            x = o(args[0])
            lo, hi = (None if b is None else float(b) for b in (lo, hi))
            if lo is not None and hi is not None:
                return f"grt_clamp({x}, {lit(lo)}, {lit(hi)})"
            if lo is not None:
                return f"grt_clamp_min({x}, {lit(lo)})"
            return f"grt_clamp_max({x}, {lit(hi)})"
        if op == "arctan2":
            y, x = (o(a) if self.kind(a) == "dual"
                    else f"dual_constant({self.scalar(a, torch.float32)})"
                    for a in args[:2])
            return f"grt_arctan2({y}, {x})"
        raise NotImplementedError(f"ops.emit: aten.{op} of a coordinate "
                                  "expression")


def _packet(n) -> str:
    t = n.target
    if hasattr(t, "_overloadpacket"):
        name = t._overloadpacket.__name__
        return name
    return getattr(t, "__name__", str(t))


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        else:
            yield a


def _alpha(op, args) -> float:
    """The ``alpha`` of aten.add / sub (1 where there is none)."""
    c = args[2] if len(args) > 2 else 1
    if isinstance(c, torch.fx.Node) or (op == "rsub" and c != 1):
        raise NotImplementedError(f"ops.emit: aten.{op} with alpha {c}")
    return float(c)


def _inv(c, dtype) -> str:
    """The reciprocal of a Python-number divisor as the card's div takes
    it: 1 / c in the tensor's type."""
    if dtype == torch.float32:
        return lit(float(np.float32(1.0) / np.float32(c)))
    return lit(1.0 / float(c), torch.float64)


def _bounds(op, args):
    if op == "clamp_min":
        return args[1], None
    if op == "clamp_max":
        return None, args[1]
    lo = args[1] if len(args) > 1 else None
    hi = args[2] if len(args) > 2 else None
    return lo, hi


def _exponent(args) -> float:
    if not isinstance(args[1], (int, float)):
        raise NotImplementedError("ops.emit: aten.pow with a tensor exponent "
                                  "(a Python number is emitted)")
    return float(args[1])


def _compute_dtype(em: _Emitter, args):
    """The type torch computes a binary op of these operands in (a 0-d
    tensor does not promote an (N,) one)."""
    vals = []
    for a in args:
        if isinstance(a, torch.fx.Node):
            v = a.meta["val"]
            vals.append(torch.zeros(tuple(v.shape), dtype=v.dtype))
        else:
            vals.append(a)
    return torch.result_type(*vals)


def _ident(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z]+", "_", name).strip("_") or "metric"


def _struct_facts(metric: mbase.Metric, deps) -> list:
    cfg = metric.config
    w = metric.precision_weights()
    dep = " : ".join(f"k == {k} ? {d}" for k, d in enumerate(deps[:-1]))
    dep = (f"{dep} : {deps[-1]}" if dep else f"{deps[-1]}") if deps else "-1"
    weight = "i == 0 ? {} : i == 1 ? {} : i == 2 ? {} : {}".format(
        *(lit(v) for v in w))
    b = lambda v: "true" if v else "false"  # noqa: E731
    return [
        f"static constexpr bool adaptive_precision = "
        f"{b(cfg.adaptive_precision)};",
        f"static constexpr bool detect_singularities = "
        f"{b(cfg.detect_singularities)};",
        f"static constexpr bool singular = {b(cfg.singular)};",
        f"static constexpr float singular_terminator = "
        f"{lit(cfg.singular_terminator)};",
        f"static constexpr bool has_cylindrical_singularity = "
        f"{b(cfg.has_cylindrical_singularity)};",
        f"static constexpr float cylindrical_terminator = "
        f"{lit(cfg.cylindrical_terminator)};",
        f"static constexpr bool unconditionally_nonsingular = "
        f"{b(cfg.unconditionally_nonsingular)};",
        f"static constexpr int n_deps = {len(deps)};",
        f"GRT_HD static constexpr int dep([[maybe_unused]] int k) "
        f"{{ return {dep}; }}",
        f"GRT_HD static constexpr float weight(int i) {{ return {weight}; }}",
        f"static constexpr double udiv = {lit(float(max(w)), torch.float64)};",
    ]


def _scalar_fn(metric, param_names, baked, which: str):
    """The graph of the chart's polar r (``which == "polar_r"``) or of the
    config's origin distance, on (2,) coordinates."""
    def fn(x0, x1, x2, x3, *p):
        params = dict(baked) if baked is not None else dict(
            zip(param_names, p))
        x = torch.stack([x0, x1, x2, x3])
        polar = metric.to_polar(x, params)
        if which == "polar_r":
            return polar[1]
        return metric.origin_distance(polar, params)

    return _record(fn, 0 if baked is not None else len(param_names))


def _function(gm, dynamic, n_params, pnames, prefix):
    """The body of a float function of ``const float x[4]``: polar_r or
    origin_distance."""
    em = _Emitter(gm, dynamic, hoist=False, prefix=prefix)
    inputs = {i: ("dual", f"dual_constant(x[{i}])", False) for i in range(4)}
    for j in range(n_params if dynamic else 0):
        inputs[4 + j] = ("f32", pnames[j], True)
    out = em.run(inputs)
    k = em.vals[out][0] if isinstance(out, torch.fx.Node) else "py"
    if k == "dual":
        ret = f"value({em.vals[out][1]})"
    elif k == "pyc":
        ret = lit(em.vals[out][1])
    else:
        ret = em.scalar(out, torch.float32)
    return em.body, ret


def _rank1_return(metric, em, outs) -> str:
    """``fl``'s return statement: f, l1, l2, l3 as duals (l0 must be the
    constant 1)."""
    l0 = em.vals[outs[1]] if isinstance(outs[1], torch.fx.Node) else None
    if l0 is None or l0[0] != "pyc" or l0[1] != 1.0:
        raise NotImplementedError(
            f"ops.emit: {metric.name}'s rank-1 decomposition: l_0 is not "
            "the constant 1 (the rank-1 acceleration takes l = (1, l1, l2, "
            "l3))")
    parts = []
    for node in (outs[0], *outs[2:]):
        kind = em.vals[node][0] if isinstance(node, torch.fx.Node) else "py"
        if kind == "dual":
            parts.append(em.vals[node][1])
        elif kind == "pyc":
            parts.append(f"dual_constant({lit(em.vals[node][1])})")
        else:
            parts.append(f"dual_constant({em.scalar(node, torch.float32)})")
    types = ", ".join(f"std::decay_t<decltype({p})>" for p in parts)
    return f"Rank1<{types}>{{{', '.join(parts)}}}"


# The struct a header holds gives the march (csrc/march.cuh) and the
# render-data and observer kernels its compile-time facts and its metric
# function:
#   name, n_params, from_params(const float*)   identity and parameters (a
#                        baked struct has its values as literals instead)
#   adaptive_precision, detect_singularities, singular,
#   singular_terminator, has_cylindrical_singularity,
#   cylindrical_terminator, unconditionally_nonsingular   the MetricConfig
#   weight(i), udiv      precision weights of the chart and their maximum
#   n_deps, dep(k)       the coordinates g depends on; dep(k) seeds tangent k
#   polar_r(x)           polar[1] of the chart's to_polar (the escape
#                        radius, and the at_origin distance)
#   origin_distance(x)   only where the config's origin_distance is not
#                        at_origin (the step schedule's distance)
#   g(x0, x1, x2, x3)    the metric as a Sym of typed entries (sym.cuh); each
#                        coordinate is a dual that carries the tangent it
#                        seeds, or none (up to kTangents = 4 of them)
#   fl(x1, x2, x3)       instead of g, for a rank-1 metric g = eta + f l l:
#                        Rank1{f, l1, l2, l3} (sym.cuh), which the march's
#                        rank-1 acceleration takes
def emit_metric(metric: mbase.Metric, params=None) -> Header:
    """The metric struct of ``metric`` as a C++ header: dynamic when
    ``params`` is None, else baked with these parameter values."""
    names = tuple(metric.defaults)
    baked = None
    if params is not None:
        baked = {k: float(np.float32(params[k])) for k in names}
    dynamic = baked is None
    rank1 = metric.rank1 is not None
    if rank1:
        gm, layout = _trace_rank1(metric, names, baked)
        used = _coordinates_reaching(gm, range(5))
        if used != {1, 2, 3}:
            raise NotImplementedError(
                f"ops.emit: {metric.name}'s rank-1 decomposition depends on "
                f"the coordinates {sorted(used)}, not on exactly x, y and z "
                "(1, 2, 3): the rank-1 acceleration takes its partials by "
                "x, y and z")
    else:
        gm, layout = _trace_entries(metric, names, baked)
    check_tangents(metric, gm, layout, names, baked)
    em = _Emitter(gm, dynamic, hoist=True, prefix="n")
    pnames = [f"p{i}" for i in range(len(names))]
    inputs = {i: ("dual", f"c{i}", False) for i in range(4)}
    for j, pn in enumerate(pnames if dynamic else ()):
        inputs[4 + j] = ("f32", pn, True)
    outs = em.run(inputs)
    if rank1:
        ret = _rank1_return(metric, em, outs)
        deps = (1, 2, 3)
    else:
        ret = _sym_return(metric, em, outs, layout)
        deps = tuple(metric.depends_on)
    polar_body, polar_ret = _function(
        _scalar_fn(metric, names, baked, "polar_r"), dynamic, len(names),
        pnames, "r")
    origin = None
    if metric.config.origin_distance not in ("", "at_origin"):
        origin = _function(_scalar_fn(metric, names, baked, "origin"),
                           dynamic, len(names), pnames, "o")

    # The struct's name ends in a hash of its whole text (the config's
    # facts, the baked values and the functions), filled in at the end.
    struct = f"Emitted_{_ident(metric.name)}_@TAG@"

    def ind(lines, k):
        return [" " * k + ln for ln in lines]

    members = [f"float {pn};" for pn in (pnames if dynamic else ())]
    members += [f"{t} {nm};" for t, nm in em.members]
    init = [f"[[maybe_unused]] const float {pn} = m.{pn} = p[{i}];"
            for i, pn in enumerate(pnames)] if dynamic else []
    init += em.init
    pdoc = ", ".join(names) or "none"
    text = [
        f"// {metric.name}: emitted by geodesic_raytracing_tpu_torch/ops/"
        f"emit.py ({'dynamic' if dynamic else 'baked'}), parameters: "
        f"{pdoc}" + ("" if dynamic else " = " + ", ".join(
            f"{v!r}" for v in baked.values())) + ".",
        "#pragma once",
        "",
        "#include <type_traits>",
        "",
        '#include "complex.cuh"',
        '#include "sym.cuh"',
        "",
        "namespace grt {",
        "",
        f"struct {struct} {{",
        f'  static constexpr const char* name = "{_c_str(metric.name)}";',
        f"  static constexpr int n_params = {len(names)};",
        *ind(_struct_facts(metric, deps), 2),
        *ind(members, 2),
        f"  GRT_HD static {struct} from_params("
        f"{'const float* p' if dynamic and names else 'const float*'}) {{",
        f"    {struct} m{{}};",
        *ind(init, 4),
        "    return m;",
        "  }",
        "  GRT_HD GRT_INLINE float polar_r([[maybe_unused]] const float x[4]) "
        "const {",
        *ind(polar_body, 4),
        f"    return {polar_ret};",
        "  }",
    ]
    if origin is not None:
        text += [
            "  GRT_HD GRT_INLINE float origin_distance(const float x[4]) "
            "const {",
            *ind(origin[0], 4),
            f"    return {origin[1]};",
            "  }",
        ]
    if rank1:
        text += [
            "  template <class X1, class X2, class X3>",
            "  GRT_HD GRT_INLINE auto fl([[maybe_unused]] const X1& c1, "
            "[[maybe_unused]] const X2& c2,",
            "                            [[maybe_unused]] const X3& c3) "
            "const {",
        ]
    else:
        text += [
            "  template <class X0, class X1, class X2, class X3>",
            "  GRT_HD GRT_INLINE auto g([[maybe_unused]] const X0& c0, "
            "[[maybe_unused]] const X1& c1,",
            "                           [[maybe_unused]] const X2& c2, "
            "[[maybe_unused]] const X3& c3) const {",
        ]
    text += [
        *ind(em.body, 4),
        f"    return {ret};",
        "  }",
        "};",
        "",
        "}  // namespace grt",
        "",
    ]
    text = "\n".join(text) + "\n"
    tag = hashlib.sha256(text.encode()).hexdigest()[:8]
    return Header(struct=struct.replace("@TAG@", tag), params=names,
                  text=text.replace("@TAG@", tag),
                  baked=None if dynamic else tuple(baked.values()))


def _sym_return(metric, em, outs, layout) -> str:
    """``g``'s return statement: the Sym of the entry dict's entries."""
    nz = metric.nonzeros()
    entries = {}
    for key, where in layout:
        i, j = min(key), max(key)
        if nz is not None and (i, j) not in nz:
            continue
        if isinstance(where, float):
            entries[(i, j)] = lit(where)
            continue
        node = outs[where]
        k = em.vals[node][0]
        if k == "dual":
            entries[(i, j)] = em.vals[node][1]
        elif k == "pyc":
            entries[(i, j)] = lit(em.vals[node][1])
        else:
            entries[(i, j)] = em.scalar(node, torch.float32)
    for (i, j) in sorted(nz if nz is not None else
                         {(i, j) for i in range(4) for j in range(i, 4)}):
        entries.setdefault((i, j), lit(0.0))
    sym = ", ".join(f"entry<{i}, {j}>({e})" for (i, j), e in
                    sorted(entries.items()))
    return f"sym({sym})"


def _c_str(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')
