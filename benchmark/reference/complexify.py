"""Complex arithmetic on explicit (re, im) pairs, for the plain reference's
complex-potential metrics.

Frozen copy of ``geodesic_raytracing_tpu_torch/ops/complexify.py`` (commit
5526645), trimmed to what ``metrics/double_kerr.py`` calls, with the
parameter helpers ``param64`` / ``param32`` of ``ops/geometry.py``.
Departures from the copied code, none of which changes a value:

* no content-pack emitter hooks (``geometry.emitting``): the reference
  evaluates, it records nothing;
* ``csqrt``'s custom function keeps its forward and its tangent rule and
  leaves out the reverse-mode rule, which no reference path takes;
* ``cabs`` and ``cpow``, which ``double_kerr`` does not call, are left out.

A pair is a tuple ``(re, im)``.  A component is a tensor, a Python float,
or ``None``: an exact structural zero, which every function folds away.
Components that are Python floats are expressions of parameters alone,
evaluated in double; the metric rounds them to float32 (``c32``) before
they meet a coordinate.  The product, the quotient through one reciprocal
of |b|^2 (a real denominator takes its reciprocal alone) and the principal
``csqrt`` by the half-angle form with the derivative dz / (2 w).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def param64(x):
    """A parameter for an expression of parameters alone: a Python float as
    it is, a tensor in float64."""
    return x.double() if isinstance(x, torch.Tensor) else x


def param32(x):
    """The value of such an expression where it meets a coordinate: a
    tensor rounded to float32 (a Python float is rounded by the op)."""
    return x.float() if isinstance(x, torch.Tensor) else x


def _is_tensor(x) -> bool:
    return isinstance(x, Tensor)


# -- components: None is an exact zero -------------------------------------

def _zadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _zsub(a, b):
    if b is None:
        return a
    if a is None:
        return -b
    return a - b


def _zneg(a):
    return None if a is None else -a


def _zmul(a, b):
    if a is None or b is None:
        return None
    return a * b


def _recip(x):
    return torch.reciprocal(x) if _is_tensor(x) else 1.0 / x


def _zeros_like(x):
    return torch.zeros_like(x) if _is_tensor(x) else 0.0


# -- pairs -------------------------------------------------------------------

def pair(x):
    """A pair of ``x``: a pair as it is, a real value with a zero imaginary
    part."""
    return x if isinstance(x, tuple) else (x, None)


def c32(a):
    """A pair of parameter expressions, each component rounded to float32
    where it will meet a coordinate."""
    return tuple(None if v is None else param32(v) for v in pair(a))


def cadd(a, b):
    (ar, ai), (br, bi) = pair(a), pair(b)
    return (_zadd(ar, br), _zadd(ai, bi))


def csub(a, b):
    (ar, ai), (br, bi) = pair(a), pair(b)
    return (_zsub(ar, br), _zsub(ai, bi))


def cneg(a):
    ar, ai = pair(a)
    return (_zneg(ar), _zneg(ai))


def conj(a):
    ar, ai = pair(a)
    return (ar, _zneg(ai))


def real(a):
    return pair(a)[0]


def imag(a):
    return pair(a)[1]


def cmul(a, b):
    (ar, ai), (br, bi) = pair(a), pair(b)
    return (_zsub(_zmul(ar, br), _zmul(ai, bi)),
            _zadd(_zmul(ar, bi), _zmul(ai, br)))


def cdiv(a, b):
    """a / b through one reciprocal: of b alone where b is real, else of
    |b|^2."""
    (ar, ai), (br, bi) = pair(a), pair(b)
    if bi is None:
        inv = _recip(br)
        return (_zmul(ar, inv), _zmul(ai, inv))
    inv = _recip(_zadd(_zmul(br, br), _zmul(bi, bi)))
    return (_zmul(_zadd(_zmul(ar, br), _zmul(ai, bi)), inv),
            _zmul(_zsub(_zmul(ai, br), _zmul(ar, bi)), inv))


def scm(a):
    """z * conj(z), real."""
    return real(cmul(a, conj(a)))


class _Csqrt(torch.autograd.Function):
    """The principal sqrt by the half-angle form (sqrt(-1 + 0j) = +1j), with
    the derivative dw = dz / (2 w), |w|^2 floored at 1e-37."""

    @staticmethod
    def forward(ar, ai):
        m = torch.sqrt(ar * ar + ai * ai)
        re = torch.sqrt(torch.clamp(0.5 * (m + ar), min=0.0))
        im = torch.sqrt(torch.clamp(0.5 * (m - ar), min=0.0))
        return re, torch.where(ai < 0, -im, im)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*output)

    @staticmethod
    def jvp(ctx, dar, dai):
        wr, wi = ctx.saved_tensors
        inv = 0.5 * torch.reciprocal(torch.clamp(wr * wr + wi * wi,
                                                 min=1e-37))
        return (_zadd(_zmul(dar, wr), _zmul(dai, wi)) * inv,
                _zsub(_zmul(dai, wr), _zmul(dar, wi)) * inv)


def _csqrt_float(ar: float, ai: float):
    m = math.sqrt(ar * ar + ai * ai)
    re = math.sqrt(max(0.5 * (m + ar), 0.0))
    im = math.sqrt(max(0.5 * (m - ar), 0.0))
    return re, -im if ai < 0 else im


def _operands(ar, ai):
    """Both components as tensors of one shape (or both floats): a None or
    float component is filled like the tensor one."""
    if ar is None:
        ar = _zeros_like(ai)
    if ai is None:
        ai = _zeros_like(ar)
    if _is_tensor(ar) or _is_tensor(ai):
        like = ar if _is_tensor(ar) else ai
        ar, ai = (v if _is_tensor(v) else torch.full_like(like, v)
                  for v in (ar, ai))
        ar, ai = torch.broadcast_tensors(ar, ai)
    return ar, ai


def csqrt(a):
    """The principal square root.  A zero imaginary part still takes the
    complex branch (the real part may be negative): it is filled with
    zeros."""
    ar, ai = _operands(*pair(a))
    if _is_tensor(ar):
        return _Csqrt.apply(ar, ai)
    return _csqrt_float(ar, ai)
