"""Complex arithmetic on explicit (re, im) pairs (the port's counterpart of
``geodesic_raytracing_tpu.ops.complexify``).

The double-Kerr family's Ernst potentials are written in complex
arithmetic.  The reference traces them in complex64 and re-evaluates the
jaxpr with every complex value as a float32 (re, im) pair (``realify``).
The port writes the pairs out by hand: each metric function calls the pair
functions below, and ``csrc/complex.cuh`` holds the same functions on the
kernel's dual numbers, so that the kernel follows the plain march op for op.
torch's own complex type is not used: its division, sqrt and abs on the
card have their own algorithms and forward-mode rules, which the kernel
could not reproduce bit for bit.

A pair is a tuple ``(re, im)``.  A component is a tensor, a Python float,
or ``None``: an exact structural zero (the reference's symbolic zero
imaginary part), which every function folds away, as the kernel's ``Zero``
type folds it at compile time.  Components that are Python floats (or
float64 tensors, for parameters that require grad) are expressions of
parameters alone, evaluated in double (``geometry.param64``); the metric
functions round them to float32 (``c32``) before they meet a coordinate.

The formulas are the reference's (``ops/complexify.py:63-185``): the
product, the quotient through one reciprocal of |b|^2 (a real denominator
takes its reciprocal alone), ``cabs`` and the principal ``csqrt`` by the
half-angle form, each with the reference's custom derivative (``csqrt``'s
dz / (2 w), which stays finite at a positive real, where the half-angle
form's own derivative is inf * 0), and ``cpow`` by the polar form.
"""

from __future__ import annotations

import math

import torch

from .geometry import param32

Tensor = torch.Tensor


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
    where it will meet a coordinate (``geometry.param32``)."""
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
    """z * conj(z), real (the reference's ``_scm``)."""
    return real(cmul(a, conj(a)))


class _Cabs(torch.autograd.Function):
    """|z| = sqrt(re^2 + im^2) with the reference's derivative
    (re dre + im dim) / max(|z|, 1e-37)."""

    @staticmethod
    def forward(ar, ai):
        return torch.sqrt(ar * ar + ai * ai)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs, output)
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def jvp(ctx, dar, dai):
        ar, ai, m = ctx.saved_tensors
        inv = torch.reciprocal(torch.clamp(m, min=1e-37))
        return _zadd(_zmul(ar, dar), _zmul(ai, dai)) * inv

    @staticmethod
    def backward(ctx, g):
        # The transpose of the tangent rule.
        ar, ai, m = ctx.saved_tensors
        gi = g * torch.reciprocal(torch.clamp(m, min=1e-37))
        return gi * ar, gi * ai


class _Csqrt(torch.autograd.Function):
    """The principal sqrt by the half-angle form (sqrt(-1 + 0j) = +1j), with
    the reference's derivative dw = dz / (2 w), |w|^2 floored at 1e-37."""

    @staticmethod
    def forward(ar, ai):
        m = torch.sqrt(ar * ar + ai * ai)
        re = torch.sqrt(torch.clamp(0.5 * (m + ar), min=0.0))
        im = torch.sqrt(torch.clamp(0.5 * (m - ar), min=0.0))
        return re, torch.where(ai < 0, -im, im)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*output)
        ctx.save_for_backward(*output)

    @staticmethod
    def jvp(ctx, dar, dai):
        wr, wi = ctx.saved_tensors
        inv = 0.5 * torch.reciprocal(torch.clamp(wr * wr + wi * wi,
                                                 min=1e-37))
        return (_zadd(_zmul(dar, wr), _zmul(dai, wi)) * inv,
                _zsub(_zmul(dai, wr), _zmul(dar, wi)) * inv)

    @staticmethod
    def backward(ctx, gr, gi):
        # The transpose of the tangent rule: the cotangents times inv, then
        # to re by (wr, -wi) and to im by (wi, wr).
        wr, wi = ctx.saved_tensors
        inv = 0.5 * torch.reciprocal(torch.clamp(wr * wr + wi * wi,
                                                 min=1e-37))
        gri, gii = gr * inv, gi * inv
        return gri * wr - gii * wi, gri * wi + gii * wr


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


def cabs(a):
    """|z|: |re| where z is real, else the custom-derivative modulus."""
    ar, ai = pair(a)
    if ai is None:
        return torch.abs(ar) if _is_tensor(ar) else abs(ar)
    ar, ai = _operands(ar, ai)
    if _is_tensor(ar):
        return _Cabs.apply(ar, ai)
    return math.sqrt(ar * ar + ai * ai)


def csqrt(a):
    """The principal square root.  A zero imaginary part still takes the
    complex branch (the real part may be negative): it is filled with
    zeros, as the reference materialises it."""
    ar, ai = _operands(*pair(a))
    if _is_tensor(ar):
        return _Csqrt.apply(ar, ai)
    return _csqrt_float(ar, ai)


def cpow(a, c: float):
    """z ** c for a real exponent c by the polar form
    (|z|^c cos(c arg z), |z|^c sin(c arg z)), |z| floored at 1e-37.  The
    port applies it to parameter expressions alone, in double, with the
    exact atan2 (the reference's polynomial one stands in for Mosaic's
    missing atan)."""
    ar, ai = _operands(*pair(a))
    m = cabs((ar, ai))
    if _is_tensor(ar):
        theta = torch.atan2(ai, ar)
        mc = torch.clamp(m, min=1e-37) ** c
        return (mc * torch.cos(c * theta), mc * torch.sin(c * theta))
    theta = math.atan2(ai, ar)
    mc = max(m, 1e-37) ** c
    return (mc * math.cos(c * theta), mc * math.sin(c * theta))
