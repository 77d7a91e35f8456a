"""Polynomial sin, cos and log (the torch twin of
control_toolkit_tpu/ops/fastmath.py).

``fast_sincos``, ``fast_sin`` and ``fast_cos`` reduce the argument once,
``r = x - 2 pi round(x / 2 pi)`` (``torch.round`` rounds half to even, as
``jnp.round`` does), and evaluate least-squares polynomials in ``r^2`` on
[-pi, pi] (~1e-5 absolute error in float32 over |x| <= 50).  ``fast_log``
takes the exponent and the mantissa of a positive normal float32 apart
through its bits and evaluates a polynomial of log2 on the mantissa
(~1.5e-6 absolute error).  The coefficients, the Horner order and the
Python-float constants are the JAX module's, so the same float32 inputs
give the same operations in the same order.

``fast_sincos_d`` adds the derivatives the JAX package's ``jax.vjp``
takes through ``fast_sincos``: ``round`` has a zero gradient, so
``dr/dx = 1`` and the derivatives are the polynomials' own, S'(r) and
C'(r), not ``fast_cos`` and ``-fast_sin``.  It returns ``-C'(r)`` in the
place where the exact trig's derivative of cos, negated, is ``sin``.

The device twin is ``csrc/fastmath.cuh``.  Each function is plain tensor
arithmetic, one operation a step, so on the card torch rounds every
product and sum apart, as the device code does (``__fmul_rn``).
"""
from __future__ import annotations

import torch

_TWO_PI = 6.283185307179586
_INV_TWO_PI = 1.0 / _TWO_PI

# Least-squares fits on Chebyshev nodes over [-pi, pi] (the JAX module's).
_SIN_C = (
    0.9999791148945326,
    -0.16662401538302676,
    0.008308849931229436,
    -0.00019263169952705723,
    2.14704961562231e-06,
)
_COS_C = (
    0.9999992107409235,
    -0.49999421315021114,
    0.04165977758578502,
    -0.0013858789204321562,
    2.420293205122177e-05,
    -2.1972921877546382e-07,
)
# The derivatives' coefficients, in double, then rounded as Python floats
# are when they meet a float32 tensor: S'(r) = sum (2i+1) s_i r^2i and
# -C'(r) = r * sum -2i c_i r^(2i-2).
_DSIN_C = tuple((2 * i + 1) * c for i, c in enumerate(_SIN_C))
_NDCOS_C = tuple(-2 * i * c for i, c in enumerate(_COS_C))[1:]

_LN2 = 0.6931471805599453
# Least-squares fit of log2(1+t) on [0,1) (Chebyshev nodes, degree 6).
_LOG2_C = (
    2.1237408918309273e-06,
    1.4424753148220764,
    -0.7175578724221764,
    0.45552708806115005,
    -0.2746232576172888,
    0.11929823770627786,
    -0.02512320328611391,
)


def _reduce(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.round(x * _INV_TWO_PI)


def _sin_poly(r, r2):
    return r * (_SIN_C[0] + r2 * (_SIN_C[1] + r2 * (_SIN_C[2] + r2 * (
        _SIN_C[3] + r2 * _SIN_C[4]))))


def _cos_poly(r2):
    return _COS_C[0] + r2 * (_COS_C[1] + r2 * (_COS_C[2] + r2 * (
        _COS_C[3] + r2 * (_COS_C[4] + r2 * _COS_C[5]))))


def fast_sincos(x: torch.Tensor):
    """(sin x, cos x) over one range reduction."""
    r = _reduce(x)
    r2 = r * r
    return _sin_poly(r, r2), _cos_poly(r2)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    r = _reduce(x)
    return _sin_poly(r, r * r)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    r = _reduce(x)
    return _cos_poly(r * r)


def fast_sincos_d(x: torch.Tensor):
    """``(sin, cos, dsin, ndcos)`` of ``fast_sincos`` at x: the values and
    the derivatives S'(r) and -C'(r) of the polynomials (exact trig's
    ``cos x`` and ``sin x``)."""
    r = _reduce(x)
    r2 = r * r
    dsin = _DSIN_C[0] + r2 * (_DSIN_C[1] + r2 * (_DSIN_C[2] + r2 * (
        _DSIN_C[3] + r2 * _DSIN_C[4])))
    ndcos = r * (_NDCOS_C[0] + r2 * (_NDCOS_C[1] + r2 * (_NDCOS_C[2] + r2 * (
        _NDCOS_C[3] + r2 * _NDCOS_C[4]))))
    return _sin_poly(r, r2), _cos_poly(r2), dsin, ndcos


def fast_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values: ``ln x = ln2 * (e +
    log2 m)`` for ``x = m 2^e``, ``m`` in [1, 2), e and m read from the
    bits (the logical shift of the JAX function, as a mask)."""
    bits = x.to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0x1FF) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    t = m - 1.0
    p = _LOG2_C[0] + t * (_LOG2_C[1] + t * (_LOG2_C[2] + t * (
        _LOG2_C[3] + t * (_LOG2_C[4] + t * (_LOG2_C[5] + t * _LOG2_C[6])))))
    return _LN2 * (e.to(torch.float32) + p)
