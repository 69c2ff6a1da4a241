"""Quadratic extension GF(p^2) = GF(p)[X] / (X^2 - W), W = 7.

The FRI/transcript challenge field. An element is a ``(re, im)`` tuple of
base-field tensors meaning ``re + im*X``; see goldilocks.py for the base
representation.
"""

from __future__ import annotations

from typing import Tuple

from . import goldilocks as gl

W = 7  # X^2 = 7

Fp2 = Tuple[gl.Fp, gl.Fp]


def zeros(shape, device=None) -> Fp2:
    return gl.zeros(shape, device), gl.zeros(shape, device)


def ones(shape, device=None) -> Fp2:
    return gl.ones(shape, device), gl.zeros(shape, device)


def from_base(a: gl.Fp) -> Fp2:
    return a, gl.zeros(a.shape, a.device)


def to_fp2(values, device=None) -> Fp2:
    """Iterable of (a, b) Python-int pairs -> Fp2."""
    a = [v[0] for v in values]
    b = [v[1] for v in values]
    return gl.to_fp(a, device), gl.to_fp(b, device)


def add(x: Fp2, y: Fp2) -> Fp2:
    return gl.add(x[0], y[0]), gl.add(x[1], y[1])


def sub(x: Fp2, y: Fp2) -> Fp2:
    return gl.sub(x[0], y[0]), gl.sub(x[1], y[1])


def neg(x: Fp2) -> Fp2:
    return gl.neg(x[0]), gl.neg(x[1])


def mul(x: Fp2, y: Fp2) -> Fp2:
    # (a + bX)(c + dX) = ac + W*bd + (ad + bc) X
    a, b = x
    c, d = y
    ac = gl.mul(a, c)
    bd = gl.mul(b, d)
    ad = gl.mul(a, d)
    bc = gl.mul(b, c)
    re = gl.add(ac, gl.mul_scalar(bd, W))
    im = gl.add(ad, bc)
    return re, im


def square(x: Fp2) -> Fp2:
    return mul(x, x)


def mul_base(x: Fp2, s: gl.Fp) -> Fp2:
    return gl.mul(x[0], s), gl.mul(x[1], s)


def inv(x: Fp2) -> Fp2:
    # (a + bX)^-1 = (a - bX) / (a^2 - W b^2)
    a, b = x
    norm = gl.sub(gl.square(a), gl.mul_scalar(gl.square(b), W))
    ninv = gl.inv(norm)
    return gl.mul(a, ninv), gl.mul(gl.neg(b), ninv)


def pow_const(x: Fp2, e: int) -> Fp2:
    """x ** e for a Python-int exponent (square and multiply)."""
    result = ones(x[0].shape, x[0].device)
    base = x
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def eq(x: Fp2, y: Fp2):
    return gl.eq(x[0], y[0]) & gl.eq(x[1], y[1])


def is_zero(x: Fp2):
    return gl.is_zero(x[0]) & gl.is_zero(x[1])


def select(mask, x: Fp2, y: Fp2) -> Fp2:
    return gl.select(mask, x[0], y[0]), gl.select(mask, x[1], y[1])
