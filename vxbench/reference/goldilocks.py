"""The Goldilocks field p = 2^64 - 2^32 + 1 and its quadratic extension
GF(p)[X] / (X^2 - 7), on Python ints and on numpy uint64 arrays.

Plain arithmetic for the benchmark's reference: every numpy function
takes canonical values (< p) and returns canonical values.
"""

from __future__ import annotations

import numpy as np

P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1                      # 2^64 mod p
W = 7                                    # X^2 = W in the extension
GENERATOR = 7                            # of the multiplicative group
TWO_ADICITY = 32
#: a primitive 2^32-th root of unity (7^((p - 1) / 2^32))
ROOT_2_32 = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
_EPS = np.uint64(EPS)
_P = np.uint64(P)


def root_of_unity(log_n: int) -> int:
    """A primitive 2^log_n-th root of unity."""
    return pow(ROOT_2_32, 1 << (TWO_ADICITY - log_n), P)


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("0 has no inverse in GF(p)")
    return pow(a, P - 2, P)


# -- the extension on Python-int pairs (re, im) ------------------------------

def e_add(x, y):
    return (x[0] + y[0]) % P, (x[1] + y[1]) % P


def e_sub(x, y):
    return (x[0] - y[0]) % P, (x[1] - y[1]) % P


def e_mul(x, y):
    a, b = x
    c, d = y
    return (a * c + W * b * d) % P, (a * d + b * c) % P


def e_inv(x):
    a, b = x
    norm = (a * a - W * b * b) % P
    ni = inv(norm)
    return a * ni % P, (-b) * ni % P


def e_powers(x, n: int):
    """[1, x, x^2, ...] (n terms)."""
    out, acc = [], (1, 0)
    for _ in range(n):
        out.append(acc)
        acc = e_mul(acc, x)
    return out


# -- numpy uint64 --------------------------------------------------------------

def _reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """lo + 2^64 hi (mod p), canonical. 2^64 = EPS and 2^96 = -1 mod p."""
    hh, hl = hi >> _S32, hi & _M32
    t = lo - hh
    t = t - (lo < hh).astype(np.uint64) * _EPS      # a borrow of 2^64
    u = hl * _EPS
    r = t + u
    r = r + (r < u).astype(np.uint64) * _EPS        # a carry of 2^64
    return np.where(r >= _P, r - _P, r)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    a0, a1 = a & _M32, a >> _S32
    b0, b1 = b & _M32, b >> _S32
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (ll >> _S32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | ((mid & _M32) << _S32)
    hi = hh + (lh >> _S32) + (hl >> _S32) + (mid >> _S32)
    return _reduce128(lo, hi)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    s = a + b
    s = s + (s < a).astype(np.uint64) * _EPS
    return np.where(s >= _P, s - _P, s)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return np.where(a >= b, a - b, a + (_P - b))


def coefficients(cols: np.ndarray) -> np.ndarray:
    """The coefficients, lowest first, of the polynomials of degree < n
    that take the values ``cols[:, i]`` at g^i, g = root_of_unity(log2 n):
    an inverse NTT of each row of the (k, n) array."""
    cols = np.asarray(cols, dtype=np.uint64)
    k, n = cols.shape
    log_n = n.bit_length() - 1
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((np.arange(n) >> b) & 1) << (log_n - 1 - b)
    a = cols[:, rev]
    g_inv = inv(root_of_unity(log_n))
    length = 2
    while length <= n:
        half = length // 2
        w = pow(g_inv, n // length, P)
        tw, acc = [], 1
        for _ in range(half):
            tw.append(acc)
            acc = acc * w % P
        a = a.reshape(k, n // length, length)
        u, v = a[:, :, :half], mul(a[:, :, half:], np.array(tw, np.uint64))
        a = np.concatenate([add(u, v), sub(u, v)], axis=2).reshape(k, n)
        length *= 2
    return mul(a, np.uint64(inv(n)))


def evaluate(coeffs: np.ndarray, z) -> list:
    """Each row of a (k, n) array of coefficients evaluated at the
    extension point z -> k pairs (re, im)."""
    pw = e_powers(z, coeffs.shape[1])
    re = np.array([p[0] for p in pw], dtype=np.uint64)
    im = np.array([p[1] for p in pw], dtype=np.uint64)
    return list(zip(sum_rows(mul(coeffs, re)), sum_rows(mul(coeffs, im))))


def sum_rows(a: np.ndarray) -> list:
    """Σ over the last axis of an (..., n) array of canonical values, as
    Python ints mod p (the 32-bit halves summed apart, so n < 2^32 values
    cannot overflow)."""
    a = np.asarray(a, dtype=np.uint64)
    lo = (a & _M32).sum(axis=-1, dtype=np.uint64)
    hi = (a >> _S32).sum(axis=-1, dtype=np.uint64)
    return [(int(l) + (int(h) << 32)) % P
            for l, h in zip(np.ravel(lo), np.ravel(hi))]
