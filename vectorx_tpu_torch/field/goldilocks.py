"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on torch int64 tensors.

Representation: an element is ONE ``torch.int64`` tensor holding the 64-bit
pattern of its canonical value in [0, p). Values >= 2^63 (for example
p - 1 = 0xFFFFFFFF00000000) read as negative int64; every op below treats
the pattern as unsigned:

- ``+``, ``-`` and ``*`` wrap mod 2^64 on CPU and CUDA alike, so they are
  the unsigned wrapping ops;
- an unsigned compare is ``(a ^ MIN) < (b ^ MIN)`` (bias by the sign bit);
- ``>>`` is arithmetic, so a logical shift is followed by a mask;
- a 64x64 -> 128-bit product is built from four 32x32 -> 64 products.

The reduction is the standard Goldilocks one:

    2^64 ≡ 2^32 - 1 (mod p)      ("EPSILON")
    2^96 ≡ -1       (mod p)

Every public function takes and returns canonical elements; the device is
the one of the input tensors. The constructors (``to_fp``, ``zeros``,
``ones``, ``full``) take ``device=None`` for the current CUDA device (see
``default_device``) or ``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device

MODULUS = 0xFFFFFFFF00000001  # p = 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF  # 2^64 mod p
TWO_ADICITY = 32
MULTIPLICATIVE_GROUP_GENERATOR = 7
POWER_OF_TWO_GENERATOR = 0x185629DCDA58878C

M32 = 0xFFFFFFFF
MIN = -(1 << 63)                      # int64 sign bit
_P_BIASED = MODULUS ^ (1 << 63)       # p with the sign bit flipped (< 2^63)
# 0-d CPU constants: cheaper operands than Python ints on small tensors,
# and usable with tensors on any device
_M32_T = torch.tensor(M32)
_MIN_T = torch.tensor(MIN)
_P_BIASED_T = torch.tensor(_P_BIASED)

Fp = torch.Tensor


def to_i64(v: int) -> int:
    """Python int in [0, 2^64) -> the signed int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


P_I64 = to_i64(MODULUS)


# ---------------------------------------------------------------------------
# Host-side conversion helpers
# ---------------------------------------------------------------------------

def to_fp(values, device=None) -> Fp:
    """Python ints / numpy integer array -> canonical int64 tensor."""
    if isinstance(values, np.ndarray) and values.dtype.kind == "u":
        u = values.astype(np.uint64) % np.uint64(MODULUS)
    else:
        # object dtype keeps Python ints exact (a plain asarray of mixed
        # ints >= 2^63 would round through float64)
        u = np.array(np.asarray(values, dtype=np.object_) % MODULUS,
                     dtype=np.uint64)
    return torch.from_numpy(np.ascontiguousarray(u).view(np.int64)).to(
        default_device(device))


def to_u64(x: Fp) -> np.ndarray:
    """Tensor -> numpy uint64 array (same bits)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def from_fp(x: Fp) -> np.ndarray:
    """Tensor -> numpy object array of Python ints (exact)."""
    return to_u64(x).astype(np.object_)


def zeros(shape, device=None) -> Fp:
    return torch.zeros(shape, dtype=torch.int64,
                       device=default_device(device))


def ones(shape, device=None) -> Fp:
    return torch.ones(shape, dtype=torch.int64,
                      device=default_device(device))


def full(shape, value: int, device=None) -> Fp:
    return torch.full(shape, to_i64(value % MODULUS), dtype=torch.int64,
                      device=default_device(device))


# ---------------------------------------------------------------------------
# Unsigned 64-bit helpers on int64 bit patterns
# ---------------------------------------------------------------------------

def ltu(a, b):
    """Unsigned a < b."""
    return (a ^ _MIN_T) < (b ^ _MIN_T)


def _lo32(x):
    return x & _M32_T


def _hi32(x):
    """Logical x >> 32."""
    return (x >> 32) & _M32_T


def canonicalize(x: Fp) -> Fp:
    """Any 64-bit pattern -> [0, p) by one conditional subtract of p
    (subtracting p mod 2^64 is adding EPSILON)."""
    return torch.where((x ^ _MIN_T) >= _P_BIASED_T, x + EPSILON, x)


def _fold_hi(lo: Fp, k: Fp) -> Fp:
    """lo + k * 2^64 (mod p) as a 64-bit value, possibly >= p, for
    unsigned lo < 2^64 and 0 <= k < 2^32."""
    t = (k << 32) - k                       # k * EPSILON, < 2^64
    r = lo + t
    return torch.where(ltu(r, t), r + EPSILON, r)


# ---------------------------------------------------------------------------
# Modular ops (inputs/outputs canonical in [0, p))
# ---------------------------------------------------------------------------

def sub(a: Fp, b: Fp) -> Fp:
    d = a - b
    # a borrow wrapped by +2^64; the true value wants +p, i.e. -EPSILON
    return torch.where(ltu(a, b), d - EPSILON, d)


def add(a: Fp, b: Fp) -> Fp:
    # a + b = a - (p - b), with p - b in (0, p]
    return sub(a, P_I64 - b)


def neg(a: Fp) -> Fp:
    return sub(torch.zeros_like(a), a)


def mul_wide(a: Fp, b: Fp):
    """64x64 -> 128-bit product as (lo64, hi64) bit patterns. The middle
    limb is summed from 32-bit halves, so no sum can wrap."""
    a0, a1 = _lo32(a), _hi32(a)
    b0, b1 = _lo32(b), _hi32(b)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = _lo32(lh) + _lo32(hl) + _hi32(ll)             # < 3 * 2^32
    hi = hh + _hi32(lh) + _hi32(hl) + (mid >> 32)
    lo = _lo32(ll) | (mid << 32)
    return lo, hi


def reduce128_lazy(lo: Fp, hi: Fp) -> Fp:
    """lo + hi * 2^64 (mod p) as a 64-bit value, possibly >= p:
    lo - n3 + n2 * EPSILON with hi = n3:n2."""
    n2 = _lo32(hi)
    n3 = _hi32(hi)
    t0 = lo - n3
    t0 = torch.where(ltu(lo, n3), t0 - EPSILON, t0)
    return _fold_hi(t0, n2)


def reduce128(lo: Fp, hi: Fp) -> Fp:
    """(lo + hi * 2^64) mod p, canonical."""
    return canonicalize(reduce128_lazy(lo, hi))


def mul_lazy(a: Fp, b: Fp) -> Fp:
    """a * b (mod p) for ANY 64-bit operands, as a 64-bit value that may
    be >= p; only mul_lazy and the 32-bit-half sums accept such values."""
    return reduce128_lazy(*mul_wide(a, b))


def mul(a: Fp, b: Fp) -> Fp:
    return reduce128(*mul_wide(a, b))


def square(a: Fp) -> Fp:
    return mul(a, a)


def mul_scalar(a: Fp, k: int) -> Fp:
    """Multiply by a Python-int constant; k < 2^32 takes a two-product
    path (a·k < 2^96)."""
    k %= MODULUS
    if k >> 32:
        return mul(a, full((), k, a.device))
    p0 = _lo32(a) * k
    p1 = _hi32(a) * k
    lo = p0 + (p1 << 32)
    hi = _hi32(p1)
    return canonicalize(_fold_hi(lo, torch.where(ltu(lo, p0), hi + 1, hi)))


def pow_const(a: Fp, e: int) -> Fp:
    """a ** e for a Python-int exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inv(a: Fp) -> Fp:
    """Multiplicative inverse, inv(0) = 0: the product tree of the
    elements (a zero taken as 1), one Fermat power a^(p-2) at its root, and
    the tree walked back down; three products an element, where a Fermat
    power of each takes about 126."""
    flat = a.reshape(-1)
    if flat.numel() <= 1:
        return pow_const(a, MODULUS - 2)
    zero = flat == 0
    x = torch.where(zero, torch.ones_like(flat), flat)
    levels = []
    while x.numel() > 1:
        levels.append(x)
        if x.numel() % 2:
            x = torch.cat([x, torch.ones_like(x[:1])])
        x = mul(x[0::2], x[1::2])
    y = pow_const(x, MODULUS - 2)
    for level in reversed(levels):
        # 1/left = right/(left*right) and 1/right = left/(left*right)
        n = level.numel()
        if n % 2:
            level = torch.cat([level, torch.ones_like(level[:1])])
        y = torch.stack([mul(y, level[1::2]), mul(y, level[0::2])],
                        dim=-1).reshape(-1)[:n]
    return torch.where(zero, flat, y).reshape(a.shape)


def batch_inv(a: Fp) -> Fp:
    return inv(a)


def _reduce_sums(slo: Fp, shi: Fp) -> Fp:
    """(slo + shi * 2^32) mod p for non-negative int64 slo, shi < 2^63."""
    lo = slo + (shi << 32)
    k = shi >> 32
    return canonicalize(_fold_hi(lo, torch.where(ltu(lo, slo), k + 1, k)))


def sum_mod(a: Fp, axis: int = -1) -> Fp:
    """Exact modular sum over an axis: the 32-bit halves are summed in
    int64 (exact for fewer than 2^31 terms), then one reduction."""
    n = a.shape[axis]
    if n >= (1 << 31):
        raise ValueError(f"sum_mod: too many terms ({n})")
    return _reduce_sums(_lo32(a).sum(axis), _hi32(a).sum(axis))


def prefix_sum_mod(a: Fp) -> Fp:
    """Exclusive running modular sum over the last axis: out[i] = a[0] +
    ... + a[i-1] (mod p), so out[0] = 0. ``torch.cumsum`` on the bit
    patterns would wrap mod 2^64, so the 32-bit halves are summed in int64
    (exact for fewer than 2^31 terms) and each prefix reduced once, as
    ``sum_mod`` does."""
    n = a.shape[-1]
    if n >= (1 << 31):
        raise ValueError(f"prefix_sum_mod: too many terms ({n})")
    before = torch.nn.functional.pad(a[..., :-1], (1, 0))
    return _reduce_sums(torch.cumsum(_lo32(before), -1),
                        torch.cumsum(_hi32(before), -1))


def is_zero(a: Fp):
    return a == 0


def eq(a: Fp, b: Fp):
    return a == b


def select(mask, a: Fp, b: Fp) -> Fp:
    """mask ? a : b."""
    return torch.where(mask, a, b)


def double(a: Fp) -> Fp:
    return add(a, a)


# ---------------------------------------------------------------------------
# Roots of unity (host-side exact computation)
# ---------------------------------------------------------------------------

def primitive_root_of_unity(log_n: int) -> int:
    """Python int: primitive 2^log_n-th root of unity."""
    if not 0 <= log_n <= TWO_ADICITY:
        raise ValueError(f"no 2^{log_n}-th root of unity")
    base = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - log_n):
        base = (base * base) % MODULUS
    return base


def host_pow(base: int, e: int) -> int:
    return pow(base, e, MODULUS)


def host_inv(a: int) -> int:
    return pow(a, MODULUS - 2, MODULUS)
