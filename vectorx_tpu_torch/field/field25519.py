"""GF(2^255 - 19) as 16x16-bit-limb int64 tensors — curve25519 arithmetic.

The backbone of the batched Ed25519 verifier (``circuits/ed25519.py``): a
field element is a (..., 16) int64 tensor of 16-bit limbs, little-endian.
Every function returns 16-bit limbs of the same integer as the JAX
package's function of the same name (lazily reduced, below 2^256, not
always canonical): a 16-bit-limb form of an integer is unique, so the limbs
are equal limb for limb, whatever carry method computes them.

Two choices differ from the JAX code and leave every integer unchanged:

- ``mul`` sums its limb products into columns, and folds columns 16..31
  onto 0..15 (2^256 ≡ 38), with float64 matmuls against ``(256, 17)``
  matrices of 0, 1 and 38, one for the low and one for the high halves of
  the limb products (CUDA has no integer matmul; float64 is exact here, as
  every column is below 2^27);
- carries propagate in parallel (``_carry``: one normalising pass, then
  one carry-lookahead pass) instead of one limb at a time; ``sub`` adds 4p
  in a form whose columns are all at least 0xFFFF, so its columns stay
  non-negative.

Functions that take tensors work on their device; ``zeros``, ``const`` and
``to_limbs`` take ``device=None`` for the current CUDA device (see
``default_device``) or ``"cpu"``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device

P25519 = (1 << 255) - 19
NLIMB = 16
M16 = 0xFFFF


def int_limbs(value: int, n: int = NLIMB):
    """A non-negative int -> its n lowest 16-bit limbs (Python ints)."""
    return [(value >> (16 * i)) & M16 for i in range(n)]


@lru_cache(maxsize=None)
def _tensor(values: tuple, device: torch.device, dtype=torch.int64):
    return torch.tensor(values, dtype=dtype, device=device)


def _fourp_columns() -> tuple:
    """4p as 16 columns, each at least 0xFFFF: 4p's limbs with 2^16 moved
    down from every column above the first (the same integer), so that
    a + 4p - b has non-negative columns for any 16-bit limbs b."""
    fourp = 4 * P25519
    tp = int_limbs(fourp)
    tp[NLIMB - 1] |= (fourp >> (16 * NLIMB)) << 16   # keep the 2^256 part
    for i in range(NLIMB - 1):
        tp[i] += 1 << 16
        tp[i + 1] -= 1
    return tuple(tp)


_FOURP = _fourp_columns()
_P_LIMBS = tuple(int_limbs(P25519))
_TWO256_MINUS_P = tuple(int_limbs((1 << 256) - P25519))


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def to_limbs(values, device=None) -> torch.Tensor:
    """Python ints -> (..., 16) int64 limbs (canonical)."""
    arr = np.asarray(values, dtype=np.object_)
    out = np.zeros(arr.shape + (NLIMB,), dtype=np.int64)
    for idx in np.ndindex(arr.shape):
        out[idx] = int_limbs(int(arr[idx]) % P25519)
    return torch.from_numpy(out).to(default_device(device))


def from_limbs(x: torch.Tensor) -> np.ndarray:
    """Limbs -> canonical Python ints (reduces: ring values are lazy)."""
    arr = x.cpu().numpy()
    out = np.zeros(arr.shape[:-1], dtype=np.object_)
    for idx in np.ndindex(out.shape):
        val = 0
        for limb in reversed(arr[idx].tolist()):
            val = (val << 16) | int(limb)
        out[idx] = val % P25519
    return out


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NLIMB,), dtype=torch.int64,
                       device=default_device(device))


def const(shape, value: int, device=None) -> torch.Tensor:
    limbs = _tensor(tuple(int_limbs(value % P25519)), default_device(device))
    return limbs.expand(tuple(shape) + (NLIMB,))


# ---------------------------------------------------------------------------
# Carry propagation / canonicalization
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _wide_consts(n: int, device: torch.device):
    """-> (mask: 0xFFFF per limb and all ones for the top column; positions
    1..n+1; 1 per limb and 0 for the top column)."""
    return (_tensor((M16,) * n + (-1,), device),
            _tensor(tuple(range(1, n + 2)), device),
            _tensor((1,) * n + (0,), device))


def _carry(x: torch.Tensor) -> torch.Tensor:
    """(..., n + 1) non-negative columns below 2^32 - 2^16, the last one a
    carry column -> the same integer as n 16-bit limbs and the carry-out in
    the last column (limbs + carry * 2^(16 n)).

    One pass of "keep the low 16 bits, add the rest one column up" leaves
    every limb column at most 0x1FFFD; from there each carry is 0 or 1 and
    ripples only through columns equal to 0xFFFF. So the carry out of
    column i is the high bit of the last column at or below i that is not
    0xFFFF: a running maximum of positions finds it for every column at
    once."""
    mask, pos, _ = _wide_consts(x.shape[-1] - 1, x.device)
    x = (x & mask) + F.pad((x >> 16)[..., :-1], (1, 0))
    last = torch.cummax(torch.where(x != M16, pos, 0), dim=-1).values
    out = torch.gather(F.pad(x >> 16, (1, 0)), -1, last)
    return (x + F.pad(out[..., :-1], (1, 0))) & mask


def _fold_carry(w: torch.Tensor) -> torch.Tensor:
    """(..., 17) limbs and carry: value + carry * 2^256 ≡ value + 38 * carry
    (mod p), twice; the carry of the second fold is dropped (it is zero).
    -> (..., 16) limbs."""
    keep = _wide_consts(NLIMB, w.device)[2]
    for _ in range(2):
        w = _carry(w * keep + F.pad(38 * w[..., NLIMB:], (0, NLIMB)))
    return w[..., :NLIMB]


def _limbs_carry(x: torch.Tensor) -> torch.Tensor:
    """(..., n) columns -> (..., n + 1) with a zero carry column."""
    return F.pad(x, (0, 1))


def _ge(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x >= t for limb vectors (..., n) against (n,): the highest limb that
    differs decides, so its sign outweighs every lower one."""
    n = x.shape[-1]
    weight = _tensor(tuple(1 << i for i in range(n)), x.device)
    return (torch.sign(x - t) * weight).sum(-1) >= 0


def _ge_p(x: torch.Tensor) -> torch.Tensor:
    """x >= p for 16-limb canonical-range values (< 2^256)."""
    return _ge(x, _tensor(_P_LIMBS, x.device))


def _sub_p(x: torch.Tensor) -> torch.Tensor:
    """(x - p) mod 2^256."""
    return _carry(_limbs_carry(x + _tensor(_TWO256_MINUS_P, x.device)))[
        ..., :NLIMB]


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Reduce a 16-limb value (< 2^256) into [0, p) — two conditional
    subtracts (2^256 - 1 = 2p + 37, so at most two are ever needed)."""
    for _ in range(2):
        x = torch.where(_ge_p(x)[..., None], _sub_p(x), x)
    return x


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy modular add: 16-bit limbs out, value < 2^256."""
    return _fold_carry(_carry(_limbs_carry(a + b)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy modular subtract: a - b + 4p (4p > 2^256 > b)."""
    return _fold_carry(_carry(_limbs_carry(a + _tensor(_FOURP, a.device) - b)))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


@lru_cache(maxsize=None)
def _column_matrices(device: torch.device):
    """Two (256, 17) float64 matrices mapping the low and the high 16-bit
    halves of the limb products onto their 2^16-weighted columns (a high
    half one column up), with columns 16..31 folded onto 0..15 by 38
    (2^256 ≡ 38) and a zero carry column: the JAX package's column sums
    and their fold."""
    m = np.zeros((2, NLIMB * NLIMB, NLIMB + 1), dtype=np.float64)
    for half in (0, 1):
        for i in range(NLIMB):
            for j in range(NLIMB):
                col = i + j + half
                m[half, i * NLIMB + j, col % NLIMB] += 38 if col >= NLIMB else 1
    m = torch.from_numpy(m).to(device)
    return m[0], m[1]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular multiply: limb outer product, folded columns by exact
    float64 matmuls (every column is below 2^27), carries. Output 16-bit
    limbs, value < 2^256 (lazily reduced — see canonicalize)."""
    prod = a[..., :, None] * b[..., None, :]        # (..., 16, 16) < 2^32
    m_lo, m_hi = _column_matrices(a.device)
    folded = (torch.matmul((prod & M16).flatten(-2).to(torch.float64), m_lo)
              + torch.matmul((prod >> 16).flatten(-2).to(torch.float64), m_hi))
    return _fold_carry(_carry(folded.to(torch.int64)))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a constant; limb-scale path for k < 2^15."""
    if k >= (1 << 15):
        return mul(a, const(a.shape[:-1], k, a.device))
    return _fold_carry(_carry(_limbs_carry(a * k)))


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    """a^(2^k) — k squarings."""
    for _ in range(k):
        a = square(a)
    return a


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) via the standard curve25519 addition chain."""
    x1 = a
    x2 = mul(pow2k(x1, 1), x1)            # 2^2 - 1
    x4 = mul(pow2k(x2, 2), x2)            # 2^4 - 1
    x8 = mul(pow2k(x4, 4), x4)            # 2^8 - 1
    x16 = mul(pow2k(x8, 8), x8)           # 2^16 - 1
    x32 = mul(pow2k(x16, 16), x16)        # 2^32 - 1
    x64 = mul(pow2k(x32, 32), x32)        # 2^64 - 1
    x128 = mul(pow2k(x64, 64), x64)       # 2^128 - 1
    x250 = x128
    x250 = mul(pow2k(x250, 64), x64)      # 2^192 - 1
    x250 = mul(pow2k(x250, 32), x32)      # 2^224 - 1
    x250 = mul(pow2k(x250, 16), x16)      # 2^240 - 1
    x250 = mul(pow2k(x250, 8), x8)        # 2^248 - 1
    x250 = mul(pow2k(x250, 2), x2)        # 2^250 - 1
    # (2^250 - 1) * 2^5 + 11 = 2^255 - 21
    return mul(pow2k(x250, 5), _small_pow(a, 11))


def _small_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    result = const(a.shape[:-1], 1, a.device)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        base = square(base)
        e >>= 1
    return result


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3) — the Ed25519 decompression root."""
    x1 = a
    x2 = mul(pow2k(x1, 1), x1)
    x4 = mul(pow2k(x2, 2), x2)
    x8 = mul(pow2k(x4, 4), x4)
    x16 = mul(pow2k(x8, 8), x8)
    x32 = mul(pow2k(x16, 16), x16)
    x64 = mul(pow2k(x32, 32), x32)
    x128 = mul(pow2k(x64, 64), x64)
    x250 = mul(pow2k(x128, 64), x64)
    x250 = mul(pow2k(x250, 32), x32)
    x250 = mul(pow2k(x250, 16), x16)
    x250 = mul(pow2k(x250, 8), x8)
    x250 = mul(pow2k(x250, 2), x2)        # 2^250 - 1
    # (2^250 - 1) * 4 + 1 = 2^252 - 3
    return mul(pow2k(x250, 2), x1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality mod p (canonicalizes both sides: values are lazily reduced)."""
    return torch.all(canonicalize(a) == canonicalize(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonicalize(a) == 0, dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], a, b)
