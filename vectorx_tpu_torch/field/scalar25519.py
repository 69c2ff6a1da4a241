"""Ed25519 scalar field (mod L) — sc_reduce on the device.

L = 2^252 + 27742317777372353535851937790883648493 (the base point's
order). The EdDSA challenge h = SHA-512(R || A || M) mod L reduces on the
device: 261 rounds of compare-and-subtract against the table of L << k,
k = 260 .. 0, batched over signatures.

Layout: 16-bit limbs in int64 tensors, 33 limbs per 513-bit working value
(the field25519 conventions). A round's subtraction is (x + 2^528 - t) mod
2^528 with parallel carries: where x >= t (the only rounds whose result is
kept) it is the borrow chain's x - t.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .field25519 import _carry, _ge, _limbs_carry, int_limbs

L_ORDER = (1 << 252) + 27742317777372353535851937790883648493
NLIMB = 33          # 33 * 16 = 528 bits of headroom
N_ROUNDS = 261      # 512 - 252 + 1 rounds cover any 512-bit input


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """-> ((N_ROUNDS, 33) limbs of L << k, descending k; the same rows'
    2^528 complements)."""
    shifted = [L_ORDER << (N_ROUNDS - 1 - r) for r in range(N_ROUNDS)]
    table = torch.tensor([int_limbs(v, NLIMB) for v in shifted],
                         dtype=torch.int64, device=device)
    comp = torch.tensor([int_limbs((1 << (16 * NLIMB)) - v, NLIMB)
                         for v in shifted], dtype=torch.int64, device=device)
    return table, comp


def sc_reduce_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., 33) 16-bit limbs -> (..., 33) limbs of x mod L."""
    table, comp = _tables(x.device)
    for r in range(N_ROUNDS):
        ge = _ge(x, table[r])
        x = torch.where(ge[..., None],
                        _carry(_limbs_carry(x + comp[r]))[..., :NLIMB], x)
    return x


def bytes_to_limbs512(b: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 little-endian -> (..., 33) 16-bit limbs."""
    b = b.to(torch.int64)
    limbs = b[..., 0::2] | (b[..., 1::2] << 8)          # (..., 32)
    return torch.cat([limbs, torch.zeros_like(limbs[..., :1])], dim=-1)


def limbs_to_bytes32(l: torch.Tensor) -> torch.Tensor:
    """(..., 33) limbs (value < 2^256) -> (..., 32) uint8 LE."""
    l16 = l[..., :16]
    return torch.stack([l16 & 0xFF, (l16 >> 8) & 0xFF], dim=-1).reshape(
        l.shape[:-1] + (32,)).to(torch.uint8)


def sc_reduce512(digests: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 SHA-512 digests -> (..., 32) uint8 LE of (d mod L)."""
    return limbs_to_bytes32(sc_reduce_limbs(bytes_to_limbs512(digests)))
