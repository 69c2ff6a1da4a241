"""Radix-2 NTT / coset LDE over Goldilocks in torch ops.

The size-N transform is log2(N) butterfly stages over the last axis; batch
axes lead. Decimation in time on bit-reversed input:

    view (..., N) as (..., N/m, m); halves u, v of width m/2;
    out = [u + w*v, u - w*v]  with per-stage twiddles w (host-precomputed).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..field import goldilocks as gl

P = gl.MODULUS


# ---------------------------------------------------------------------------
# Host-side precomputation
# ---------------------------------------------------------------------------

def _powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ...] (n terms) as uint64."""
    out = np.empty(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = (acc * base) % P
    return out


def _i64(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64)


@lru_cache(maxsize=None)
def _bit_reverse_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool) -> Tuple[np.ndarray, ...]:
    """Per-stage twiddle factors w_m^j, j in [0, m/2), as uint64."""
    root = gl.primitive_root_of_unity(log_n)
    if inverse:
        root = pow(root, P - 2, P)
    return tuple(_powers(pow(root, (1 << log_n) >> s, P), 1 << (s - 1))
                 for s in range(1, log_n + 1))


@lru_cache(maxsize=None)
def _n_inv(log_n: int) -> int:
    return pow(1 << log_n, P - 2, P)


@lru_cache(maxsize=32)
def _device_tables(log_n: int, inverse: bool, device: torch.device):
    perm = torch.from_numpy(_bit_reverse_perm(log_n)).to(device)
    tws = [torch.from_numpy(_i64(t)).to(device)
           for t in _stage_twiddles(log_n, inverse)]
    return perm, tws


# ---------------------------------------------------------------------------
# Core transforms
# ---------------------------------------------------------------------------

def ntt(x: gl.Fp, inverse: bool = False) -> gl.Fp:
    """In-order forward (or inverse) NTT over the last axis; N = 2^k."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if n == 1:
        return x
    perm, tws = _device_tables(log_n, inverse, x.device)
    y = x.index_select(-1, perm)
    lead = y.shape[:-1]
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        y = y.reshape(lead + (n // m, m))
        u = y[..., :half]
        t = gl.mul(y[..., half:], tws[s - 1])
        y = torch.cat([gl.add(u, t), gl.sub(u, t)], dim=-1).reshape(lead + (n,))
    if inverse:
        y = gl.mul(y, gl.full((), _n_inv(log_n), y.device))
    return y


def intt(x: gl.Fp) -> gl.Fp:
    return ntt(x, inverse=True)


# ---------------------------------------------------------------------------
# Polynomial utilities
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _shift_powers(n: int, shift: int) -> np.ndarray:
    return _powers(shift % P, n)


def _scale_by_powers(coeffs: gl.Fp, shift: int) -> gl.Fp:
    """coefficient i times shift^i."""
    sp = _shift_powers(coeffs.shape[-1], shift % P)
    return gl.mul(coeffs, torch.from_numpy(_i64(sp)).to(coeffs.device))


def coeffs_to_coset_evals(coeffs: gl.Fp, rate_bits: int,
                          shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> gl.Fp:
    """(..., N) coefficients -> evals on the blown-up coset shift*H_{N<<rate}."""
    n = coeffs.shape[-1]
    scaled = _scale_by_powers(coeffs, shift)
    return ntt(torch.nn.functional.pad(scaled, (0, (n << rate_bits) - n)))


def coset_lde(evals: gl.Fp, rate_bits: int,
              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> gl.Fp:
    """Low-degree extend size-N subgroup evals onto the size-N*2^rate coset
    shift * H': (..., N) -> (..., N << rate_bits)."""
    return coeffs_to_coset_evals(intt(evals), rate_bits, shift)


def coset_intt(evals: gl.Fp, shift: int) -> gl.Fp:
    """Coefficients of the poly whose evals on shift*H are given. (..., N)."""
    return _scale_by_powers(intt(evals), pow(shift % P, P - 2, P))


# ---------------------------------------------------------------------------
# Column tiles
# ---------------------------------------------------------------------------
# A batch of transforms too wide for the device goes through a block of
# columns at a time; field arithmetic is exact, so every block size gives
# the whole pass's values.

#: int64 temporaries per output element of ``coset_lde`` at its peak (an
#: estimate from the torch Goldilocks ops: a product builds ~8)
LDE_TEMPS = 16
#: the CPU's working set for a tiled pass
CPU_WORK_BYTES = 1 << 30


def work_bytes(device: torch.device) -> int:
    """Bytes a tiled pass may hold at once: a quarter of the card's free
    memory (what stays resident lies outside it), or a fixed 1 GiB on the
    CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(free // 4, 64 << 20)
    return CPU_WORK_BYTES


def col_tile(n_cols: int, n: int, temps: int, device: torch.device) -> int:
    """Columns of length ``n`` a pass with ``temps`` int64 temporaries per
    element takes at once (at least 1)."""
    return max(1, min(n_cols, work_bytes(device) // (8 * temps * n)))
