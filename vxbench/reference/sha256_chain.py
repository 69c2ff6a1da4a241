"""The authority-set commitment as VectorX states it: SHA-256 chained over
the 32-byte keys, h_0 = SHA-256(k_0), h_i = SHA-256(h_(i-1) | k_i), over
the active keys. The chain statement's public values are the number of
active keys and the eight big-endian 32-bit words of the last hash
(zeros for no key).

The statement's constant columns are the schedule of its proof: one
SHA-256 compression a block of 128 rows, hash 0 in block 0, hash i >= 1
in blocks 2i - 1 (its key) and 2i (the padding block), empty blocks after
the last real one up to a power of two of blocks (at least one).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

BLOCK_ROWS = 128


def chain_hash(keys: Sequence[bytes]) -> bytes:
    h = b""
    for k in keys:
        if len(k) != 32:
            raise ValueError("a key is 32 bytes")
        h = hashlib.sha256(h + k).digest()
    return h


def chain_publics(keys: Sequence[bytes], n_active: int) -> List[int]:
    d = chain_hash(keys[:n_active]) if n_active else bytes(32)
    return [n_active] + [int.from_bytes(d[4 * i:4 * i + 4], "big")
                         for i in range(8)]


def _icbrt(x: int) -> int:
    r = 1 << -(-x.bit_length() // 3)
    while True:
        s = (2 * r + x // (r * r)) // 3
        if s >= r:
            break
        r = s
    while r ** 3 > x:
        r -= 1
    return r


def round_constants() -> List[int]:
    """SHA-256's K: the first 32 bits of the fractional parts of the cube
    roots of the first 64 primes (FIPS 180-4, 4.2.2)."""
    primes, c = [], 2
    while len(primes) < 64:
        if all(c % p for p in primes):
            primes.append(c)
        c += 1
    return [_icbrt(p << 96) & 0xFFFFFFFF for p in primes]


def constant_columns(n_max: int) -> np.ndarray:
    """The ten schedule columns of a chain of at most ``n_max`` keys, one
    row a trace row: K of the round, the round and message-schedule
    selectors (rows 0-63, 0-47 of a block), and at each block's last row
    B_LAST, B_CONT (the next block pads the same hash), B_CHAIN (the next
    block starts hash i >= 1), B_START (it starts a hash or an empty
    block), B_FINAL (this block ends a real hash); then NOT_LAST = 1 -
    B_LAST and COPY_SEL = (1 - round) NOT_LAST."""
    blocks = 1 << (2 * n_max - 1).bit_length()
    last_real = 2 * (n_max - 1)
    n = blocks * BLOCK_ROWS
    row = np.arange(n) % BLOCK_ROWS
    out = np.zeros((10, n), dtype=np.uint64)
    out[0] = np.array(round_constants() + [0] * 64, dtype=np.uint64)[row]
    out[1] = row < 64
    out[2] = row < 48
    out[3] = row == BLOCK_ROWS - 1
    for b in range(blocks):
        end, nxt = (b + 1) * BLOCK_ROWS - 1, b + 1
        if nxt < blocks:
            out[4, end] = nxt <= last_real and nxt % 2 == 0
            out[5, end] = nxt <= last_real and nxt % 2 == 1
            out[6, end] = nxt > last_real or nxt % 2 == 1
        out[7, end] = b == 0 or (b <= last_real and b % 2 == 0)
    out[8] = 1 - out[3]
    out[9] = (1 - out[1]) * out[8]
    return out
