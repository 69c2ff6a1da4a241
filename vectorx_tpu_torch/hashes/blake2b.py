"""Batched variable-length Blake2b-256 as torch ops on int64 words.

Blake2b-256 is the Avail header hash: every SCALE-encoded header is hashed
over a buffer zero-padded to MAX_HEADER_SIZE = 280 chunks x 128 bytes.
Bit-exactness with the chain is mandatory: header hashes feed the public
outputs.

A 64-bit word is one int64 holding its bit pattern (as in
``hashes/sha512.py``): ``+`` wraps mod 2^64, a logical right shift is the
arithmetic one followed by a mask. The state is four rows of four words,
so a round is two vectorised G steps — on the columns, then on the
diagonals (rows 1..3 rotated by 1..3) — and the twelve rounds' message
permutations are one gather per chunk. Variable length is handled as the
JAX package handles it: every one of the buffer's chunks is compressed,
and chunks past the message keep the previous state.

``blake2b256_variable`` keeps the JAX signature ((lo, hi) uint32 planes in
and out); ``blake2b256_words`` is the same hash on int64 words, which
callers holding bytes use (a little-endian byte buffer *is* its words).

Caller contract: bytes at positions >= length must be zero.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import default_device

M32 = 0xFFFFFFFF

_IV = np.array([
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179], dtype=np.uint64)

_SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0]], dtype=np.int64)

N_ROUNDS = 12
DIGEST_BYTES = 32
CHUNK_BYTES = 128
# parameter block word 0: digest_length=32, fanout=1, depth=1
_PARAM0 = 0x01010020


@lru_cache(maxsize=None)
def _consts(device: torch.device):
    """-> (IV (8,), the initial state (8,), the message gather (12 * 16,)).

    Per round the gather lists the words of the column step's x and y,
    then the diagonal step's x and y, four each."""
    iv = torch.from_numpy(_IV.view(np.int64).copy()).to(device)
    h0 = iv.clone()
    h0[0] ^= _PARAM0
    order = []
    for r in range(N_ROUNDS):
        s = _SIGMA[r % 10]
        order += list(s[0:8:2]) + list(s[1:8:2]) + list(s[8::2]) + list(s[9::2])
    return iv, h0, torch.tensor(order, dtype=torch.int64, device=device)


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) & ((1 << (64 - r)) - 1)) | (x << (64 - r))


def _g(a, b, c, d, x, y):
    a = a + b + x
    d = _rotr(d ^ a, 32)
    c = c + d
    b = _rotr(b ^ c, 24)
    a = a + b + y
    d = _rotr(d ^ a, 16)
    c = c + d
    b = _rotr(b ^ c, 63)
    return a, b, c, d


def compress(h: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
             last: torch.Tensor) -> torch.Tensor:
    """One Blake2b compression on int64 words.

    h: (..., 8) state; m: (..., 16) message words; t: (...,) byte counter
    (< 2^63); last: (...,) bool — applies the final-block flag.
    """
    iv, _, order = _consts(h.device)
    zero = torch.zeros_like(t)
    a, b = h[..., :4], h[..., 4:]
    c = iv[:4].expand(a.shape)
    d = iv[4:] ^ torch.stack([t, zero, -last.to(torch.int64), zero], dim=-1)
    ms = m[..., order].unflatten(-1, (N_ROUNDS, 4, 4))
    for r in range(N_ROUNDS):
        a, b, c, d = _g(a, b, c, d, ms[..., r, 0, :], ms[..., r, 1, :])
        a, b, c, d = _g(a, torch.roll(b, -1, -1), torch.roll(c, -2, -1),
                        torch.roll(d, -3, -1), ms[..., r, 2, :],
                        ms[..., r, 3, :])
        b, c, d = (torch.roll(b, 1, -1), torch.roll(c, 2, -1),
                   torch.roll(d, 3, -1))
    return h ^ torch.cat([a, b], dim=-1) ^ torch.cat([c, d], dim=-1)


def blake2b256_words(m: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Variable-length Blake2b-256 over a zero-padded buffer of words.

    m: (..., max_chunks, 16) int64 LE message words; length: (...,) message
    byte lengths (bytes >= length are 0). Returns (..., 4) int64 digest
    words: h[0..3], the 32 digest bytes little-endian.
    """
    max_chunks = m.shape[-2]
    length = length.to(torch.int64)
    _, h0, _ = _consts(m.device)
    h = h0.expand(m.shape[:-2] + (8,))
    # number of chunks: max(1, ceil(length / 128))
    n_chunks = torch.clamp((length + CHUNK_BYTES - 1) // CHUNK_BYTES, min=1)
    for i in range(max_chunks):
        is_last = n_chunks == i + 1
        # bytes processed through this block; for the last block, = length
        t = torch.where(is_last, length,
                        torch.full_like(length, (i + 1) * CHUNK_BYTES))
        new = compress(h, m[..., i, :], t, is_last)
        h = torch.where((n_chunks > i)[..., None], new, h)
    return h[..., :4]


def blake2b256_variable(m_lo: torch.Tensor, m_hi: torch.Tensor,
                        length: torch.Tensor):
    """The JAX package's signature: m_lo/m_hi (..., max_chunks, 16) uint32
    planes of the LE u64 message words (any integer dtype, values below
    2^32); length (...,). Returns the digest planes (d_lo, d_hi), (..., 4)
    int64 values below 2^32."""
    d = blake2b256_words(m_lo.to(torch.int64) | (m_hi.to(torch.int64) << 32),
                         length)
    return d & M32, (d >> 32) & M32


# ---------------------------------------------------------------------------
# Host-side packing helpers
# ---------------------------------------------------------------------------

def pack_message(msg: bytes, max_chunks: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """bytes -> zero-padded (max_chunks, 16) LE u64 planes + length."""
    assert len(msg) <= max_chunks * CHUNK_BYTES
    buf = msg + b"\x00" * (max_chunks * CHUNK_BYTES - len(msg))
    words = np.frombuffer(buf, dtype="<u8").reshape(max_chunks, 16)
    return ((words & np.uint64(M32)).astype(np.uint32),
            (words >> np.uint64(32)).astype(np.uint32),
            len(msg))


def digest_to_bytes(d_lo, d_hi) -> bytes:
    """(4,) planes -> 32-byte digest (little-endian words)."""
    out = b""
    for i in range(4):
        out += int(d_lo[i]).to_bytes(4, "little")
        out += int(d_hi[i]).to_bytes(4, "little")
    return out


def words_to_bytes(d: torch.Tensor) -> torch.Tensor:
    """(..., k) int64 words -> (..., 8 k) uint8, little-endian."""
    return d.contiguous().view(torch.uint8)


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 8 k) uint8 -> (..., k) int64 LE words (a view)."""
    return b.contiguous().view(torch.int64)


def blake2b256_bytes(messages, max_chunks: int, device=None) -> list:
    """Byte strings -> their 32-byte digests, hashed as one batch on the
    current CUDA device unless ``device`` names another."""
    buf = np.zeros((len(messages), max_chunks * CHUNK_BYTES), np.uint8)
    for i, msg in enumerate(messages):
        assert len(msg) <= max_chunks * CHUNK_BYTES
        buf[i, :len(msg)] = np.frombuffer(msg, np.uint8)
    dev = default_device(device)
    m = bytes_to_words(torch.from_numpy(buf).to(dev)).unflatten(-1, (max_chunks, 16))
    lengths = torch.tensor([len(msg) for msg in messages], device=dev)
    digests = words_to_bytes(blake2b256_words(m, lengths)).cpu().numpy()
    return [row.tobytes() for row in digests]
