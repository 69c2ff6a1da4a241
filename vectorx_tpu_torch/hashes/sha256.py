"""Batched SHA-256 as torch ops — bit-exact with hashlib.

SHA-256 fixes VectorX's *public* commitments: the chained authority-set
hash and the simple Merkle root over state/data roots
(circuits/commitments.py). The batch axes are the parallel dimension (hash
many messages at once — all Merkle-tree nodes of one level, say).

Layout: a 32-bit word is one int64 in [0, 2^32); messages are big-endian
words of shape (..., n_blocks, 16), a digest is (..., 8) words. Static block
counts; variable length within a padded buffer via ``sha256_variable``
masking. Functions that take tensors work on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device

M32 = 0xFFFFFFFF

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.int64)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.int64)



def _big_sigma(x, r1: int, r2: int, r3: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3): each rotation of a 32-bit
    word is a shift of the word doubled into 64 bits."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (xx >> r3)) & M32


def _small_sigma(x, r1: int, r2: int, s: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s)."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (x >> s)) & M32


def schedule(block) -> list:
    """The 64 message-schedule words of a block (..., 16) BE words; works
    on tensors and on a list of Python ints alike."""
    w = list(block.unbind(-1)) if isinstance(block, torch.Tensor) else list(block)
    for i in range(16, 64):
        w.append((w[i - 16] + _small_sigma(w[i - 15], 7, 18, 3) + w[i - 7]
                  + _small_sigma(w[i - 2], 17, 19, 10)) & M32)
    return w


def compress_scheduled(state: torch.Tensor, w) -> torch.Tensor:
    """One compression from the 64 schedule words ``w`` (tensors or ints):
    state (..., 8) -> (..., 8)."""
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for i in range(64):
        ch = g ^ (e & (f ^ g))
        t1 = h + _big_sigma(e, 6, 11, 25) + ch + int(_K[i]) + w[i]
        maj = (a & b) ^ (c & (a ^ b))
        a, b, c, d, e, f, g, h = (
            (t1 + _big_sigma(a, 2, 13, 22) + maj) & M32, a, b, c,
            (d + t1) & M32, e, f, g)
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)) & M32


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression: state (..., 8), block (..., 16) BE words -> (..., 8)."""
    return compress_scheduled(state, schedule(block))


def _h0(blocks: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_H0).to(blocks.device).expand(
        blocks.shape[:-2] + (8,))


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Fully-padded messages: (..., n_blocks, 16) BE words -> (..., 8) digest."""
    state = _h0(blocks)
    for i in range(blocks.shape[-2]):
        state = compress(state, blocks[..., i, :])
    return state


def sha256_variable(blocks: torch.Tensor,
                    n_active_blocks: torch.Tensor) -> torch.Tensor:
    """Variable block count within a padded buffer, via masking.

    blocks: (..., MAX_BLOCKS, 16) — the caller places the SHA padding inside
    the active region (block n_active-1). n_active_blocks: (...,) integers.
    """
    state = _h0(blocks)
    for i in range(blocks.shape[-2]):
        new = compress(state, blocks[..., i, :])
        state = torch.where((i < n_active_blocks)[..., None], new, state)
    return state


# ---------------------------------------------------------------------------
# Host-side packing helpers
# ---------------------------------------------------------------------------

def pad_message(msg: bytes) -> np.ndarray:
    """Standard SHA-256 padding -> (n_blocks, 16) int64 BE words."""
    ml = len(msg) * 8
    data = msg + b"\x80"
    data += b"\x00" * ((-(len(data) + 8)) % 64)
    data += ml.to_bytes(8, "big")
    return np.frombuffer(data, dtype=">u4").astype(np.int64).reshape(-1, 16)


def digest_to_bytes(digest_words) -> bytes:
    """(8,) words -> 32-byte digest."""
    return b"".join(int(w).to_bytes(4, "big") for w in np.asarray(digest_words))


def sha256_bytes(messages, device=None) -> np.ndarray:
    """Convenience: equal-length byte strings -> (n, 32) uint8 digests,
    hashed on the current CUDA device unless ``device`` names another."""
    blocks = torch.from_numpy(np.stack([pad_message(m) for m in messages]))
    out = sha256_blocks(blocks.to(default_device(device))).cpu().numpy()
    return np.stack([np.frombuffer(digest_to_bytes(row), dtype=np.uint8)
                     for row in out])
