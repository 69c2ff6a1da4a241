"""Batched SHA-512 as torch ops on int64 bit patterns — bit-exact with
hashlib.

Needed for Ed25519: the EdDSA challenge is H = SHA-512(R || A || M). A
64-bit word is one int64 holding its bit pattern, as the field code holds a
Goldilocks element: ``+`` wraps mod 2^64, and a logical right shift is the
arithmetic one followed by a mask.

Layout: message blocks (..., n_blocks, 16) BE u64 words; digest (..., 8)
words. Functions that take tensors work on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device

_K = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f, 0xe9b5dba58189dbbc,
    0x3956c25bf348b538, 0x59f111f1b605d019, 0x923f82a4af194f9b, 0xab1c5ed5da6d8118,
    0xd807aa98a3030242, 0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235, 0xc19bf174cf692694,
    0xe49b69c19ef14ad2, 0xefbe4786384f25e3, 0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65,
    0x2de92c6f592b0275, 0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f, 0xbf597fc7beef0ee4,
    0xc6e00bf33da88fc2, 0xd5a79147930aa725, 0x06ca6351e003826f, 0x142929670a0e6e70,
    0x27b70a8546d22ffc, 0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6, 0x92722c851482353b,
    0xa2bfe8a14cf10364, 0xa81a664bbc423001, 0xc24b8b70d0f89791, 0xc76c51a30654be30,
    0xd192e819d6ef5218, 0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99, 0x34b0bcb5e19b48a8,
    0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb, 0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3,
    0x748f82ee5defb2fc, 0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915, 0xc67178f2e372532b,
    0xca273eceea26619c, 0xd186b8c721c0c207, 0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178,
    0x06f067aa72176fba, 0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc, 0x431d67c49c100d4c,
    0x4cc5d4becb3e42b6, 0x597f299cfc657e2a, 0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]

_H0 = [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b, 0xa54ff53a5f1d36f1,
    0x510e527fade682d1, 0x9b05688c2b3e6c1f, 0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
]


def _i64(words) -> np.ndarray:
    return np.array(words, dtype=np.uint64).view(np.int64)


_K_I64 = [int(k) for k in _i64(_K)]


def _shr(x, r: int):
    """Logical x >> r on a 64-bit pattern."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotr(x, r: int):
    return _shr(x, r) | (x << (64 - r))


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """state (..., 8), block (..., 16) words -> (..., 8)."""
    w = list(block.unbind(-1))
    for i in range(16, 80):
        wm15, wm2 = w[i - 15], w[i - 2]
        s0 = _rotr(wm15, 1) ^ _rotr(wm15, 8) ^ _shr(wm15, 7)
        s1 = _rotr(wm2, 19) ^ _rotr(wm2, 61) ^ _shr(wm2, 6)
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for i in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K_I64[i] + w[i]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + s0 + maj, a, b, c, d + t1, e, f, g
    return state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)


def _h0(blocks: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_i64(_H0)).to(blocks.device).expand(
        blocks.shape[:-2] + (8,))


def sha512_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Fully-padded: (..., n_blocks, 16) words -> (..., 8) digest words."""
    state = _h0(blocks)
    for i in range(blocks.shape[-2]):
        state = compress(state, blocks[..., i, :])
    return state


def sha512_variable(blocks: torch.Tensor,
                    n_active_blocks: torch.Tensor) -> torch.Tensor:
    """Variable block count in a padded buffer (padding pre-placed by the
    caller inside the active region)."""
    state = _h0(blocks)
    for i in range(blocks.shape[-2]):
        new = compress(state, blocks[..., i, :])
        state = torch.where((i < n_active_blocks)[..., None], new, state)
    return state


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

def pad_message(msg: bytes) -> np.ndarray:
    """SHA-512 padding -> (n_blocks, 16) int64 bit patterns of BE u64 words."""
    ml = len(msg) * 8
    data = msg + b"\x80"
    data += b"\x00" * ((-(len(data) + 16)) % 128)
    data += ml.to_bytes(16, "big")
    return (np.frombuffer(data, dtype=">u8").astype(np.uint64)
            .view(np.int64).reshape(-1, 16))


def digest_to_bytes(digest_words) -> bytes:
    """(8,) int64 bit patterns -> 64-byte digest."""
    return b"".join((int(w) & ((1 << 64) - 1)).to_bytes(8, "big")
                    for w in np.asarray(digest_words))


def sha512_bytes(messages, device=None) -> list:
    """Byte strings of any lengths -> their 64-byte digests, hashed as one
    batch on the current CUDA device unless ``device`` names another."""
    packed = [pad_message(m) for m in messages]
    nb = max(p.shape[0] for p in packed)
    blocks = np.zeros((len(messages), nb, 16), np.int64)
    for i, p in enumerate(packed):
        blocks[i, :p.shape[0]] = p
    counts = torch.tensor([p.shape[0] for p in packed])
    dev = default_device(device)
    out = sha512_variable(torch.from_numpy(blocks).to(dev), counts.to(dev))
    return [digest_to_bytes(row) for row in out.cpu().numpy()]
