"""Public-input commitments — bit-exact parity with the VectorX chain.

Three SHA-256-based commitments fix the on-chain ABI:

1. **Chained authority-set hash**: h_i = sha256(h_{i-1} || pubkey_i), h_{-1}
   empty (VectorX's `compute_authority_set_commitment`).
2. **Simple Merkle root**: unhashed 32-byte leaves zero-padded to a power of
   two, SHA-256 internal nodes (`get_root_from_hashed_leaves`).
3. **state/data root range commitments**: the simple Merkle roots over the
   per-block state/data roots of (trusted, target], padded with zero leaves
   to the tree size.

Host versions (hashlib, exact) for witness/oracle; vectorized versions (the
batched SHA-256 of hashes/sha256.py, on the device of their inputs) for
on-device trace generation. Both must agree bit for bit.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch

from .. import default_device
from ..hashes import sha256 as s2


# ---------------------------------------------------------------------------
# Host-side (exact)
# ---------------------------------------------------------------------------

def authority_set_hash(pubkeys: Sequence[bytes]) -> bytes:
    """Chained SHA-256 over 32-byte Ed25519 pubkeys."""
    h = b""
    for pk in pubkeys:
        assert len(pk) == 32
        h = hashlib.sha256(h + pk).digest()
    return h


def simple_merkle_root(leaves: Sequence[bytes]) -> bytes:
    """VectorX simple Merkle root: zero-pad to pow2, unhashed leaves."""
    if not leaves:
        return b""
    nodes: List[bytes] = [bytes(l) for l in leaves]
    assert all(len(l) == 32 for l in nodes)
    while len(nodes) & (len(nodes) - 1):
        nodes.append(b"\x00" * 32)
    while len(nodes) > 1:
        nodes = [hashlib.sha256(nodes[2 * i] + nodes[2 * i + 1]).digest()
                 for i in range(len(nodes) // 2)]
    return nodes[0]


def range_commitments(state_roots: Sequence[bytes], data_roots: Sequence[bytes],
                      tree_size: int) -> tuple:
    """(state_root_commitment, data_root_commitment) for (trusted, target].

    Roots are for blocks trusted+1..=target, zero-padded to tree_size.
    """
    assert tree_size & (tree_size - 1) == 0
    assert len(state_roots) == len(data_roots) <= tree_size
    pad = [b"\x00" * 32] * (tree_size - len(state_roots))
    return (simple_merkle_root(list(state_roots) + pad),
            simple_merkle_root(list(data_roots) + pad))


# ---------------------------------------------------------------------------
# Vectorized (on the device of the inputs)
# ---------------------------------------------------------------------------

def _bytes32_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 8) BE words (int64)."""
    r = b.to(torch.int64).reshape(b.shape[:-1] + (8, 4))
    return (r[..., 0] << 24) | (r[..., 1] << 16) | (r[..., 2] << 8) | r[..., 3]


def _words_to_bytes32(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) BE words -> (..., 32) uint8."""
    parts = [((w >> s) & 0xFF).to(torch.uint8) for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=-1).reshape(w.shape[:-1] + (32,))


# The second block of a 64-byte message (0x80 marker, bit length 512) is
# the same for every message: its schedule is computed once, on the host.
_PAD_64B_SCHEDULE = s2.schedule([0x80000000] + [0] * 14 + [512])


def sha256_pair_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """sha256(left || right) on (..., 8)-word inputs -> (..., 8) words."""
    block0 = torch.cat([left, right], dim=-1)
    state = s2.compress(s2._h0(block0[..., None, :]), block0)
    return s2.compress_scheduled(state, _PAD_64B_SCHEDULE)


def simple_merkle_root_vec(leaves: torch.Tensor) -> torch.Tensor:
    """(n, 8)-word leaves (n a power of two) -> (8,) root words.

    One batched SHA-256 per level — the whole level hashes in parallel.
    """
    nodes = leaves
    while nodes.shape[0] > 1:
        nodes = sha256_pair_words(nodes[0::2], nodes[1::2])
    return nodes[0]


def authority_set_hash_vec(pubkeys: torch.Tensor, num_active) -> torch.Tensor:
    """Chained authority-set hash with active masking.

    pubkeys: (n, 32) uint8; num_active: an int or a 0-d integer tensor —
    only the first num_active keys contribute (the select-masking of
    `compute_authority_set_commitment`). Returns (8,) digest words (the
    hash after num_active steps; zeros for an empty chain).
    """
    pk_words = _bytes32_to_words(pubkeys)  # (n, 8)
    num_active = torch.as_tensor(num_active, device=pubkeys.device)

    # step 0: sha256(pk_0) — a 32-byte message (1 block)
    blk = torch.zeros(16, dtype=torch.int64, device=pubkeys.device)
    blk[:8] = pk_words[0]
    blk[8] = 0x80000000
    blk[15] = 256
    h = s2.sha256_blocks(blk[None, :])  # (8,)

    for i in range(1, pubkeys.shape[0]):
        h = torch.where(i < num_active, sha256_pair_words(h, pk_words[i]), h)
    return torch.where(num_active > 0, h, torch.zeros_like(h))


def range_commitments_on(state_roots: Sequence[bytes],
                         data_roots: Sequence[bytes], tree_size: int,
                         device=None) -> tuple:
    """``range_commitments`` on the current CUDA device unless ``device``
    names another: both trees as batched SHA-256 levels."""
    if (tree_size & (tree_size - 1) or len(state_roots) != len(data_roots)
            or len(state_roots) > tree_size):
        raise ValueError("need as many state as data roots, at most "
                         "tree_size, a power of two")
    leaves = np.zeros((2, tree_size, 32), np.uint8)
    for tree, roots in zip(leaves, (state_roots, data_roots)):
        for i, root in enumerate(roots):
            tree[i] = np.frombuffer(root, np.uint8)
    words = _bytes32_to_words(torch.from_numpy(leaves).to(default_device(device)))
    return tuple(bytes(_words_to_bytes32(simple_merkle_root_vec(w)).cpu().numpy())
                 for w in words)
