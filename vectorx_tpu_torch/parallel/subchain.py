"""Header-subchain verification — the witness-level data path, one device.

VectorX's ``verify_subchain`` semantics:

  map:    per header — Blake2b-256 of the SCALE bytes, decode {block
          number, parent hash, state root, data root}, check hash/parent
          adjacency, mask padding ("noop") headers;
  reduce: the state/data Merkle roots over the range;
  final:  the endpoints (trusted block/hash, target block/hash).

The adjacency check is one ``torch.roll`` over the header axis. Sharding
the header axis over several cards waits for the port of ``parallel/`` on
``torch.distributed``; this module holds the single-device functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..circuits import scale
from ..circuits.commitments import _bytes32_to_words, sha256_pair_words
from ..hashes import blake2b as b2

M32 = 0xFFFFFFFF


class SubchainResult(NamedTuple):
    target_hash_words: torch.Tensor  # (8,) — Blake2b-256 of the last active header (BE words of the LE digest bytes)
    state_root_words: torch.Tensor   # (8,) — simple Merkle root (BE words)
    data_root_words: torch.Tensor    # (8,)
    links_ok: torch.Tensor           # () bool — hash-chain adjacency holds
    blocks_sequential: torch.Tensor  # () bool — block numbers increment by 1


def _digest_planes_to_bytes32(d_lo: torch.Tensor,
                              d_hi: torch.Tensor) -> torch.Tensor:
    """Blake2b digest planes (..., 4) -> (..., 32) uint8 (LE per u64 word)."""
    return b2.words_to_bytes((d_lo & M32) | (d_hi << 32))


def hash_headers(header_bytes: torch.Tensor,
                 header_sizes: torch.Tensor) -> torch.Tensor:
    """(n, S) uint8 zero-padded headers, (n,) sizes -> (n, 32) uint8
    Blake2b-256 digests, every chunk of S compressed (S % 128 == 0)."""
    n, size = header_bytes.shape
    assert size % b2.CHUNK_BYTES == 0
    words = b2.bytes_to_words(header_bytes).reshape(
        n, size // b2.CHUNK_BYTES, 16)
    return b2.words_to_bytes(b2.blake2b256_words(words, header_sizes))


def verify_subchain(header_bytes: torch.Tensor, header_sizes: torch.Tensor,
                    num_active, trusted_hash: torch.Tensor,
                    trusted_block) -> SubchainResult:
    """Verify the chain and compute the range commitments, batched.

    header_bytes: (n, S) uint8 zero-padded SCALE headers; header_sizes:
    (n,) (0: a padding slot); num_active: the headers trusted+1..=target;
    trusted_hash: (32,) uint8; trusted_block: a u32. Scalars are ints or
    0-d tensors.
    """
    n = header_bytes.shape[0]
    dev = header_bytes.device
    num_active = torch.as_tensor(num_active, dtype=torch.int64, device=dev)
    trusted_block = torch.as_tensor(trusted_block, dtype=torch.int64,
                                    device=dev) & M32

    hashes = hash_headers(header_bytes, header_sizes)           # (n, 32)
    decoded = scale.decode_header_vec(header_bytes, header_sizes)

    idx = torch.arange(n, device=dev)
    active = idx < num_active

    # adjacency: parent_hash[i] == hash[i-1]
    prev_hash = torch.roll(hashes, 1, dims=0)
    prev_hash = torch.where((idx == 0)[:, None], trusted_hash[None, :],
                            prev_hash)
    link_ok_each = torch.all(decoded.parent_hash == prev_hash, dim=-1)
    links_ok = torch.all(link_ok_each | ~active)

    # block numbers increment from trusted_block + 1 (u32 arithmetic)
    expected = (trusted_block + 1 + idx) & M32
    blocks_ok = torch.all((decoded.block_number == expected) | ~active)

    # target hash: the hash of the last active header
    target_hash = scale.take_clamp(hashes, torch.clamp(num_active - 1, min=0))

    # range commitments (zero leaves beyond num_active)
    zero = torch.zeros_like(decoded.state_root)
    state_words = _bytes32_to_words(torch.where(active[:, None],
                                                decoded.state_root, zero))
    data_words = _bytes32_to_words(torch.where(active[:, None],
                                               decoded.data_root, zero))

    return SubchainResult(
        target_hash_words=_bytes32_to_words(target_hash),
        state_root_words=_merkle_root_words(state_words),
        data_root_words=_merkle_root_words(data_words),
        links_ok=links_ok,
        blocks_sequential=blocks_ok,
    )


def _merkle_root_words(leaves: torch.Tensor) -> torch.Tensor:
    """(n, 8) -> (8,): simple Merkle tree, one batched SHA-256 per level."""
    nodes = leaves
    while nodes.shape[0] > 1:
        nodes = sha256_pair_words(nodes[0::2], nodes[1::2])
    return nodes[0]


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

def pack_headers(headers: list, tree_size: int, max_header_size: int):
    """SCALE header bytes -> padded (tree_size, S) buffer + sizes."""
    if len(headers) > tree_size:
        raise ValueError(f"{len(headers)} headers for {tree_size} slots")
    buf = np.zeros((tree_size, max_header_size), dtype=np.uint8)
    sizes = np.zeros((tree_size,), dtype=np.int32)
    for i, h in enumerate(headers):
        if len(h) > max_header_size:
            raise ValueError(f"a {len(h)}-byte header for {max_header_size}-byte slots")
        buf[i, :len(h)] = np.frombuffer(h, dtype=np.uint8)
        sizes[i] = len(h)
    return buf, sizes
