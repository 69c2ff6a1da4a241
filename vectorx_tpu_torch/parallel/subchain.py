"""Header-subchain verification — the witness-level data path.

VectorX's ``verify_subchain`` semantics:

  map:    per header — Blake2b-256 of the SCALE bytes, decode {block
          number, parent hash, state root, data root}, check hash/parent
          adjacency, mask padding ("noop") headers;
  reduce: the state/data Merkle roots over the range;
  final:  the endpoints (trusted block/hash, target block/hash).

A span of contiguous header slots is summed up in one fixed-size record:
its first parent and last hash, the links and block numbers inside it,
the roots of its two SHA-256 sub-trees, and the target hash if it holds
the last active header (164 bytes). Records of adjacent spans combine
into the record of their union. On one device the whole header axis is
one span. Given a mesh (``parallel/mesh.Mesh``, or the two-tier
``parallel/multihost.DcnMesh``), it splits into D contiguous shards of
n/D slots, one span each; the shards' records combine, which completes
the links across shard boundaries and builds the small top trees. Across
processes that exchange is one ``all_gather`` of each process's record.
The result is the same in every field.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..circuits import scale
from ..circuits.commitments import (_bytes32_to_words, _words_to_bytes32,
                                    sha256_pair_words)
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
                    trusted_block, mesh=None) -> SubchainResult:
    """Verify the chain and compute the range commitments, batched.

    header_bytes: (n, S) uint8 zero-padded SCALE headers; header_sizes:
    (n,) (0: a padding slot); num_active: the headers trusted+1..=target;
    trusted_hash: (32,) uint8; trusted_block: a u32. Scalars are ints or
    0-d tensors. With a ``mesh`` the header axis is sharded over it
    (``n`` a multiple of its shard count, ``n`` over it a power of two) and
    the result lies on the mesh's first local device.
    """
    n = header_bytes.shape[0]
    num_active = int(num_active)
    trusted_block = int(trusted_block) & M32
    if mesh is None:
        record = _span_record(header_bytes, header_sizes, 0, n, num_active,
                              trusted_block)
    else:
        record = _sharded_record(header_bytes, header_sizes, num_active,
                                 trusted_block, mesh)
    trusted_hash = trusted_hash.to(record.device)
    links_ok = record[_LINKS].bool() & (
        torch.all(record[_FIRST_PARENT] == trusted_hash)
        | ~record[_FIRST_ACTIVE].bool())
    return SubchainResult(
        target_hash_words=_bytes32_to_words(record[_TARGET]),
        state_root_words=_bytes32_to_words(record[_STATE_ROOT]),
        data_root_words=_bytes32_to_words(record[_DATA_ROOT]),
        links_ok=links_ok,
        blocks_sequential=record[_BLOCKS].bool())


def _merkle_root_words(leaves: torch.Tensor) -> torch.Tensor:
    """(n, 8) -> (8,): simple Merkle tree, one batched SHA-256 per level."""
    nodes = leaves
    while nodes.shape[0] > 1:
        nodes = sha256_pair_words(nodes[0::2], nodes[1::2])
    return nodes[0]


# ---------------------------------------------------------------------------
# Span records
# ---------------------------------------------------------------------------

_FIRST_PARENT = slice(0, 32)    # parent hash field of the span's first slot
_LAST_HASH = slice(32, 64)      # Blake2b of its last slot
_STATE_ROOT = slice(64, 96)     # the span's sub-roots (BE bytes)
_DATA_ROOT = slice(96, 128)
_TARGET = slice(128, 160)       # the target hash, if the span holds it
_FIRST_ACTIVE, _LINKS, _BLOCKS, _HAS_TARGET = 160, 161, 162, 163
RECORD_BYTES = 164


def _flag(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8).reshape(1)


def _span_record(header_bytes, header_sizes, first: int, n: int,
                 num_active: int, trusted_block: int) -> torch.Tensor:
    """The record of slots [first, first + m) of n, from their headers:
    hashes and decodes them, checks parent_hash[i] == hash[i-1] and the
    block numbers (trusted_block + 1 + i, u32) of the active slots inside
    the span, and builds both sub-trees over leaves zeroed past
    num_active. The target is the last active header (its slot clamped
    into [0, n))."""
    m = header_bytes.shape[0]
    dev = header_bytes.device
    hashes = hash_headers(header_bytes, header_sizes)           # (m, 32)
    decoded = scale.decode_header_vec(header_bytes, header_sizes)
    idx = first + torch.arange(m, device=dev)
    active = idx < num_active
    links = torch.all(torch.all(decoded.parent_hash[1:] == hashes[:-1],
                                dim=-1) | ~active[1:])
    expected = (trusted_block + 1 + idx) & M32
    blocks = torch.all((decoded.block_number == expected) | ~active)
    target = min(max(num_active - 1, 0), n - 1) - first
    has_target = 0 <= target < m
    zero = torch.zeros_like(decoded.state_root)
    roots = [_words_to_bytes32(_merkle_root_words(_bytes32_to_words(
        torch.where(active[:, None], leaves, zero))))
        for leaves in (decoded.state_root, decoded.data_root)]
    return torch.cat([
        decoded.parent_hash[0].to(torch.uint8), hashes[-1], *roots,
        hashes[target] if has_target else torch.zeros_like(hashes[0]),
        _flag(active[0]), _flag(links), _flag(blocks),
        _flag(torch.tensor(has_target, device=dev))])


def _combine(records: torch.Tensor) -> torch.Tensor:
    """(k, RECORD_BYTES) records of adjacent spans, in order -> the
    record of their union."""
    flags = records[:, _FIRST_ACTIVE:].bool()
    first_active = flags[:, 0]
    across = torch.all(records[1:, _FIRST_PARENT] == records[:-1, _LAST_HASH],
                       dim=-1) | ~first_active[1:]
    links = torch.all(flags[:, 1]) & torch.all(across)
    roots = [_words_to_bytes32(_merkle_root_words(_bytes32_to_words(
        records[:, part]))) for part in (_STATE_ROOT, _DATA_ROOT)]
    # at most one span holds the target: the others' bytes are zero
    target = torch.sum(records[:, _TARGET].to(torch.int64), dim=0)
    return torch.cat([
        records[0, _FIRST_PARENT], records[-1, _LAST_HASH], *roots,
        target.to(torch.uint8), _flag(first_active[0]), _flag(links),
        _flag(torch.all(flags[:, 2])), _flag(torch.any(flags[:, 3]))])


def _sharded_record(header_bytes, header_sizes, num_active: int,
                    trusted_block: int, mesh) -> torch.Tensor:
    """The record of all n slots from one span a shard: this process's
    shards combine on its first local device, then (on a DcnMesh) the
    processes' records after one all_gather."""
    n = header_bytes.shape[0]
    d = mesh.size
    m = n // d if n % d == 0 else 0
    if m == 0 or m & (m - 1) or d & (d - 1):
        raise ValueError(f"{n} header slots do not split into {d} shards "
                         f"of a power-of-two length")
    first = mesh.first_shard
    dev = mesh.local.devices[0]
    records = [_span_record(b, s, (first + i) * m, n, num_active,
                            trusted_block).to(dev)
               for i, (b, s) in enumerate(zip(mesh.put(header_bytes),
                                              mesh.put(header_sizes)))]
    record = _combine(torch.stack(records))
    if mesh.local is not mesh:
        # one all_gather of each process's record
        record = _combine(torch.stack([r.to(dev)
                                       for r in mesh.all_gather(record)]))
    return record


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
