"""SCALE codec — the host-side exact part (witness generation / oracles).

- compact-u32 encode/decode (4 widths selected by the 2-bit mode);
- header decode {parent_hash, block_number, state_root, data_root}: parent
  hash at [0, 32), the compact block number at 32, the state root right
  after it, the data root in the last 32 bytes;
- the 53-byte GRANDPA precommit message the authorities sign;
- the batched decoders of the same layouts on uint8 tensors
  (``*_vec``), with JAX's reading of an out-of-range gather index
  (``take_along_fill``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .consts import ENCODED_PRECOMMIT_LENGTH

HASH_SIZE = 32
MAX_COMPACT_UINT_BYTES = 5
DATA_ROOT_OFFSET_FROM_END = 32


def encode_compact_u32(v: int) -> bytes:
    """SCALE compact encoding of a u32 (substrate spec)."""
    if not 0 <= v <= 0xFFFFFFFF:
        raise ValueError(f"not a u32: {v}")
    if v < 1 << 6:
        return bytes([v << 2])
    if v < 1 << 14:
        return ((v << 2) | 0b01).to_bytes(2, "little")
    if v < 1 << 30:
        return ((v << 2) | 0b10).to_bytes(4, "little")
    n_bytes = (v.bit_length() + 7) // 8
    return bytes([((n_bytes - 4) << 2) | 0b11]) + v.to_bytes(n_bytes, "little")


def decode_compact_u32(data: bytes) -> Tuple[int, int, int]:
    """-> (value, mode, encoded_length)."""
    mode = data[0] & 0b11
    if mode == 0:
        return data[0] >> 2, 0, 1
    if mode == 1:
        return int.from_bytes(data[:2], "little") >> 2, 1, 2
    if mode == 2:
        return int.from_bytes(data[:4], "little") >> 2, 2, 4
    n = (data[0] >> 2) + 4
    return int.from_bytes(data[1:1 + n], "little"), 3, 1 + n


def decode_header_bytes(header: bytes) -> dict:
    """Exact header field extraction."""
    parent_hash = header[0:HASH_SIZE]
    block_number, _, clen = decode_compact_u32(
        header[HASH_SIZE:HASH_SIZE + MAX_COMPACT_UINT_BYTES])
    state_root = header[HASH_SIZE + clen:HASH_SIZE + clen + HASH_SIZE]
    data_root = header[len(header) - DATA_ROOT_OFFSET_FROM_END:]
    return dict(parent_hash=parent_hash, block_number=block_number,
                state_root=state_root, data_root=data_root)


def decode_precommit_bytes(precommit: bytes) -> Tuple[bytes, int, int, int]:
    """Exact 53-byte precommit decode -> (block_hash, block_nb, round,
    set_id); the leading byte must be 1."""
    assert len(precommit) == ENCODED_PRECOMMIT_LENGTH
    assert precommit[0] == 1
    block_hash = precommit[1:33]
    block_number = int.from_bytes(precommit[33:37], "little")
    round_ = int.from_bytes(precommit[37:45], "little")
    authority_set_id = int.from_bytes(precommit[45:53], "little")
    return block_hash, block_number, round_, authority_set_id


def encode_precommit_bytes(block_hash: bytes, block_number: int, round_: int,
                           authority_set_id: int) -> bytes:
    """The signed GRANDPA precommit message: 1 | block hash | block number
    (u32 LE) | round (u64 LE) | authority set id (u64 LE)."""
    return (bytes([1]) + block_hash + block_number.to_bytes(4, "little")
            + round_.to_bytes(8, "little")
            + authority_set_id.to_bytes(8, "little"))


# ---------------------------------------------------------------------------
# Batched decoders (uint8 tensors, static shapes, on their device)
# ---------------------------------------------------------------------------

def take_along_fill(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(arr, idx, axis=-1)`` as JAX reads it: an index
    in [-S, 0) counts from the end, and one outside [-S, S) reads the
    dtype's maximum (255 for uint8). ``arr`` and ``idx`` agree on their
    leading axes."""
    size = arr.shape[-1]
    idx = torch.where(idx < 0, idx + size, idx)
    inside = (idx >= 0) & (idx < size)
    got = torch.gather(arr, -1, idx.clamp(0, size - 1))
    return torch.where(inside, got,
                       torch.full_like(got, torch.iinfo(arr.dtype).max))


def take_clamp(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``arr[i]`` for a 0-d index tensor as JAX reads a dynamic index: a
    negative index counts from the end, then it is clamped into range."""
    size = arr.shape[0]
    i = torch.where(i < 0, i + size, i).clamp(0, size - 1)
    return arr.index_select(0, i.reshape(1))[0]


class DecodedCompact(NamedTuple):
    value: torch.Tensor     # u32 values (int64)
    mode: torch.Tensor      # in {0, 1, 2, 3}
    length: torch.Tensor    # in {1, 2, 4, 5}


def decode_compact_u32_vec(b: torch.Tensor) -> DecodedCompact:
    """b: (..., 5) uint8 -> decoded compact u32 (batched). Mode 3 reads
    only 4-byte payloads (block numbers are u32)."""
    b = b.to(torch.int64)
    mode = b[..., 0] & 3
    v0 = b[..., 0] >> 2
    v1 = v0 | (b[..., 1] << 6)
    v2 = v1 | (b[..., 2] << 14) | (b[..., 3] << 22)
    v3 = b[..., 1] | (b[..., 2] << 8) | (b[..., 3] << 16) | (b[..., 4] << 24)
    value = torch.where(mode == 0, v0, torch.where(
        mode == 1, v1, torch.where(mode == 2, v2, v3)))
    length = torch.where(mode == 2, 4, mode + 1) + (mode == 3)
    return DecodedCompact(value=value, mode=mode, length=length)


class DecodedHeader(NamedTuple):
    block_number: torch.Tensor   # (...,) u32 values (int64)
    parent_hash: torch.Tensor    # (..., 32) uint8
    state_root: torch.Tensor     # (..., 32) uint8
    data_root: torch.Tensor      # (..., 32) uint8


def decode_header_vec(header_bytes: torch.Tensor,
                      header_size: torch.Tensor) -> DecodedHeader:
    """header_bytes: (..., S) uint8 zero-padded; header_size: (...,).

    Parent hash at [0, 32); compact block number at 32; the state root at
    one of 4 offsets selected by the compact mode; the data root = bytes
    [size - 32, size) by a dynamic-offset gather."""
    parent_hash = header_bytes[..., :HASH_SIZE]
    compact = decode_compact_u32_vec(
        header_bytes[..., HASH_SIZE:HASH_SIZE + MAX_COMPACT_UINT_BYTES])
    c = [header_bytes[..., o:o + HASH_SIZE] for o in (33, 34, 36, 37)]
    mode = compact.mode[..., None]
    state_root = torch.where(mode == 0, c[0], torch.where(
        mode == 1, c[1], torch.where(mode == 2, c[2], c[3])))
    start = torch.clamp(header_size.to(torch.int64) - DATA_ROOT_OFFSET_FROM_END,
                        min=0)
    idx = start[..., None] + torch.arange(HASH_SIZE, device=start.device)
    data_root = take_along_fill(header_bytes, idx)
    return DecodedHeader(block_number=compact.value, parent_hash=parent_hash,
                         state_root=state_root, data_root=data_root)


class DecodedPrecommit(NamedTuple):
    block_hash: torch.Tensor         # (..., 32) uint8
    block_number: torch.Tensor       # (...,) u32 values (int64)
    round: Tuple[torch.Tensor, torch.Tensor]             # u64 as (lo, hi) u32
    authority_set_id: Tuple[torch.Tensor, torch.Tensor]  # u64 as (lo, hi) u32
    valid: torch.Tensor              # (...,) bool — leading byte == 1


def _le_u32(b: torch.Tensor) -> torch.Tensor:
    b = b.to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def decode_precommit_vec(p: torch.Tensor) -> DecodedPrecommit:
    """p: (..., 53) uint8 -> decoded precommit (batched)."""
    return DecodedPrecommit(
        block_hash=p[..., 1:33], block_number=_le_u32(p[..., 33:37]),
        round=(_le_u32(p[..., 37:41]), _le_u32(p[..., 41:45])),
        authority_set_id=(_le_u32(p[..., 45:49]), _le_u32(p[..., 49:53])),
        valid=p[..., 0] == 1)
