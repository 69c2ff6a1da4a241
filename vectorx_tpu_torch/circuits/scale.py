"""SCALE codec — the host-side exact part (witness generation / oracles).

- compact-u32 encode/decode (4 widths selected by the 2-bit mode);
- header decode {parent_hash, block_number, state_root, data_root}: parent
  hash at [0, 32), the compact block number at 32, the state root right
  after it, the data root in the last 32 bytes.
"""

from __future__ import annotations

from typing import Tuple

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
