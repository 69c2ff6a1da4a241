"""SCALE codec — the host-side exact part (witness generation / oracles).

- compact-u32 encode/decode (4 widths selected by the 2-bit mode);
- header decode {parent_hash, block_number, state_root, data_root}: parent
  hash at [0, 32), the compact block number at 32, the state root right
  after it, the data root in the last 32 bytes;
- the 53-byte GRANDPA precommit message the authorities sign.
"""

from __future__ import annotations

from typing import Tuple

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
