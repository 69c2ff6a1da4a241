"""Byte-level request/response ABI of the VectorX contract.

- header_range input (80 B): trusted_block u32 BE | trusted_header_hash 32 |
  authority_set_id u64 BE | authority_set_hash 32 | target_block u32 BE
- header_range output (96 B): target_header_hash | state_root_commitment |
  data_root_commitment
- rotate input (40 B): authority_set_id u64 BE | authority_set_hash 32;
  output (32 B): new_authority_set_hash
- contract range key: keccak256(abi.encode(uint32 start, uint32 end))
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.keccak import keccak256


def _check_length(b: bytes, n: int) -> None:
    if len(b) != n:
        raise ValueError(f"expected {n} bytes, got {len(b)}")


@dataclass(frozen=True)
class HeaderRangeInput:
    trusted_block: int
    trusted_header_hash: bytes
    authority_set_id: int
    authority_set_hash: bytes
    target_block: int

    def encode(self) -> bytes:
        assert len(self.trusted_header_hash) == 32
        assert len(self.authority_set_hash) == 32
        return (self.trusted_block.to_bytes(4, "big") + self.trusted_header_hash
                + self.authority_set_id.to_bytes(8, "big") + self.authority_set_hash
                + self.target_block.to_bytes(4, "big"))

    @staticmethod
    def decode(b: bytes) -> "HeaderRangeInput":
        _check_length(b, 80)
        return HeaderRangeInput(
            trusted_block=int.from_bytes(b[0:4], "big"),
            trusted_header_hash=b[4:36],
            authority_set_id=int.from_bytes(b[36:44], "big"),
            authority_set_hash=b[44:76],
            target_block=int.from_bytes(b[76:80], "big"),
        )


@dataclass(frozen=True)
class HeaderRangeOutput:
    target_header_hash: bytes
    state_root_commitment: bytes
    data_root_commitment: bytes

    def encode(self) -> bytes:
        return (self.target_header_hash + self.state_root_commitment
                + self.data_root_commitment)

    @staticmethod
    def decode(b: bytes) -> "HeaderRangeOutput":
        _check_length(b, 96)
        return HeaderRangeOutput(b[0:32], b[32:64], b[64:96])


@dataclass(frozen=True)
class RotateInput:
    authority_set_id: int
    authority_set_hash: bytes

    def encode(self) -> bytes:
        assert len(self.authority_set_hash) == 32
        return self.authority_set_id.to_bytes(8, "big") + self.authority_set_hash

    @staticmethod
    def decode(b: bytes) -> "RotateInput":
        _check_length(b, 40)
        return RotateInput(int.from_bytes(b[0:8], "big"), b[8:40])


def abi_encode_uint32_pair(a: int, b: int) -> bytes:
    """abi.encode(uint32, uint32) — two left-padded 32-byte words."""
    return a.to_bytes(32, "big") + b.to_bytes(32, "big")


def range_commitment_key(start_block: int, end_block: int) -> bytes:
    """keccak256(abi.encode(startBlock, endBlock)) — contract mapping key."""
    return keccak256(abi_encode_uint32_pair(start_block, end_block))
