"""Dummy programs — byte-ABI-exact programs without a proof.

The same request/response byte layouts and the same computed outputs as
VectorX's ``DummyHeaderRange`` and ``DummyRotate`` (target header hash +
range commitments / new authority-set hash), with no proof: they operate
the contract without proving, and give golden vectors.

The chain data comes from an injected ``HeaderSource``, so the programs
are testable without a node.
"""

from __future__ import annotations

import hashlib
from typing import List, Protocol, Tuple

from ..circuits import commitments
from ..circuits.abi import HeaderRangeInput, HeaderRangeOutput, RotateInput


class HeaderSource(Protocol):
    def get_header(self, block_number: int) -> bytes:
        """SCALE-encoded header bytes."""
        ...

    def get_roots_range(self, start_block: int, end_block: int
                        ) -> Tuple[List[bytes], List[bytes]]:
        """(state_roots, data_roots) for blocks start+1..=end."""
        ...

    def last_justified_block(self, authority_set_id: int) -> int: ...

    def get_authorities(self, block_number: int) -> List[bytes]: ...


def dummy_header_range(input_bytes: bytes, source: HeaderSource,
                       tree_size: int) -> bytes:
    """DummyHeaderRange::run."""
    inp = HeaderRangeInput.decode(input_bytes)
    target_header = source.get_header(inp.target_block)
    target_hash = hashlib.blake2b(target_header, digest_size=32).digest()
    state_roots, data_roots = source.get_roots_range(inp.trusted_block,
                                                     inp.target_block)
    state_c, data_c = commitments.range_commitments(state_roots, data_roots,
                                                    tree_size)
    return HeaderRangeOutput(target_hash, state_c, data_c).encode()


def dummy_rotate(input_bytes: bytes, source: HeaderSource) -> bytes:
    """DummyRotate::run."""
    inp = RotateInput.decode(input_bytes)
    epoch_end_block = source.last_justified_block(inp.authority_set_id)
    authorities = source.get_authorities(epoch_end_block)
    return commitments.authority_set_hash(authorities)
