"""header_range + rotate — the statements executed at witness level.

The complete computation of VectorX's two circuits, each as one device
program of torch ops: subchain verification (Blake2b hashing, SCALE
decode, adjacency, range commitments) plus GRANDPA justification
verification (chained authority hash, precommit decode, batched Ed25519,
2/3 threshold), giving the public outputs the contract consumes (96-byte /
32-byte ABI). This is the system's default prove path (the CLI without
``--stark``): the statement executed and checked, without a proof.

Scalars (block numbers, sizes, counts, offsets) are ints or 0-d tensors;
``authority_set_id`` is its (lo, hi) u32 halves. Everything runs on the
device of the byte tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel import subchain
from . import justification as just
from . import rotate as rot
from .commitments import _words_to_bytes32

M32 = 0xFFFFFFFF


class HeaderRangeResult(NamedTuple):
    target_header_hash: torch.Tensor     # (32,) uint8
    state_root_commitment: torch.Tensor  # (32,) uint8
    data_root_commitment: torch.Tensor   # (32,) uint8
    ok: torch.Tensor                     # () bool — every check passed


def header_range(
    # public inputs (the contract's order)
    trusted_block,                       # u32
    trusted_header_hash: torch.Tensor,   # (32,) uint8
    authority_set_id,                    # (lo, hi) u32
    authority_set_hash: torch.Tensor,    # (32,) uint8
    target_block,                        # u32
    # witness
    header_bytes: torch.Tensor,          # (tree_size, S) uint8
    header_sizes: torch.Tensor,          # (tree_size,)
    j: just.JustificationData,
) -> HeaderRangeResult:
    dev = header_bytes.device
    trusted = torch.as_tensor(trusted_block, dtype=torch.int64, device=dev)
    # (target - trusted) as u32, read as i32
    span = (torch.as_tensor(target_block, dtype=torch.int64, device=dev)
            - trusted) & M32
    num_active = torch.where(span >= 1 << 31, span - (1 << 32), span)

    sub = subchain.verify_subchain(header_bytes, header_sizes, num_active,
                                   trusted_header_hash, trusted)
    target_hash = _words_to_bytes32(sub.target_hash_words)

    j_ok = just.verify_simple_justification(
        target_block, target_hash, authority_set_id, authority_set_hash, j)

    return HeaderRangeResult(
        target_header_hash=target_hash,
        state_root_commitment=_words_to_bytes32(sub.state_root_words),
        data_root_commitment=_words_to_bytes32(sub.data_root_words),
        ok=sub.links_ok & sub.blocks_sequential & j_ok)


class RotateResult(NamedTuple):
    new_authority_set_hash: torch.Tensor  # (32,) uint8
    ok: torch.Tensor                      # () bool


def rotate(
    # public inputs
    current_authority_set_id,             # (lo, hi) u32
    current_authority_set_hash: torch.Tensor,  # (32,) uint8
    # witness (the rotate hint's output)
    epoch_end_block_number,               # u32
    header_bytes: torch.Tensor,           # (S,) uint8, S % 128 == 0
    header_size,
    num_authorities,
    start_position,
    new_pubkeys: torch.Tensor,            # (MAX_N, 32) uint8
    j: just.JustificationData,
) -> RotateResult:
    dev = header_bytes.device
    # hash the epoch-end header
    size = torch.as_tensor(header_size, dtype=torch.int64, device=dev)
    target_hash = subchain.hash_headers(header_bytes[None], size[None])[0]

    # justification by the CURRENT authority set
    j_ok = just.verify_simple_justification(
        epoch_end_block_number, target_hash, current_authority_set_id,
        current_authority_set_hash, j)

    # epoch-end encoding checks
    enc_ok = rot.verify_epoch_end_header(header_bytes, num_authorities,
                                         start_position, new_pubkeys)

    new_hash = rot.new_authority_set_hash(new_pubkeys, num_authorities)
    return RotateResult(new_authority_set_hash=new_hash, ok=j_ok & enc_ok)
