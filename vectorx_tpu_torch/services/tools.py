"""Operator tools — genesis parameters and block-range backfill.

VectorX's genesis tool (the deployment's starting state) and its
fill-block-range tool (the range commitments of past blocks, computed off
chain, and the guardian's ``updateBlockRangeData`` calldata). The range
commitments are the SHA-256 trees of ``circuits/commitments.py`` on the
current CUDA device unless ``device`` names another.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from ..circuits import commitments, scale
from ..circuits.abi import abi_encode_uint32_pair
from ..utils.keccak import keccak256


async def genesis_params(client, block_number: Optional[int] = None) -> dict:
    """The deployment parameters of a block (the head unless named):
    height, header hash, authority set id and hash."""
    if block_number is None:
        block_number = await client.get_head_block_number()
    header = await client.get_header_scale(block_number)
    header_hash = hashlib.blake2b(header, digest_size=32).digest()
    set_id = await client.get_authority_set_id(block_number)
    authorities = await client.get_authorities(block_number)
    set_hash = commitments.authority_set_hash(authorities)
    return {
        "height": block_number,
        "header_hash": "0x" + header_hash.hex(),
        "authority_set_id": set_id,
        "authority_set_hash": "0x" + set_hash.hex(),
    }


async def compute_block_range_data(client, start_block: int, end_block: int,
                                   tree_size: int, device=None) -> dict:
    """The range commitments of (start_block, end_block] for the
    guardian's backfill, on the current CUDA device unless ``device``
    names another."""
    headers = await client.get_headers_range(start_block + 1, end_block)
    decs = [scale.decode_header_bytes(h) for h in headers]
    state_c, data_c = commitments.range_commitments_on(
        [d["state_root"] for d in decs], [d["data_root"] for d in decs],
        tree_size, device)
    end_header = headers[-1]
    return {
        "start_block": start_block,
        "end_block": end_block,
        "state_root_commitment": "0x" + state_c.hex(),
        "data_root_commitment": "0x" + data_c.hex(),
        "end_header_hash": "0x" + hashlib.blake2b(end_header, digest_size=32).digest().hex(),
        "range_key": "0x" + keccak256(abi_encode_uint32_pair(start_block, end_block)).hex(),
    }


_UPDATE_SIG = "updateBlockRangeData(uint32[],uint32[],bytes32[],bytes32[],uint64,bytes32)"


def encode_update_block_range_calldata(start_blocks: List[int], end_blocks: List[int],
                                       data_commitments: List[bytes],
                                       state_commitments: List[bytes],
                                       end_authority_set_id: int,
                                       end_authority_set_hash: bytes) -> bytes:
    """ABI-encode the guardian's updateBlockRangeData call."""
    selector = keccak256(_UPDATE_SIG.encode())[:4]

    def enc_u32_array(vals):
        out = len(vals).to_bytes(32, "big")
        for v in vals:
            out += int(v).to_bytes(32, "big")
        return out

    def enc_b32_array(vals):
        out = len(vals).to_bytes(32, "big")
        for v in vals:
            if len(v) != 32:
                raise ValueError("a bytes32 value must be 32 bytes")
            out += v
        return out

    # head: 4 dynamic offsets + uint64 + bytes32
    tails = [enc_u32_array(start_blocks), enc_u32_array(end_blocks),
             enc_b32_array(data_commitments), enc_b32_array(state_commitments)]
    head_size = 6 * 32
    offsets, acc = [], head_size
    for t in tails:
        offsets.append(acc)
        acc += len(t)
    body = b"".join(o.to_bytes(32, "big") for o in offsets)
    body += end_authority_set_id.to_bytes(32, "big")
    body += end_authority_set_hash
    return selector + body + b"".join(tails)
