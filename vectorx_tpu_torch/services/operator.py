"""Operator daemon — decides when to request rotate / header_range proofs.

The stepping rules, epoch handling and environment knobs of VectorX's
operator (LOOP_DELAY_MINS=15, UPDATE_DELAY_BLOCKS=180,
IS_DUMMY_OPERATOR). The chain, contract and prover are injected protocols,
so the decision logic is testable without a node; the proofs come from
this package's programs.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from typing import Optional, Protocol

from ..circuits.abi import HeaderRangeInput, RotateInput

log = logging.getLogger("vectorx.operator")


class ChainClient(Protocol):
    """Avail data access (the data-fetcher surface the operator uses)."""

    async def get_head_block(self) -> int: ...
    async def get_authority_set_id(self, block: int) -> int: ...
    async def last_justified_block(self, authority_set_id: int) -> int: ...
    async def has_justification(self, block: int) -> bool: ...


class ContractClient(Protocol):
    """VectorX contract reads + proof-request submission."""

    async def latest_block(self) -> int: ...
    async def header_range_commitment_tree_size(self) -> int: ...
    async def authority_set_id_to_hash(self, authority_set_id: int) -> bytes: ...
    async def block_height_to_header_hash(self, block: int) -> bytes: ...
    async def request_header_range(self, inp: HeaderRangeInput) -> str: ...
    async def request_rotate(self, inp: RotateInput) -> str: ...


@dataclass
class OperatorConfig:
    loop_delay_mins: int = 15
    update_delay_blocks: int = 180
    is_dummy: bool = False

    @staticmethod
    def from_env() -> "OperatorConfig":
        return OperatorConfig(
            loop_delay_mins=int(os.environ.get("LOOP_DELAY_MINS", "15")),
            update_delay_blocks=int(os.environ.get("UPDATE_DELAY_BLOCKS", "180")),
            is_dummy=os.environ.get("IS_DUMMY_OPERATOR", "false").lower() == "true",
        )


class Operator:
    def __init__(self, chain: ChainClient, contract: ContractClient,
                 config: Optional[OperatorConfig] = None):
        self.chain = chain
        self.contract = contract
        self.config = config or OperatorConfig.from_env()

    # -- rotate ------------------------------------------------------------

    async def find_and_request_rotate(self) -> Optional[str]:
        current_block = await self.contract.latest_block()
        head_block = await self.chain.get_head_block()
        head_set_id = await self.chain.get_authority_set_id(head_block - 1)
        current_set_id = await self.chain.get_authority_set_id(current_block - 1)
        next_hash = await self.contract.authority_set_id_to_hash(current_set_id + 1)

        if current_set_id < head_set_id and next_hash == b"\x00" * 32:
            cur_hash = await self.contract.authority_set_id_to_hash(current_set_id)
            inp = RotateInput(authority_set_id=current_set_id,
                              authority_set_hash=cur_hash)
            req = await self.contract.request_rotate(inp)
            log.info("rotate requested for set %d: %s", current_set_id + 1, req)
            return req
        return None

    # -- header range ------------------------------------------------------

    async def find_and_request_header_range(self) -> Optional[str]:
        latest_block = await self.contract.latest_block()
        tree_size = await self.contract.header_range_commitment_tree_size()
        avail_head = await self.chain.get_head_block()
        current_set_id = await self.chain.get_authority_set_id(latest_block - 1)
        last_justified = await self.chain.last_justified_block(current_set_id)

        request_set_id = current_set_id
        if latest_block == last_justified:
            next_hash = await self.contract.authority_set_id_to_hash(current_set_id + 1)
            if next_hash == b"\x00" * 32:
                return None  # rotate needed first
            request_set_id = current_set_id + 1

        target = await self.find_block_to_step_to(
            self.config.update_delay_blocks, tree_size,
            latest_block, avail_head, request_set_id)
        if target is None:
            return None

        trusted_hash = await self.contract.block_height_to_header_hash(latest_block)
        set_hash = await self.contract.authority_set_id_to_hash(request_set_id)
        inp = HeaderRangeInput(
            trusted_block=latest_block, trusted_header_hash=trusted_hash,
            authority_set_id=request_set_id, authority_set_hash=set_hash,
            target_block=target)
        req = await self.contract.request_header_range(inp)
        log.info("header range %d -> %d requested: %s", latest_block, target, req)
        return req

    # -- stepping rule -----------------------------------------------------

    async def find_block_to_step_to(self, ideal_block_interval: int,
                                    tree_size: int, vectorx_current_block: int,
                                    avail_current_block: int,
                                    authority_set_id: int) -> Optional[int]:
        last_justified = await self.chain.last_justified_block(authority_set_id)

        # step to epoch end if within range (0 => contract is on live epoch)
        if last_justified != 0 and last_justified <= vectorx_current_block + tree_size:
            return last_justified

        max_valid = min(vectorx_current_block + tree_size, avail_current_block)
        block = max_valid - (max_valid % ideal_block_interval)
        if block <= vectorx_current_block:
            return None
        if self.config.is_dummy:
            return block

        # scan forward for a justified block (indexer health check)
        while True:
            if block > vectorx_current_block + tree_size:
                log.warning(
                    "no valid justification found in (%d, %d] — indexer issue?",
                    vectorx_current_block + ideal_block_interval,
                    vectorx_current_block + tree_size)
                return None
            if await self.chain.has_justification(block):
                return block
            block += 1

    # -- main loop ---------------------------------------------------------

    async def run(self) -> None:
        while True:
            try:
                await self.find_and_request_rotate()
                await self.find_and_request_header_range()
            except Exception:  # a failed iteration is logged; the loop goes on
                log.exception("operator iteration failed")
            log.info("sleeping %d minutes", self.config.loop_delay_mins)
            await asyncio.sleep(60 * self.config.loop_delay_mins)
