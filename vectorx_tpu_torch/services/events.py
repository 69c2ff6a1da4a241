"""Events indexer — polls ``HeaderRangeCommitmentStored`` logs into the store.

VectorX's events indexer: for a deployed contract, scan its logs in
batches of at most 50,000 blocks from the stored cursor, decode the event
tuple (startBlock, endBlock, dataCommitment, stateCommitment, tree size),
persist the ranges and advance the cursor. The Ethereum RPC is injected
(``EthClient``), so the logic is testable without a node;
``JsonRpcEthClient`` speaks plain ``eth_getLogs`` over ``aiohttp``, which
it imports when it calls (the module imports without it).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Protocol

from ..utils.keccak import keccak256
from .store import InMemoryStore

log = logging.getLogger("vectorx.events")

BATCH_SIZE = 50_000

# event HeaderRangeCommitmentStored(uint32 startBlock, uint32 endBlock,
#   bytes32 dataCommitment, bytes32 stateCommitment, uint32 headerRangeCommitmentTreeSize)
EVENT_SIGNATURE = (
    "HeaderRangeCommitmentStored(uint32,uint32,bytes32,bytes32,uint32)")
EVENT_TOPIC = "0x" + keccak256(EVENT_SIGNATURE.encode()).hex()


@dataclass
class CommitmentStoredEvent:
    start_block: int
    end_block: int
    data_commitment: bytes
    state_commitment: bytes
    tree_size: int

    @staticmethod
    def decode_log_data(data: bytes) -> "CommitmentStoredEvent":
        """Non-indexed tuple ABI decode (5 words)."""
        if len(data) != 5 * 32:
            raise ValueError(f"event data of {len(data)} bytes, not 160")
        return CommitmentStoredEvent(
            start_block=int.from_bytes(data[0:32], "big"),
            end_block=int.from_bytes(data[32:64], "big"),
            data_commitment=data[64:96],
            state_commitment=data[96:128],
            tree_size=int.from_bytes(data[128:160], "big"),
        )


class EthClient(Protocol):
    async def latest_block_number(self) -> int: ...
    async def get_logs(self, address: str, topic0: str,
                       from_block: int, to_block: int) -> List[dict]: ...


async def poll_once(eth: EthClient, store: InMemoryStore, address: str,
                    deploy_block: int) -> int:
    """One scan iteration. Returns #events stored."""
    cursors = store.get_cursors(address)
    start = cursors[-1][1] + 1 if cursors else deploy_block
    head = await eth.latest_block_number()
    stored = 0
    while start <= head:
        end = min(start + BATCH_SIZE - 1, head)
        logs = await eth.get_logs(address, EVENT_TOPIC, start, end)
        for lg in logs:
            ev = CommitmentStoredEvent.decode_log_data(
                bytes.fromhex(lg["data"].removeprefix("0x")))
            store.add_block_range_data(ev.start_block, ev.end_block,
                                       ev.data_commitment, ev.state_commitment)
            stored += 1
        start = end + 1
    # advance the cursor (one span)
    if cursors:
        cursors[-1][1] = head
    else:
        cursors = [[deploy_block, head]]
    store.set_cursors(address, cursors)
    return stored


class JsonRpcEthClient:
    """Minimal eth JSON-RPC over aiohttp."""

    def __init__(self, url: str):
        self.url = url
        self._id = 0

    async def _call(self, method: str, params):
        import aiohttp
        self._id += 1
        async with aiohttp.ClientSession() as s:
            async with s.post(self.url, json={
                "jsonrpc": "2.0", "id": self._id,
                "method": method, "params": params}) as r:
                out = await r.json()
                if "error" in out:
                    raise RuntimeError(out["error"])
                return out["result"]

    async def latest_block_number(self) -> int:
        return int(await self._call("eth_blockNumber", []), 16)

    async def get_logs(self, address, topic0, from_block, to_block):
        return await self._call("eth_getLogs", [{
            "address": address,
            "topics": [topic0],
            "fromBlock": hex(from_block),
            "toBlock": hex(to_block)}])
