"""Avail chain client — async JSON-RPC over a websocket, and the data
fetcher.

The fetcher surface of VectorX's RPC data fetcher: finalized head, block
hashes, SCALE headers (batched with bounded concurrency, at most 200 in
flight), GRANDPA authorities (runtime API), the current set id (storage
read), the epoch-end search (binary search over set-id boundaries) and
justification retrieval (the store; ``grandpa_proveFinality`` for epoch
ends, in ``services/grandpa.py``).

Headers are re-encoded to SCALE from the JSON-RPC representation:
  parent_hash(32) ++ compact(number) ++ state_root(32) ++
  extrinsics_root(32) ++ compact(#logs) ++ concat(logs)
which is byte-identical to the chain's ``header.encode()``.

``websockets`` is imported by ``connect`` only: the module imports
without it.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import List, Optional

from ..circuits import scale
from ..utils.xxhash import storage_key
from .store import InMemoryStore

log = logging.getLogger("vectorx.avail")

MAX_CONCURRENT_FETCHES = 200


def reencode_header_from_json(h: dict) -> bytes:
    """JSON header (chain_getHeader) -> SCALE bytes."""
    out = bytes.fromhex(h["parentHash"].removeprefix("0x"))
    out += scale.encode_compact_u32(int(h["number"], 16))
    out += bytes.fromhex(h["stateRoot"].removeprefix("0x"))
    out += bytes.fromhex(h["extrinsicsRoot"].removeprefix("0x"))
    logs = h["digest"]["logs"]
    out += scale.encode_compact_u32(len(logs))
    for lg in logs:
        out += bytes.fromhex(lg.removeprefix("0x"))
    return out


def decode_grandpa_authorities(data: bytes) -> List[bytes]:
    """SCALE Vec<(AccountId32, u64 weight)> from
    GrandpaApi_grandpa_authorities; every weight must be 1."""
    n, _, off = scale.decode_compact_u32(data[:5])
    out = []
    for _ in range(n):
        pk = data[off:off + 32]
        weight = int.from_bytes(data[off + 32:off + 40], "little")
        if weight != 1:
            raise ValueError("non-unit authority weight")
        out.append(pk)
        off += 40
    return out


class AvailClient:
    """WS JSON-RPC client (websockets); one in-flight map of request ids."""

    def __init__(self, url: str):
        self.url = url
        self._ws = None
        self._id = 0
        self._pending = {}
        self._listener = None

    async def connect(self):
        import websockets
        self._ws = await websockets.connect(self.url, max_size=None)
        self._listener = asyncio.create_task(self._listen())

    async def close(self):
        """Stop the listener and close the websocket."""
        if self._listener is not None:
            self._listener.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._listener
        if self._ws is not None:
            await self._ws.close()

    async def _listen(self):
        async for raw in self._ws:
            msg = json.loads(raw)
            fut = self._pending.pop(msg.get("id"), None)
            if fut is not None and not fut.done():
                if "error" in msg:
                    fut.set_exception(RuntimeError(msg["error"]))
                else:
                    fut.set_result(msg["result"])

    async def call(self, method: str, params=None):
        self._id += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[self._id] = fut
        await self._ws.send(json.dumps({
            "jsonrpc": "2.0", "id": self._id,
            "method": method, "params": params or []}))
        return await fut

    # -- fetcher surface ---------------------------------------------------

    async def get_finalized_head_hash(self) -> str:
        return await self.call("chain_getFinalizedHead")

    async def get_block_hash(self, number: int) -> str:
        return await self.call("chain_getBlockHash", [number])

    async def get_header_json(self, block_hash: Optional[str] = None) -> dict:
        return await self.call("chain_getHeader",
                               [block_hash] if block_hash else [])

    async def get_header_scale(self, number: int) -> bytes:
        h = await self.get_block_hash(number)
        return reencode_header_from_json(await self.get_header_json(h))

    async def get_headers_range(self, start: int, end: int) -> List[bytes]:
        """Inclusive range, at most MAX_CONCURRENT_FETCHES in flight."""
        sem = asyncio.Semaphore(MAX_CONCURRENT_FETCHES)

        async def one(n):
            async with sem:
                return await self.get_header_scale(n)

        return list(await asyncio.gather(*[one(n) for n in range(start, end + 1)]))

    async def get_authorities(self, block_number: int) -> List[bytes]:
        h = await self.get_block_hash(block_number)
        raw = await self.call("state_call",
                              ["GrandpaApi_grandpa_authorities", "0x", h])
        return decode_grandpa_authorities(bytes.fromhex(raw.removeprefix("0x")))

    async def get_authority_set_id(self, block_number: int) -> int:
        h = await self.get_block_hash(block_number)
        key = "0x" + storage_key("Grandpa", "CurrentSetId").hex()
        raw = await self.call("state_getStorage", [key, h])
        return int.from_bytes(bytes.fromhex(raw.removeprefix("0x")), "little")

    async def get_head_block_number(self) -> int:
        h = await self.get_finalized_head_hash()
        return int((await self.get_header_json(h))["number"], 16)

    async def last_justified_block(self, target_authority_set_id: int) -> int:
        """Last block justified by the target set — the block announcing
        the next set, found by binary search over the set ids; 0 if the
        target set is still live."""
        low = 0
        high = await self.get_head_block_number()
        while low <= high:
            mid = (low + high) // 2
            mid_set = await self.get_authority_set_id(mid)
            if mid_set == target_authority_set_id + 1:
                if mid == 0:
                    return mid
                prev_set = await self.get_authority_set_id(mid - 1)
                if prev_set == target_authority_set_id:
                    return mid
                high = mid - 1
            elif mid_set < target_authority_set_id + 1:
                low = mid + 1
            else:
                high = mid - 1
        return 0


class DataFetcher:
    """Composite fetcher: chain RPC and the store."""

    def __init__(self, client: AvailClient, store: InMemoryStore):
        self.client = client
        self.store = store

    async def get_justification(self, block_number: int):
        return self.store.get_justification(block_number)

    async def has_justification(self, block_number: int) -> bool:
        return self.store.get_justification(block_number) is not None
