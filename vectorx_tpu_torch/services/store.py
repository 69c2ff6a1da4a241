"""Justification / commitment store — VectorX's Redis key schema.

- ``{chain}:justification:{block_nb}``       JSON-serialized justification
- ``{chain}:justifications``                  sorted set (score = block_nb)
- ``{chain}:{address}:cursors``               list of [start, end] ranges
- ``{chain}:blockrange:{start}-{end}``        ABI-packed commitment ranges

Backends: ``InMemoryStore`` (hermetic tests, single-process deployments)
and ``RedisStore`` (the same schema over redis-py, imported when one is
constructed, so the dependency stays optional).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional


@dataclass
class StoredJustification:
    """The indexer's justification record: signatures in the canonical
    order of the authority set, dummy-filled on unsigned lanes."""
    block_number: int
    signed_message: str              # hex, 53-byte precommit message
    pubkeys: List[str]               # hex, canonical authority order
    signatures: List[str]            # hex; dummy for unsigned lanes
    num_authorities: int
    validator_signed: List[bool]

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "StoredJustification":
        return StoredJustification(**json.loads(s))


class InMemoryStore:
    def __init__(self, chain_id: str = "avail"):
        self.chain_id = chain_id
        self._kv: Dict[str, str] = {}
        self._zset: Dict[str, Dict[int, str]] = {}

    # -- justification cache -------------------------

    def add_justification(self, j: StoredJustification) -> None:
        key = f"{self.chain_id}:justification:{j.block_number}"
        self._kv[key] = j.to_json()
        self._zset.setdefault(f"{self.chain_id}:justifications", {})[j.block_number] = key

    def get_justification(self, block_number: int) -> Optional[StoredJustification]:
        key = f"{self.chain_id}:justification:{block_number}"
        raw = self._kv.get(key)
        return StoredJustification.from_json(raw) if raw else None

    def justified_blocks_in_range(self, start: int, end: int) -> List[int]:
        """zrangebyscore equivalent."""
        idx = self._zset.get(f"{self.chain_id}:justifications", {})
        return sorted(b for b in idx if start <= b <= end)

    # -- commitment ranges --------------------------

    def add_block_range_data(self, start: int, end: int,
                             data_commitment: bytes, state_commitment: bytes) -> None:
        key = f"{self.chain_id}:blockrange:{start}-{end}"
        self._kv[key] = (data_commitment + state_commitment).hex()

    def get_block_range_data(self, start: int, end: int):
        raw = self._kv.get(f"{self.chain_id}:blockrange:{start}-{end}")
        if raw is None:
            return None
        blob = bytes.fromhex(raw)
        return blob[:32], blob[32:]

    # -- contract cursors ---------------------------

    def set_cursors(self, address: str, ranges: List[List[int]]) -> None:
        self._kv[f"{self.chain_id}:{address.lower()}:cursors"] = json.dumps(ranges)

    def get_cursors(self, address: str) -> List[List[int]]:
        raw = self._kv.get(f"{self.chain_id}:{address.lower()}:cursors")
        return json.loads(raw) if raw else []


class RedisStore(InMemoryStore):
    """The same schema over a Redis server; requires redis-py."""

    def __init__(self, url: str, chain_id: str = "avail"):
        super().__init__(chain_id)
        import redis
        self._r = redis.Redis.from_url(url, decode_responses=True)

    def add_justification(self, j: StoredJustification) -> None:
        key = f"{self.chain_id}:justification:{j.block_number}"
        self._r.set(key, j.to_json())
        self._r.zadd(f"{self.chain_id}:justifications", {key: j.block_number})

    def get_justification(self, block_number: int):
        raw = self._r.get(f"{self.chain_id}:justification:{block_number}")
        return StoredJustification.from_json(raw) if raw else None

    def justified_blocks_in_range(self, start: int, end: int) -> List[int]:
        keys = self._r.zrangebyscore(f"{self.chain_id}:justifications", start, end)
        return sorted(int(k.rsplit(":", 1)[1]) for k in keys)

    def add_block_range_data(self, start, end, data_commitment, state_commitment):
        self._r.set(f"{self.chain_id}:blockrange:{start}-{end}",
                    (data_commitment + state_commitment).hex())

    def get_block_range_data(self, start, end):
        raw = self._r.get(f"{self.chain_id}:blockrange:{start}-{end}")
        if raw is None:
            return None
        blob = bytes.fromhex(raw)
        return blob[:32], blob[32:]

    def set_cursors(self, address, ranges):
        self._r.set(f"{self.chain_id}:{address.lower()}:cursors", json.dumps(ranges))

    def get_cursors(self, address):
        raw = self._r.get(f"{self.chain_id}:{address.lower()}:cursors")
        return json.loads(raw) if raw else []
