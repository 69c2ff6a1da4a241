"""Hint runtime — off-circuit witness generation hooks.

A hint is an async callable registered by name (plonky2x's ``async_hint``
and ``HintRegistry``: VectorX fetches chain data during witness
generation this way); ``WitnessBuilder`` resolves all hints concurrently
(an asyncio fan-out of at most 200 requests) and hands their outputs to
the witness builders. A registry maps hint names to implementations so a
build/prove split can reconstruct the pipeline. Host code only.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Dict, List

log = logging.getLogger("vectorx.hints")

Hint = Callable[..., Awaitable[Any]]


class HintRegistry:
    def __init__(self):
        self._hints: Dict[str, Hint] = {}

    def register(self, name: str, fn: Hint) -> None:
        if name in self._hints:
            raise ValueError(f"hint already registered: {name}")
        self._hints[name] = fn

    def hint(self, name: str):
        """Decorator form."""
        def wrap(fn: Hint) -> Hint:
            self.register(name, fn)
            return fn
        return wrap

    def names(self) -> List[str]:
        return sorted(self._hints)

    def get(self, name: str) -> Hint:
        return self._hints[name]


class WitnessBuilder:
    """Collects hint invocations, resolves them concurrently, then lets the
    caller assemble traces from the results."""

    def __init__(self, registry: HintRegistry, max_concurrency: int = 200):
        self.registry = registry
        self._sem = asyncio.Semaphore(max_concurrency)
        self._pending: List = []
        self._keys: List[str] = []

    def request(self, key: str, hint_name: str, *args, **kwargs) -> None:
        async def run():
            async with self._sem:
                return await self.registry.get(hint_name)(*args, **kwargs)
        self._keys.append(key)
        self._pending.append(run())

    async def resolve(self) -> Dict[str, Any]:
        results = await asyncio.gather(*self._pending)
        out = dict(zip(self._keys, results))
        self._pending, self._keys = [], []
        return out


# ---------------------------------------------------------------------------
# The production witness-fetch path (used by services/entrypoint.py)
# ---------------------------------------------------------------------------

def default_registry(source) -> HintRegistry:
    """Standard hints over a chain-data source (a FixtureSource or any
    services.dummy.HeaderSource-shaped object) — the header-range fetch,
    the justification and the rotate hints VectorX installs per circuit.

    Sync sources run under asyncio.to_thread behind a per-source lock (a
    source serializes its own client; a batched get_headers_range fans out
    inside the source)."""
    import threading
    reg = HintRegistry()
    lock = threading.Lock()

    def _call(fn, *args):
        with lock:
            return fn(*args)

    @reg.hint("fetch_header")
    async def fetch_header(block: int):
        return await asyncio.to_thread(_call, source.get_header, block)

    @reg.hint("fetch_headers_range")
    async def fetch_headers_range(start: int, end: int):
        """Inclusive [start, end]; uses a batched source method if present."""
        batched = getattr(source, "get_headers_range", None)
        if batched is not None:
            return await asyncio.to_thread(_call, batched, start, end)
        return [await fetch_header(b) for b in range(start, end + 1)]

    @reg.hint("fetch_justification_record")
    async def fetch_justification_record(block: int):
        return await asyncio.to_thread(
            _call, source.get_justification_record, block)

    @reg.hint("fetch_rotate_data")
    async def fetch_rotate_data(authority_set_id: int):
        return await asyncio.to_thread(
            _call, source.get_rotate_data, authority_set_id)

    return reg


def fetch_header_range_witness(source, trusted_block: int, target_block: int,
                               registry: HintRegistry | None = None):
    """-> (headers [trusted+1..=target], justification record at target).

    Headers fan out in range-chunks concurrently with the justification
    fetch — the HeaderRangeFetcherHint + HintSimpleJustification pair."""
    reg = registry or default_registry(source)
    wb = WitnessBuilder(reg)
    CHUNK = 32
    starts = list(range(trusted_block + 1, target_block + 1, CHUNK))
    for s in starts:
        wb.request(f"headers:{s}", "fetch_headers_range",
                   s, min(s + CHUNK - 1, target_block))
    wb.request("justification", "fetch_justification_record", target_block)
    out = asyncio.run(wb.resolve())
    headers: List = []
    for s in starts:
        headers.extend(out[f"headers:{s}"])
    return headers, out["justification"]


def fetch_rotate_witness(source, authority_set_id: int,
                         registry: HintRegistry | None = None):
    """-> ((epoch_end_block, header, start_pos, n_auth, pubkeys),
    justification record at the epoch-end block) — the rotate hint."""
    reg = registry or default_registry(source)
    wb = WitnessBuilder(reg)
    wb.request("rotate", "fetch_rotate_data", authority_set_id)
    out = asyncio.run(wb.resolve())
    block = out["rotate"][0]
    wb.request("justification", "fetch_justification_record", block)
    out2 = asyncio.run(wb.resolve())
    return out["rotate"], out2["justification"]
