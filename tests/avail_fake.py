"""A fake Avail node for the live-source tests, shared by both packages.

``FakeAvailChain`` answers the JSON-RPC methods the clients call from a
chain made of well-formed SCALE headers (so the JSON representation
re-encodes to the same bytes), a set id and authorities per block, and
finality proofs. ``fake_websockets`` is a stand-in ``websockets`` module
that routes a real client's ``call`` through the chain;
``client_class`` is a package's ``AvailClient`` with ``connect`` and
``call`` served by the chain, without a socket. ``fake_redis_module`` is a
dict-backed stand-in ``redis``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import types

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.utils.xxhash import storage_key

SET_ID_KEY = "0x" + storage_key("Grandpa", "CurrentSetId").hex()


def make_keys(n, rng):
    keys = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32)) for _ in range(n)]
    return keys, [k.public_key().public_bytes(serialization.Encoding.Raw,
                                              serialization.PublicFormat.Raw)
                  for k in keys]


def signed_set(rng, n_keys: int, message: bytes):
    """-> (public keys, signatures of message) of n_keys seeded keys."""
    keys, pubs = make_keys(n_keys, rng)
    return pubs, [k.sign(message) for k in keys]


def forged(sig: bytes) -> bytes:
    """The signature with one bit of s flipped."""
    return sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]


def scheduled_change_log(new_pubs) -> bytes:
    """A GRANDPA consensus digest item scheduling new_pubs (weight 1,
    delay 0)."""
    sched = (b"\x01" + scale.encode_compact_u32(len(new_pubs))
             + b"".join(p + (1).to_bytes(8, "little") for p in new_pubs)
             + bytes(4))
    return b"\x04FRNK" + scale.encode_compact_u32(len(sched)) + sched


def header_json(parent: bytes, number: int, rng, logs) -> dict:
    return {"parentHash": "0x" + parent.hex(), "number": hex(number),
            "stateRoot": "0x" + rng.bytes(32).hex(),
            "extrinsicsRoot": "0x" + rng.bytes(32).hex(),
            "digest": {"logs": ["0x" + lg.hex() for lg in logs]}}


def encode_header(h: dict) -> bytes:
    out = bytes.fromhex(h["parentHash"][2:])
    out += scale.encode_compact_u32(int(h["number"], 16))
    out += bytes.fromhex(h["stateRoot"][2:]) + bytes.fromhex(h["extrinsicsRoot"][2:])
    out += scale.encode_compact_u32(len(h["digest"]["logs"]))
    return out + b"".join(bytes.fromhex(lg[2:]) for lg in h["digest"]["logs"])


def finality_proof(block_hash: bytes, number: int, round_: int, precommits) -> bytes:
    """FinalityProof bytes: precommits are (signature, pubkey) pairs."""
    just = (round_.to_bytes(8, "little") + block_hash + number.to_bytes(4, "little")
            + scale.encode_compact_u32(len(precommits))
            + b"".join(block_hash + number.to_bytes(4, "little") + sig + pk
                       for sig, pk in precommits)
            + scale.encode_compact_u32(0))
    return (block_hash + scale.encode_compact_u32(len(just)) + just
            + scale.encode_compact_u32(0))


class FakeAvailChain:
    """headers: number -> header JSON (chained); set_id_of(number);
    authorities_of(number) -> pubkeys; proofs: number -> FinalityProof
    bytes. Blocks without a header up to the head get a synthetic hash."""

    def __init__(self, headers: dict, set_id_of, authorities_of, proofs=None):
        self.headers = headers
        self.head = max(headers)
        self.set_id_of = set_id_of
        self.authorities_of = authorities_of
        self.proofs = proofs or {}
        self.calls = []
        self._numbers = None

    def scale_header(self, number: int) -> bytes:
        return encode_header(self.headers[number])

    def block_hash(self, number: int) -> str:
        if number in self.headers:
            raw = hashlib.blake2b(self.scale_header(number), digest_size=32).digest()
        else:
            raw = hashlib.sha256(number.to_bytes(8, "little")).digest()
        return "0x" + raw.hex()

    def number_of(self, block_hash: str) -> int:
        if self._numbers is None:
            self._numbers = {self.block_hash(n): n for n in range(self.head + 1)}
        return self._numbers[block_hash]

    def respond(self, method: str, params):
        self.calls.append((method, list(params)))
        if method == "chain_getFinalizedHead":
            return self.block_hash(self.head)
        if method == "chain_getBlockHash":
            return self.block_hash(params[0])
        if method == "chain_getHeader":
            return self.headers[self.number_of(params[0]) if params else self.head]
        if method == "state_call" and params[0] == "GrandpaApi_grandpa_authorities":
            pubs = self.authorities_of(self.number_of(params[2]))
            return "0x" + (scale.encode_compact_u32(len(pubs)) + b"".join(
                p + (1).to_bytes(8, "little") for p in pubs)).hex()
        if method == "state_getStorage" and params[0] == SET_ID_KEY:
            return "0x" + self.set_id_of(self.number_of(params[1])).to_bytes(
                8, "little").hex()
        if method == "grandpa_proveFinality":
            return "0x" + self.proofs[params[0]].hex()
        raise KeyError(f"no such method: {method}")


class FakeWebsocket:
    def __init__(self, chain: FakeAvailChain):
        self.chain = chain
        self.closed = False
        self._replies = asyncio.Queue()

    async def send(self, text: str) -> None:
        req = json.loads(text)
        try:
            reply = {"id": req["id"],
                     "result": self.chain.respond(req["method"], req["params"])}
        except KeyError as err:
            reply = {"id": req["id"], "error": {"code": -32601, "message": str(err)}}
        await self._replies.put(json.dumps(reply))

    def __aiter__(self):
        return self

    async def __anext__(self):
        raw = await self._replies.get()
        if raw is None:
            raise StopAsyncIteration
        return raw

    async def close(self) -> None:
        self.closed = True
        await self._replies.put(None)


def fake_websockets(chain: FakeAvailChain) -> types.ModuleType:
    mod = types.ModuleType("websockets")
    mod.opened = []

    async def connect(url, max_size=None):
        mod.opened.append(FakeWebsocket(chain))
        return mod.opened[-1]

    mod.connect = connect
    return mod


def client_class(avail_rpc_module, chain: FakeAvailChain):
    """The module's AvailClient, served by the chain without a socket."""

    class ChainClient(avail_rpc_module.AvailClient):
        async def connect(self):
            pass

        async def call(self, method, params=None):
            return chain.respond(method, params or [])

    return ChainClient


class FakeRedis:
    """redis.Redis over dicts."""

    def __init__(self):
        self.kv, self.zsets = {}, {}

    def set(self, key, value):
        self.kv[key] = value

    def get(self, key):
        return self.kv.get(key)

    def zadd(self, name, mapping):
        self.zsets.setdefault(name, {}).update(mapping)

    def zrangebyscore(self, name, lo, hi):
        members = self.zsets.get(name, {})
        return [m for m, s in sorted(members.items(), key=lambda kv: kv[1])
                if lo <= s <= hi]


def fake_redis_module(servers: dict) -> types.ModuleType:
    """A stand-in ``redis`` module: one FakeRedis per URL, in servers."""
    mod = types.ModuleType("redis")

    class Redis:
        @staticmethod
        def from_url(url, decode_responses=False):
            assert decode_responses is True
            return servers.setdefault(url, FakeRedis())

    mod.Redis = Redis
    return mod
