"""The port's service layer against the JAX package's, on the same inputs.

- ``avail_rpc``: every ``AvailClient`` method through a real ``call``
  over a stand-in ``websockets`` module (``tests/avail_fake.py``) that
  answers from one fake chain, in both packages; JSON headers re-encode
  to the chain's bytes and decode with the port's decoder;
- ``store.RedisStore``: both packages over the same dict-backed fake
  ``redis`` module leave the same keys and values;
- ``grandpa.JustificationProvider``: the epoch-end branch (a finality
  proof from a fake client, its signatures verified by the port on the
  CPU; the JAX side aligns without its verify, whose eager compile takes
  minutes on a CPU) and the store branch;
- ``indexer``: in ``tests/test_torch_indexer.py``;
- ``operator``: the scenarios of ``tests/test_services.py`` (its
  ``FakeChain`` and ``FakeContract``) and more, the same requests;
- ``contract_sim``: one call sequence with every revert of
  ``tests/test_contracts.py`` on both simulators: the same calldata,
  storage, events and reverts;
- ``events``: ``poll_once`` over a fake eth client across batches, and
  ``JsonRpcEthClient`` over a stand-in ``aiohttp``;
- ``tools``: the three functions, the range commitments on the CPU;
- every new module imports with ``websockets``, ``aiohttp``, ``redis`` and
  ``cryptography`` absent.
"""

import asyncio
import dataclasses
import functools
import hashlib
import json
import logging
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vectorx_tpu.services import avail_rpc as javail
from vectorx_tpu.services import contract_sim as jcs
from vectorx_tpu.services import events as jevents
from vectorx_tpu.services import grandpa as jgrandpa
from vectorx_tpu.services import operator as joperator
from vectorx_tpu.services import store as jstore
from vectorx_tpu.services import tools as jtools
from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.services import avail_rpc, events, grandpa
from vectorx_tpu_torch.services import contract_sim as cs
from vectorx_tpu_torch.services import operator, store, tools

import avail_fake as af
from test_services import FakeChain, FakeContract

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


# -- the fake chain -------------------------------------------------------------

SET_BOUNDS = (12, 30)           # set 0 below 12, set 1 below 30, set 2 after
HEAD = 40


def _set_id(n: int) -> int:
    return sum(n >= b for b in SET_BOUNDS)


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(91)
    _, pubs = af.make_keys(9, rng)
    headers, parent = {}, bytes(32)
    for n in range(HEAD + 1):
        logs = [b"\x06BABE" + scale.encode_compact_u32(40) + rng.bytes(40)]
        if n in SET_BOUNDS:
            logs.insert(0, af.scheduled_change_log(pubs[3:6]))
        headers[n] = af.header_json(parent, n, rng, logs)
        parent = hashlib.blake2b(af.encode_header(headers[n]), digest_size=32).digest()
    return af.FakeAvailChain(headers, _set_id,
                             lambda n: pubs[3 * _set_id(n):3 * _set_id(n) + 3])


async def _every_client_method(mod, chain, fake_ws):
    client = mod.AvailClient("ws://avail.test")
    await client.connect()
    out = {
        "head_hash": await client.get_finalized_head_hash(),
        "hash_7": await client.get_block_hash(7),
        "json_head": await client.get_header_json(),
        "json_7": await client.get_header_json(chain.block_hash(7)),
        "scale_7": await client.get_header_scale(7),
        "range": await client.get_headers_range(3, 14),
        "authorities": [await client.get_authorities(n) for n in (0, 12, 35)],
        "set_ids": [await client.get_authority_set_id(n) for n in (0, 11, 12, 40)],
        "head": await client.get_head_block_number(),
        "last_justified": [await client.last_justified_block(s) for s in (0, 1, 2)],
    }
    with pytest.raises(RuntimeError, match="no such method"):
        await client.call("author_nonexistent")
    if hasattr(client, "close"):
        await client.close()
        out["closed"] = fake_ws.opened[-1].closed and client._listener.done()
    return out


def test_every_client_method_equals_reference(chain, monkeypatch):
    fake_ws = af.fake_websockets(chain)
    monkeypatch.setitem(sys.modules, "websockets", fake_ws)
    want = asyncio.run(_every_client_method(javail, chain, fake_ws))
    got = asyncio.run(_every_client_method(avail_rpc, chain, fake_ws))
    assert got.pop("closed") is True
    assert got == want
    assert got["scale_7"] == chain.scale_header(7)
    assert got["range"] == [chain.scale_header(n) for n in range(3, 15)]
    assert got["last_justified"] == [12, 30, 0] and got["head"] == HEAD
    assert got["set_ids"] == [0, 0, 1, 2]


def test_reencoded_json_header_decodes_with_the_port(chain):
    for n in (0, 12, 40):
        raw = avail_rpc.reencode_header_from_json(chain.headers[n])
        assert raw == javail.reencode_header_from_json(chain.headers[n])
        assert raw == chain.scale_header(n)
        dec = scale.decode_header_bytes(raw)
        h = chain.headers[n]
        assert dec["block_number"] == n
        assert dec["parent_hash"].hex() == h["parentHash"][2:]
        assert dec["state_root"].hex() == h["stateRoot"][2:]
        assert dec["data_root"] == raw[-32:]


def test_decode_grandpa_authorities(chain):
    raw = bytes.fromhex(chain.respond(
        "state_call", ["GrandpaApi_grandpa_authorities", "0x",
                       chain.block_hash(20)])[2:])
    assert avail_rpc.decode_grandpa_authorities(raw) == \
        javail.decode_grandpa_authorities(raw) == chain.authorities_of(20)
    heavy = raw[:1] + raw[1:33] + (2).to_bytes(8, "little") + raw[41:]
    with pytest.raises(ValueError, match="non-unit"):
        avail_rpc.decode_grandpa_authorities(heavy)


def test_data_fetcher_reads_the_store():
    rec = _record(5, 2)
    for av, st in ((javail, jstore), (avail_rpc, store)):
        s = st.InMemoryStore()
        s.add_justification(st.StoredJustification(**rec))
        fetcher = av.DataFetcher(None, s)
        assert asyncio.run(fetcher.has_justification(rec["block_number"]))
        assert not asyncio.run(fetcher.has_justification(1))
        assert dataclasses.asdict(asyncio.run(
            fetcher.get_justification(rec["block_number"]))) == rec


# -- stores -----------------------------------------------------------------------

@pytest.fixture
def fake_redis(monkeypatch):
    servers = {}
    monkeypatch.setitem(sys.modules, "redis", af.fake_redis_module(servers))
    return servers


def _record(block: int, n_auth: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed + block)
    return dict(block_number=block, signed_message=rng.bytes(53).hex(),
                pubkeys=[rng.bytes(32).hex() for _ in range(n_auth)],
                signatures=[rng.bytes(64).hex() for _ in range(n_auth)],
                num_authorities=n_auth,
                validator_signed=[bool(i % 3) for i in range(n_auth)])


def _store_ops(st, s):
    for block in (120, 7, 64):
        s.add_justification(st.StoredJustification(**_record(block, 4)))
    s.add_block_range_data(10, 20, b"\x01" * 32, b"\x02" * 32)
    s.set_cursors("0xAbCdEf", [[1, 5], [9, 12]])
    return (dataclasses.asdict(s.get_justification(64)), s.get_justification(65),
            s.justified_blocks_in_range(7, 64), s.justified_blocks_in_range(0, 10 ** 6),
            s.get_block_range_data(10, 20), s.get_block_range_data(10, 21),
            s.get_cursors("0xabcdef"), s.get_cursors("0x00"))


def test_redis_store_leaves_the_reference_keys(fake_redis):
    want = _store_ops(jstore, jstore.RedisStore("redis://jax", "avail"))
    got = _store_ops(store, store.RedisStore("redis://port", "avail"))
    assert got == want
    assert fake_redis["redis://port"].kv == fake_redis["redis://jax"].kv
    assert fake_redis["redis://port"].zsets == fake_redis["redis://jax"].zsets
    assert "avail:0xabcdef:cursors" in fake_redis["redis://port"].kv
    # the in-memory store answers the same
    assert _store_ops(store, store.InMemoryStore()) == want


# -- justifications ----------------------------------------------------------------

class ProofClient:
    """The client surface JustificationProvider uses."""

    def __init__(self, epoch_end: int, authorities, proof: bytes):
        self.epoch_end, self.authorities, self.proof = epoch_end, authorities, proof

    async def get_authority_set_id(self, block):
        return 7 + (block >= self.epoch_end)

    async def get_authorities(self, block):
        assert block == self.epoch_end - 1
        return self.authorities

    async def call(self, method, params):
        assert method == "grandpa_proveFinality" and params == [self.epoch_end]
        return "0x" + self.proof.hex()


def test_justification_provider_both_branches(monkeypatch):
    rng = np.random.default_rng(17)
    block, block_hash = 900, rng.bytes(32)
    message = scale.encode_precommit_bytes(block_hash, block, 4, 7)
    pubs, sigs = af.signed_set(rng, 6, message)
    signed = [1, 0, 3, 5, 4]        # finality proofs list precommits in any order
    proof = af.finality_proof(block_hash, block, 4, [(sigs[i], pubs[i]) for i in signed])
    monkeypatch.setattr(jgrandpa, "align_justification",
                        functools.partial(jgrandpa.align_justification, verify=False))
    stored = _record(block + 5, 6)

    def both(client_proof):
        out = []
        for g, st, kw in ((jgrandpa, jstore, {}), (grandpa, store, {"device": "cpu"})):
            s = st.InMemoryStore()
            s.add_justification(st.StoredJustification(**stored))
            provider = g.JustificationProvider(ProofClient(block, pubs, client_proof), s, **kw)
            out.append([dataclasses.asdict(asyncio.run(provider.get(b)))
                        for b in (block, block + 5)])
            with pytest.raises(LookupError):
                asyncio.run(provider.get(block + 6))
        return out

    want, got = both(proof)
    assert got == want
    assert got[0]["validator_signed"] == [True, True, False, True, True, True]
    assert got[0]["signed_message"] == message.hex() and got[1] == stored

    forged = af.finality_proof(block_hash, block, 4, [(af.forged(sigs[1]), pubs[1])]
                               + [(sigs[i], pubs[i]) for i in signed[1:]])
    provider = grandpa.JustificationProvider(ProofClient(block, pubs, forged),
                                             store.InMemoryStore(), device="cpu")
    with pytest.raises(ValueError, match="invalid signature"):
        asyncio.run(provider.get(block))


# -- operator ------------------------------------------------------------------------

OPERATOR_SCENARIOS = ["step_to_interval_multiple", "step_to_epoch_end",
                      "no_step_when_caught_up", "justification_scan",
                      "scan_finds_nothing", "request_header_range_flow",
                      "request_after_rotation", "rotate_needed_first",
                      "rotate_requested_when_new_epoch", "no_rotate_when_next_set_known",
                      "run_loop_survives_rpc_failure"]


async def _operator_scenario(name, op, chain, contract):
    if name == "step_to_interval_multiple":
        return await op.find_block_to_step_to(180, 256, 500, 1000, 5)
    if name == "step_to_epoch_end":
        chain.last_justified[5] = 600
        return await op.find_block_to_step_to(180, 256, 500, 1000, 5)
    if name == "no_step_when_caught_up":
        chain.head = 505
        return await op.find_block_to_step_to(180, 256, 500, 505, 5)
    if name == "justification_scan":
        op.config.is_dummy = False
        chain.justified.add(723)
        return await op.find_block_to_step_to(180, 256, 500, 1000, 5)
    if name == "scan_finds_nothing":
        op.config.is_dummy = False
        return await op.find_block_to_step_to(180, 256, 500, 1000, 5)
    if name == "request_header_range_flow":
        contract.set_hashes[5] = bytes([2] * 32)
        return await op.find_and_request_header_range()
    if name == "request_after_rotation":
        chain.last_justified[5] = 500        # the contract sits at the epoch end
        chain.last_justified[6] = 610
        contract.set_hashes[6] = bytes([3] * 32)
        return await op.find_and_request_header_range()
    if name == "rotate_needed_first":
        chain.last_justified[5] = 500
        return await op.find_and_request_header_range()
    if name == "rotate_requested_when_new_epoch":
        chain.set_ids[999] = 6
        chain.set_ids[499] = 5
        contract.set_hashes[5] = bytes([2] * 32)
        return await op.find_and_request_rotate()
    if name == "no_rotate_when_next_set_known":
        chain.set_ids[999] = 6
        contract.set_hashes[6] = bytes([4] * 32)
        return await op.find_and_request_rotate()
    assert name == "run_loop_survives_rpc_failure"
    contract.set_hashes[5] = bytes([2] * 32)
    op.config.loop_delay_mins = 0
    calls = {"n": 0}
    orig = contract.latest_block

    async def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("ws dropped")
        return await orig()

    contract.latest_block = flaky
    task = asyncio.ensure_future(op.run())
    for _ in range(200):
        if contract.requests:
            break
        await asyncio.sleep(0.01)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    del contract.requests[1:]          # how many more land before the cancel varies
    return calls["n"] >= 2


@pytest.mark.parametrize("name", OPERATOR_SCENARIOS)
def test_operator_scenario_equals_reference(name, caplog):
    out = []
    for mod in (joperator, operator):
        chain, contract = FakeChain(), FakeContract()
        op = mod.Operator(chain, contract,
                          mod.OperatorConfig(is_dummy=True, update_delay_blocks=180))
        with caplog.at_level(logging.CRITICAL):
            result = asyncio.run(_operator_scenario(name, op, chain, contract))
        out.append((result, [(kind, inp.encode()) for kind, inp in contract.requests]))
    assert out[1] == out[0]


def test_operator_config_from_env(monkeypatch):
    assert operator.OperatorConfig.from_env() == operator.OperatorConfig()
    monkeypatch.setenv("LOOP_DELAY_MINS", "3")
    monkeypatch.setenv("UPDATE_DELAY_BLOCKS", "90")
    monkeypatch.setenv("IS_DUMMY_OPERATOR", "TRUE")
    got = dataclasses.asdict(operator.OperatorConfig.from_env())
    assert got == dataclasses.asdict(joperator.OperatorConfig.from_env())
    assert got == {"loop_delay_mins": 3, "update_delay_blocks": 90, "is_dummy": True}


# -- contract ----------------------------------------------------------------------

H_GENESIS, SET_HASH = bytes([7] * 32), bytes([9] * 32)
OUT96 = bytes(range(96))
OUT32 = bytes(range(100, 132))


def _state(sim, gw) -> dict:
    maps = ("block_height_to_header_hash", "authority_set_id_to_hash",
            "data_root_commitments", "state_root_commitments", "range_start_blocks")
    return dict(
        frozen=sim.frozen, latest_block=sim.latest_block,
        latest_authority_set_id=sim.latest_authority_set_id,
        **{m: sorted(getattr(sim, m).items()) for m in maps},
        events=[(e.name, sorted(e.args.items())) for e in sim.events],
        requests=[(r.function_id, r.input, r.entry_calldata, r.gas_limit)
                  for r in gw.requests],
        proven=sorted(gw._proven.items()))


def _contract_story(m) -> list:
    """Every path of tests/test_contracts.py, and a few more, in order."""
    log = [("selectors", m.selector(m.COMMIT_HEADER_RANGE_SIG), m.selector(m.ROTATE_SIG)),
           ("calldata", m.encode_commit_header_range_call(616, 645610),
            m.encode_rotate_call(616))]
    sim = gw = None

    def fresh():
        nonlocal sim, gw
        gw = m.MockProofGateway()
        sim = m.VectorXSim.deploy(guardian="guardian", gateway=gw, height=10,
                                  header=H_GENESIS, authority_set_id=0,
                                  authority_set_hash=SET_HASH, tree_size=16)

    def step(name, fn):
        try:
            fn()
            outcome = "ok"
        except m.Revert as err:
            outcome = ("revert", str(err))
        log.append((name, outcome, _state(sim, gw)))

    fresh()
    step("request_header_range", lambda: sim.request_header_range(0, 25))
    step("commit_without_proof", lambda: sim.commit_header_range(0, 25))
    step("fulfil_and_commit", lambda: gw.fulfill_request(gw.requests[-1], OUT96))
    step("request_rotate", lambda: sim.request_rotate(0))
    step("fulfil_rotate", lambda: gw.fulfill_request(gw.requests[-1], OUT32))
    step("next_set_exists", lambda: sim.request_rotate(0))
    step("request_after_commit", lambda: sim.request_header_range(0, 30))
    fresh()
    step("proof_is_input_bound", lambda: (sim.request_header_range(0, 25),
                                          gw.fulfill(gw.requests[-1].function_id,
                                                     gw.requests[-1].input, OUT96)))
    step("other_target", lambda: sim.commit_header_range(0, 30))
    step("proven_target", lambda: sim.commit_header_range(0, 25))
    fresh()
    step("freeze", lambda: sim.update_freeze(True, sender="guardian"))
    step("frozen_commit", lambda: sim.commit_header_range(0, 25))
    step("frozen_rotate", lambda: sim.rotate(0))
    step("not_guardian", lambda: sim.update_freeze(False, sender="mallory"))
    step("unfreeze", lambda: sim.update_freeze(False, sender="guardian"))
    fresh()
    sim.authority_set_id_to_hash[5] = bytes([1] * 32)
    sim.latest_authority_set_id = 5
    sim.authority_set_id_to_hash[3] = bytes([2] * 32)
    step("old_authority_set", lambda: sim.request_header_range(3, 25))
    step("old_rotate_set", lambda: sim.request_rotate(3))
    fresh()
    step("target_must_advance", lambda: sim.request_header_range(0, 10))
    step("unknown_set", lambda: sim.request_header_range(42, 25))
    step("unknown_rotate_set", lambda: sim.request_rotate(42))
    step("bad_output_length", lambda: (sim.request_header_range(0, 25),
                                       gw.fulfill(gw.requests[-1].function_id,
                                                  gw.requests[-1].input, OUT96[:95]),
                                       sim.commit_header_range(0, 25)))
    step("bad_rotate_length", lambda: (sim.request_rotate(0),
                                       gw.fulfill(gw.requests[-1].function_id,
                                                  gw.requests[-1].input, OUT32[:31]),
                                       sim.rotate(0)))
    step("unknown_selector", lambda: sim.call(b"\xde\xad\xbe\xef" + bytes(32)))
    step("rotate_by_calldata_unproven", lambda: sim.call(m.encode_rotate_call(0)))
    sim.block_height_to_header_hash.pop(10)
    step("trusted_header_not_found", lambda: sim.request_header_range(0, 25))
    fresh()
    h1, h2 = bytes([1] * 32), bytes([2] * 32)
    step("update_block_range_data", lambda: sim.update_block_range_data(
        [10, 20], [20, 30], [h1, h2], [bytes([4] * 32), bytes([5] * 32)],
        [bytes([6] * 32), bytes([7] * 32)], end_authority_set_id=2,
        end_authority_set_hash=bytes([8] * 32), sender="guardian"))
    for name, args in [("non_contiguous", ([30, 45], [40, 50])),
                       ("must_extend_head", ([31], [40])),
                       ("length_mismatch", ([30], [40, 50])),
                       ("empty", ([], []))]:
        starts, ends = args
        step(name, lambda s=starts, e=ends: sim.update_block_range_data(
            s, e, [h1] * len(e), [h1] * len(e), [h2] * len(e), 3, h2,
            sender="guardian"))
    step("range_data_not_guardian", lambda: sim.update_block_range_data(
        [30], [40], [h1], [h1], [h2], 3, h2, sender="mallory"))
    step("genesis_state", lambda: sim.update_genesis_state(
        100, h2, 9, bytes([5] * 32), sender="guardian"))
    step("genesis_not_guardian", lambda: sim.update_genesis_state(
        100, h2, 9, bytes([5] * 32), sender="mallory"))
    return log


def test_contract_simulator_equals_reference():
    got, want = _contract_story(cs), _contract_story(jcs)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert got == want
    outcomes = {g[0]: g[1] for g in got[2:]}
    assert outcomes["commit_without_proof"][0] == "revert"
    assert outcomes["fulfil_and_commit"] == "ok" == outcomes["proven_target"]
    assert {k for k, v in outcomes.items() if v != "ok"} == {
        "commit_without_proof", "next_set_exists", "other_target", "frozen_commit", "frozen_rotate", "not_guardian",
        "old_authority_set", "old_rotate_set", "target_must_advance",
        "unknown_set", "unknown_rotate_set", "bad_output_length",
        "bad_rotate_length", "unknown_selector", "rotate_by_calldata_unproven",
        "trusted_header_not_found", "non_contiguous", "must_extend_head",
        "length_mismatch", "empty", "range_data_not_guardian",
        "genesis_not_guardian"}


# -- events --------------------------------------------------------------------------

def _event_data(start, end, data_c, state_c, tree) -> str:
    return "0x" + (start.to_bytes(32, "big") + end.to_bytes(32, "big") + data_c
                   + state_c + tree.to_bytes(32, "big")).hex()


class FakeEth:
    def __init__(self, logs, head):
        self.logs, self.head, self.queries = logs, head, []

    async def latest_block_number(self):
        return self.head

    async def get_logs(self, address, topic0, from_block, to_block):
        self.queries.append((address, topic0, from_block, to_block))
        return [{"data": d} for b, d in self.logs if from_block <= b <= to_block]


def _poll_story(ev, st):
    rng = np.random.default_rng(44)
    logs = [(b, _event_data(s, e, rng.bytes(32), rng.bytes(32), 256))
            for b, (s, e) in [(150, (10, 20)), (50_200, (20, 190)),
                              (100_099, (190, 200)), (100_100, (200, 456)),
                              (125_000, (456, 700))]]
    eth = FakeEth(logs[:4], 120_000)
    s = st.InMemoryStore()
    counts = [asyncio.run(ev.poll_once(eth, s, "0xVectorX", 100))]
    eth.logs, eth.head = logs, 130_000
    counts.append(asyncio.run(ev.poll_once(eth, s, "0xVectorX", 100)))
    return counts, eth.queries, s._kv, s.get_cursors("0xvectorx")


def test_poll_once_equals_reference():
    got, want = _poll_story(events, store), _poll_story(jevents, jstore)
    assert got == want
    counts, queries, kv, cursors = got
    assert counts == [4, 1] and cursors == [[100, 130_000]]
    assert [q[2:] for q in queries] == [(100, 50_099), (50_100, 100_099),
                                        (100_100, 120_000), (120_001, 130_000)]
    assert events.EVENT_TOPIC == jevents.EVENT_TOPIC and \
        events.BATCH_SIZE == jevents.BATCH_SIZE == 50_000
    with pytest.raises(ValueError):
        events.CommitmentStoredEvent.decode_log_data(bytes(128))


def _fake_aiohttp(replies, sent):
    mod = types.ModuleType("aiohttp")

    class Response:
        def __init__(self, body):
            self.body = body

        async def json(self):
            return self.body

        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            return False

    class ClientSession:
        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            return False

        def post(self, url, json):
            sent.append((url, json))
            return Response(replies[json["method"]])

    mod.ClientSession = ClientSession
    return mod


@BOTH
def test_json_rpc_eth_client(pkg, monkeypatch):
    ev = jevents if pkg == "jax" else events
    sent = []
    replies = {"eth_blockNumber": {"result": "0x1d4c0"},
               "eth_getLogs": {"result": [{"data": "0x00"}]},
               "eth_chainId": {"error": {"code": 1}}}
    monkeypatch.setitem(sys.modules, "aiohttp", _fake_aiohttp(replies, sent))
    client = ev.JsonRpcEthClient("http://eth.test")
    assert asyncio.run(client.latest_block_number()) == 120_000
    assert asyncio.run(client.get_logs("0xA", "0xT", 5, 300)) == [{"data": "0x00"}]
    with pytest.raises(RuntimeError):
        asyncio.run(client._call("eth_chainId", []))
    assert sent[1] == ("http://eth.test", {
        "jsonrpc": "2.0", "id": 2, "method": "eth_getLogs",
        "params": [{"address": "0xA", "topics": ["0xT"], "fromBlock": "0x5",
                    "toBlock": "0x12c"}]})


# -- tools ---------------------------------------------------------------------------

async def _tools_story(av, tl, chain, **device):
    client = af.client_class(av, chain)("ws://avail.test")
    return (await tl.genesis_params(client, 20), await tl.genesis_params(client),
            await tl.compute_block_range_data(client, 5, 20, 16, **device),
            await tl.compute_block_range_data(client, 30, 31, 1, **device))


def test_tools_equal_reference(chain):
    got = asyncio.run(_tools_story(avail_rpc, tools, chain, device="cpu"))
    assert got == asyncio.run(_tools_story(javail, jtools, chain))
    assert got[1]["height"] == HEAD and got[0]["authority_set_id"] == 1
    rng = np.random.default_rng(8)
    args = ([10, 20], [20, 30], [rng.bytes(32), rng.bytes(32)],
            [rng.bytes(32), rng.bytes(32)], 4, rng.bytes(32))
    calldata = tools.encode_update_block_range_calldata(*args)
    assert calldata == jtools.encode_update_block_range_calldata(*args)
    assert len(calldata) == 4 + 6 * 32 + 4 * 3 * 32
    with pytest.raises(ValueError):
        tools.encode_update_block_range_calldata([1], [2], [b"x"], [bytes(32)], 0,
                                                 bytes(32))


# -- optional dependencies ---------------------------------------------------------

NEW_MODULES = ["services.avail_rpc", "services.contract_sim", "services.entrypoint",
               "services.events", "services.grandpa", "services.indexer",
               "services.operator", "services.store", "services.tools",
               "utils.xxhash", "utils.profiling", "stark.watch", "runtime.native"]

WITHOUT_EXTRAS = """
import asyncio, importlib, sys
for name in ("websockets", "aiohttp", "redis", "cryptography"):
    sys.modules[name] = None
for name in sys.argv[1:]:
    importlib.import_module("vectorx_tpu_torch." + name)
from vectorx_tpu_torch.services import avail_rpc, events, store
for what, fn in [("websockets", lambda: asyncio.run(avail_rpc.AvailClient("ws://x").connect())),
                 ("aiohttp", lambda: asyncio.run(events.JsonRpcEthClient("http://x")._call("m", []))),
                 ("redis", lambda: store.RedisStore("redis://x"))]:
    try:
        fn()
    except ImportError:
        print("needs", what)
"""


def test_new_modules_import_without_optional_dependencies():
    out = subprocess.run([sys.executable, "-c", WITHOUT_EXTRAS, *NEW_MODULES],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:3] == ["needs websockets", "needs aiohttp",
                                          "needs redis"]
