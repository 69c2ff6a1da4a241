"""The port's CLI (``python -m vectorx_tpu_torch``) on a fixture directory.

The test writes a directory in the ``FixtureSource`` layout ({block}.header
hex files, meta.json, justifications.json and input files) from seeded
bytes: a trusted block and three chained headers after it, a
justification at the target by four authorities with three signed
(cryptography's ``from_private_bytes`` on seeded bytes), and an epoch-end
header that schedules five new keys, justified by the same four. Then,
through the port's ``main([...])`` with ``--device cpu``:

- ``dummy_header_range``, ``dummy_rotate`` and ``genesis`` print the same
  JSON as the JAX package's ``main`` (host code on both sides);
- the witness-level ``header_range`` and ``rotate prove`` routes give the
  host values (hashlib's Blake2b, ``range_commitments``,
  ``authority_set_hash``) with ``--tree-size 8`` (the CLI's slots are a
  fixed 35,840 bytes and its lanes a fixed 300), and a wrong set hash
  exits non-zero;
- ``build`` writes the JAX package's manifest.json and config.json byte
  for byte (their SHA-256 below is that of the JAX package's
  ``build_program`` for the same arguments; the ``slow`` test recomputes
  them, as the JAX build takes minutes on a CPU);
- without ``--fixtures`` and ``AVAIL_URL`` the CLI exits with the JAX
  package's message, without a card and ``--device`` it refuses, and
  ``--help`` runs;
- the live source (``AVAIL_URL``) over a fake node (``tests/avail_fake.py``,
  a small chain: 3 headers, tree size 16, 4 authorities, the target an
  epoch end) gives the fixtures route's ``header_range`` output, and each
  of its source methods gives the JAX package's live source's value.

The ``slow`` tests hold the witness routes' JSON against ``python -m
vectorx_tpu`` (the JAX package compiles its 300-lane verification) and run
the ``--stark`` route, whose bundle proves ChainedSha256Air(300) at the
CLI's fixed width.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu_torch.circuits import commitments, scale
from vectorx_tpu_torch.circuits.abi import HeaderRangeInput, RotateInput
from vectorx_tpu_torch.services import entrypoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUSTED, N_HEADERS, SET_ID, EPOCH_END, ROT_SET_ID = 5000, 3, 7, 5100, 8

# sha256 of the JAX package's build_program artifacts (tree size 8,
# max chunks 2, the CLI's 300 authorities); see test_build_equals_reference
BUILD_SHA256 = {
    "header_range": (
        "e77a9904fe0a0d7a6204488663b6e2acf4d84031d35d5482fc2062db20239b64",
        "cf55044f807c2b8765b91490e08cb7b964f04ade6e6817e2484041412e6920fd"),
    "rotate": (
        "6c927b62c41c46befb7b4b15ccf47777ed5eef86a295a375946d22b5415e1d23",
        "cf55044f807c2b8765b91490e08cb7b964f04ade6e6817e2484041412e6920fd"),
}


def _keys(n, rng):
    keys = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
            for _ in range(n)]
    return keys, [k.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        for k in keys]


def _record(keys, pubs, block_hash, block, set_id, n_sign):
    msg = scale.encode_precommit_bytes(block_hash, block, 1, set_id)
    return dict(block_number=block, signed_message=msg.hex(),
                pubkeys=[p.hex() for p in pubs],
                signatures=[k.sign(msg).hex() if i < n_sign else
                            bytes(64).hex() for i, k in enumerate(keys)],
                num_authorities=len(keys),
                validator_signed=[i < n_sign for i in range(len(keys))])


def _epoch_end_header(rng, new_pubs):
    validators = b"".join(p + b"\x01" + bytes(7) for p in new_pubs)
    sched = (b"\x01" + scale.encode_compact_u32(len(new_pubs)) + validators
             + bytes(4))
    log = b"\x04" + b"FRNK" + scale.encode_compact_u32(len(sched)) + sched
    return (rng.bytes(32) + scale.encode_compact_u32(EPOCH_END)
            + rng.bytes(72) + b"\x00" + log + rng.bytes(32))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixtures")
    rng = np.random.default_rng(71)
    keys, pubs = _keys(4, rng)
    headers = {TRUSTED: rng.bytes(120)}
    parent = hashlib.blake2b(headers[TRUSTED], digest_size=32).digest()
    for b in range(TRUSTED + 1, TRUSTED + 1 + N_HEADERS):
        body = parent + scale.encode_compact_u32(b) + rng.bytes(200)
        headers[b] = body
        parent = hashlib.blake2b(body, digest_size=32).digest()
    target = TRUSTED + N_HEADERS
    _, new_pubs = _keys(5, rng)
    headers[EPOCH_END] = _epoch_end_header(rng, new_pubs)
    epoch_hash = hashlib.blake2b(headers[EPOCH_END], digest_size=32).digest()
    for b, h in headers.items():
        (d / f"{b}.header").write_text(h.hex())
    auth_hex = [p.hex() for p in pubs]
    (d / "meta.json").write_text(json.dumps({
        "last_justified": {str(ROT_SET_ID): EPOCH_END},
        "authority_set_id": {str(TRUSTED): SET_ID, str(EPOCH_END): ROT_SET_ID},
        "authorities": {str(TRUSTED): auth_hex,
                        str(EPOCH_END): [p.hex() for p in new_pubs]}}))
    (d / "justifications.json").write_text(json.dumps({
        str(target): _record(keys, pubs, parent, target, SET_ID, 3),
        str(EPOCH_END): _record(keys, pubs, epoch_hash, EPOCH_END,
                                ROT_SET_ID, 3)}))
    set_hash = commitments.authority_set_hash(pubs)
    trusted_hash = hashlib.blake2b(headers[TRUSTED], digest_size=32).digest()
    inputs = {
        "hr": HeaderRangeInput(TRUSTED, trusted_hash, SET_ID, set_hash, target),
        "hr_wrong_set": HeaderRangeInput(TRUSTED, trusted_hash, SET_ID,
                                         bytes(32), target),
        "rot": RotateInput(ROT_SET_ID, set_hash),
    }
    for name, inp in inputs.items():
        (d / f"{name}.json").write_text(
            json.dumps({"input": "0x" + inp.encode().hex()}))
    fields = [scale.decode_header_bytes(headers[b])
              for b in range(TRUSTED + 1, target + 1)]
    want_hr = parent + b"".join(commitments.range_commitments(
        [f["state_root"] for f in fields], [f["data_root"] for f in fields], 8))
    return dict(dir=d, want_hr=want_hr,
                want_rot=commitments.authority_set_hash(new_pubs))


def _port(args, capsys):
    assert entrypoint.main(args) == 0
    return json.loads(capsys.readouterr().out)


def _prove(fixture_dir, capsys, program, inp, *extra):
    d = fixture_dir["dir"]
    return _port([program, "prove", str(d / f"{inp}.json"), "--fixtures",
                  str(d), "--device", "cpu", "--output",
                  str(d / f"out_{program}_{inp}.json"), *extra], capsys)


def _jax_main(args, capsys):
    from vectorx_tpu.services import entrypoint as jentry
    assert jentry.main(args) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("program,inp", [("dummy_header_range", "hr"),
                                         ("dummy_rotate", "rot")])
def test_dummy_programs_equal_reference(fixture_dir, capsys, program, inp):
    d = fixture_dir["dir"]
    args = [program, "prove", str(d / f"{inp}.json"), "--fixtures", str(d),
            "--tree-size", "8", "--output", str(d / "out_dummy.json")]
    got = _port(args + ["--device", "cpu"], capsys)
    assert got == _jax_main(args, capsys)
    want = fixture_dir["want_hr" if inp == "hr" else "want_rot"]
    assert got["output"] == "0x" + want.hex()


@pytest.mark.parametrize("block", [TRUSTED, EPOCH_END])
def test_genesis_equals_reference(fixture_dir, capsys, block):
    args = ["genesis", "--fixtures", str(fixture_dir["dir"]), "--block",
            str(block)]
    assert _port(args + ["--device", "cpu"], capsys) == _jax_main(args, capsys)


def test_header_range_prove_gives_the_host_values(fixture_dir, capsys):
    got = _prove(fixture_dir, capsys, "header_range", "hr", "--tree-size", "8")
    assert got == {"output": "0x" + fixture_dir["want_hr"].hex(), "ok": True}
    d = fixture_dir["dir"]
    assert json.loads((d / "out_header_range_hr.json").read_text()) == got


def test_rotate_prove_gives_the_new_set_hash(fixture_dir, capsys):
    got = _prove(fixture_dir, capsys, "rotate", "rot")
    assert got == {"output": "0x" + fixture_dir["want_rot"].hex(), "ok": True}


def test_header_range_wrong_set_hash_exits_non_zero(fixture_dir, capsys):
    with pytest.raises(SystemExit) as err:
        _prove(fixture_dir, capsys, "header_range", "hr_wrong_set",
               "--tree-size", "8")
    assert err.value.code == "header_range verification FAILED"


@pytest.mark.parametrize("program", ["header_range", "rotate"])
def test_build_writes_the_reference_artifacts(tmp_path, capsys, program):
    out = _port([program, "build", "--tree-size", "8", "--max-chunks", "2",
                 "--artifacts", str(tmp_path), "--device", "cpu"], capsys)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert out["built"] == program and set(out["airs"]) == set(manifest["airs"])
    got = tuple(hashlib.sha256((tmp_path / f).read_bytes()).hexdigest()
                for f in ("manifest.json", "config.json"))
    assert got == BUILD_SHA256[program]


@pytest.mark.parametrize("program", ["header_range", "rotate"])
def test_build_warm_proves_each_air_that_has_a_probe(tmp_path, monkeypatch,
                                                     program):
    """build --warm proves one probe witness per AIR; RotateHeaderAir has
    none and is skipped (the JAX package's build raises TypeError there).
    The proves are recorded, not run: each is a full-size proof."""
    from vectorx_tpu_torch.stark import prover
    proved = []
    monkeypatch.setattr(prover, "prove", lambda air, trace, pubs, cfg:
                        proved.append((type(air).__name__, trace.device)))
    manifest = entrypoint.build_program(program, 8, 2, str(tmp_path),
                                        warm=True, max_authorities=4,
                                        device="cpu")
    kinds = {a["air"] for a in manifest["airs"].values()}
    assert {name for name, _ in proved} == kinds - {"RotateHeaderAir"}
    assert len(proved) == len(kinds) - (program == "rotate")
    assert all(dev == torch.device("cpu") for _, dev in proved)


def test_without_fixtures_the_live_source_is_refused(fixture_dir, monkeypatch):
    """Without --fixtures and AVAIL_URL both CLIs exit with one message."""
    from vectorx_tpu.services import entrypoint as jentry
    monkeypatch.delenv("AVAIL_URL", raising=False)
    d = fixture_dir["dir"]
    exits = []
    for main, extra in ((entrypoint.main, ["--device", "cpu"]), (jentry.main, [])):
        with pytest.raises(SystemExit) as err:
            main(["header_range", "prove", str(d / "hr.json"), *extra])
        exits.append(err.value.code)
    assert exits == ["set AVAIL_URL or pass --fixtures"] * 2


# -- the live source (AVAIL_URL) over a fake node --------------------------------

LIVE_TRUSTED, LIVE_HEADERS, LIVE_SET_ID = 5000, 3, 4


@pytest.fixture(scope="module")
def live_chain(tmp_path_factory):
    """A node's view of a small chain (tests/avail_fake.py): well-formed
    headers LIVE_TRUSTED..target, the target an epoch end (the set id
    changes there and its header schedules new keys), 4 authorities with
    3 signing the target, a finality proof for it; and the same data as a
    FixtureSource directory."""
    import avail_fake as af
    rng = np.random.default_rng(29)
    target = LIVE_TRUSTED + LIVE_HEADERS
    keys, pubs = af.make_keys(4, rng)
    _, new_pubs = af.make_keys(2, rng)
    headers, parent = {}, rng.bytes(32)
    for n in range(LIVE_TRUSTED, target + 1):
        logs = [b"\x06BABE" + scale.encode_compact_u32(48) + rng.bytes(48)]
        if n == target:
            logs.insert(0, af.scheduled_change_log(new_pubs))
        headers[n] = af.header_json(parent, n, rng, logs)
        parent = hashlib.blake2b(af.encode_header(headers[n]), digest_size=32).digest()
    record = _record(keys, pubs, parent, target, LIVE_SET_ID, 3)
    chain = af.FakeAvailChain(
        headers, lambda n: LIVE_SET_ID + (n >= target),
        lambda n: pubs if n < target else new_pubs,
        {target: af.finality_proof(parent, target, 1, [
            (bytes.fromhex(record["signatures"][i]), pubs[i]) for i in range(3)])})

    d = tmp_path_factory.mktemp("live_fixtures")
    for n in headers:
        (d / f"{n}.header").write_text(chain.scale_header(n).hex())
    (d / "meta.json").write_text(json.dumps({
        "last_justified": {str(LIVE_SET_ID): target},
        "authority_set_id": {str(LIVE_TRUSTED): LIVE_SET_ID},
        "authorities": {str(LIVE_TRUSTED): [p.hex() for p in pubs]}}))
    (d / "justifications.json").write_text(json.dumps({str(target): record}))
    inp = HeaderRangeInput(
        LIVE_TRUSTED, hashlib.blake2b(chain.scale_header(LIVE_TRUSTED),
                                      digest_size=32).digest(),
        LIVE_SET_ID, commitments.authority_set_hash(pubs), target)
    (d / "hr.json").write_text(json.dumps({"input": "0x" + inp.encode().hex()}))
    fields = [scale.decode_header_bytes(chain.scale_header(n))
              for n in range(LIVE_TRUSTED + 1, target + 1)]
    want = parent + b"".join(commitments.range_commitments(
        [f["state_root"] for f in fields], [f["data_root"] for f in fields], 16))
    return dict(chain=chain, dir=d, want=want, record=record)


def test_live_source_header_range_equals_the_fixtures_route(live_chain, capsys,
                                                            monkeypatch):
    """AVAIL_URL with a fake node gives the fixtures route's output; the
    target's justification comes through grandpa_proveFinality."""
    import avail_fake as af
    from vectorx_tpu_torch.services import avail_rpc
    d = live_chain["dir"]
    args = ["header_range", "prove", str(d / "hr.json"), "--tree-size", "16",
            "--device", "cpu", "--output", str(d / "out.json")]
    fixtures = _port(args + ["--fixtures", str(d)], capsys)
    monkeypatch.setenv("AVAIL_URL", "ws://avail.test")
    monkeypatch.delenv("REDIS_URL", raising=False)
    monkeypatch.setattr(avail_rpc, "AvailClient",
                        af.client_class(avail_rpc, live_chain["chain"]))
    assert _port(args, capsys) == fixtures == {
        "output": "0x" + live_chain["want"].hex(), "ok": True}
    assert ("grandpa_proveFinality", [LIVE_TRUSTED + LIVE_HEADERS]) in \
        live_chain["chain"].calls


def test_live_source_methods_equal_the_jax_live_source(live_chain, monkeypatch):
    """Every source method of both packages' live sources under one fake
    node, the stored justification read from a fake Redis (the JAX
    package's epoch-end record needs its verify, which compiles for
    minutes on a CPU). The JAX source asks asyncio for the thread's
    current loop, so the test sets one."""
    import asyncio

    import avail_fake as af
    from vectorx_tpu.services import avail_rpc as javail
    from vectorx_tpu.services import entrypoint as jentry
    from vectorx_tpu_torch.services import avail_rpc, store
    chain, target = live_chain["chain"], LIVE_TRUSTED + LIVE_HEADERS
    servers = {}
    monkeypatch.setitem(sys.modules, "redis", af.fake_redis_module(servers))
    monkeypatch.setenv("AVAIL_URL", "ws://avail.test")
    monkeypatch.setenv("REDIS_URL", "redis://fake")
    stored = dict(live_chain["record"], block_number=target - 1)
    store.RedisStore("redis://fake").add_justification(
        store.StoredJustification(**stored))
    for mod in (javail, avail_rpc):
        monkeypatch.setattr(mod, "AvailClient", af.client_class(mod, chain))

    def every_method(source):
        return (source.get_header(target - 1),
                source.get_roots_range(LIVE_TRUSTED, target),
                source.get_authorities(LIVE_TRUSTED),
                [source.get_authority_set_id(n) for n in (LIVE_TRUSTED, target)],
                [source.last_justified_block(s) for s in (LIVE_SET_ID, LIVE_SET_ID + 1)],
                dataclasses.asdict(source.get_justification_record(target - 1)),
                source.get_rotate_data(LIVE_SET_ID))

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    try:
        want = every_method(jentry._live_source())
    finally:
        asyncio.set_event_loop(None)
        loop.close()
    source = entrypoint._live_source("cpu")
    try:
        got = every_method(source)
    finally:
        source.close()
    assert got == want
    assert got[4] == [target, 0] and got[5] == stored
    assert got[6][:2] == (target, chain.scale_header(target))


def test_without_a_card_the_device_must_be_named(fixture_dir, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = fixture_dir["dir"]
    with pytest.raises(SystemExit) as err:
        entrypoint.main(["header_range", "prove", str(d / "hr.json"),
                         "--fixtures", str(d)])
    assert err.value.code == 2
    assert "found none" in capsys.readouterr().err


def test_module_help_runs():
    out = subprocess.run([sys.executable, "-m", "vectorx_tpu_torch", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "--device" in out.stdout and "--fixtures" in out.stdout


@pytest.mark.slow
@pytest.mark.parametrize("program,inp", [("header_range", "hr"),
                                         ("rotate", "rot")])
def test_witness_routes_equal_the_jax_cli(fixture_dir, capsys, program, inp):
    d = fixture_dir["dir"]
    args = [program, "prove", str(d / f"{inp}.json"), "--fixtures", str(d),
            "--tree-size", "8", "--output", str(d / "out_slow.json")]
    assert _port(args + ["--device", "cpu"], capsys) == _jax_main(args, capsys)


@pytest.mark.slow
@pytest.mark.parametrize("program", ["header_range", "rotate"])
def test_build_equals_reference(tmp_path, program):
    from vectorx_tpu.services import entrypoint as jentry
    jentry.build_program(program, 8, 2, str(tmp_path / "jax"))
    entrypoint.build_program(program, 8, 2, str(tmp_path / "port"))
    for f in ("manifest.json", "config.json"):
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes()


@pytest.mark.slow
def test_stark_route_proves_and_verifies(fixture_dir, capsys, tmp_path):
    from vectorx_tpu_torch.stark import statements
    from vectorx_tpu_torch.stark.prover import StarkConfig
    proof = tmp_path / "bundle.bin"
    got = _prove(fixture_dir, capsys, "header_range", "hr", "--tree-size",
                 "16", "--stark", "--proof", str(proof))
    hr = HeaderRangeInput.decode(bytes.fromhex(json.loads(
        (fixture_dir["dir"] / "hr.json").read_text())["input"][2:]))
    bundle, cfg = statements.deserialize_header_range(proof.read_bytes(),
                                                      device="cpu")
    assert cfg == StarkConfig()
    outs = statements.verify_header_range(
        bundle, hr.trusted_block, hr.trusted_header_hash, hr.authority_set_id,
        hr.authority_set_hash, hr.target_block, cfg, device="cpu")
    assert got["output"] == "0x" + b"".join(outs).hex()
    assert outs[0] == fixture_dir["want_hr"][:32]
