"""The port's header_range bundle end to end, on the CPU (port only).

One bundle is proved in a module-scoped fixture at the sizes of
tests/test_statements.py (two chained 150-byte headers, HeaderAir(2),
2-leaf range trees, Ed25519 and SHA-512 shards of one lane, B = 8, rate 1,
4 queries) but for the authority set: one key, which signs, where the JAX
test has two. Each signer adds an Ed25519VerifyAir(B = 8) proof of 6683
trace and 6450 aux columns, minutes of one CPU thread to prove and verify
(the plain Poseidon sponge of its commitments takes most of it), so one
signer halves the file's time. The keys come from seeded bytes
(Ed25519PrivateKey.from_private_bytes).
The cases of tests/test_statements.py, one for one: the outputs equal
blake2b and commitments.range_commitments; a broken chain link, a wrong
target block, a wrong authority set, a forged Merkle leaf and an unsigned
majority raise VerificationError; the serialization round trip. Also the
checkpoint store (a second prove with the same directory reads every
sub-proof back), the precommit codec against the JAX package's, the
``procs`` and ``device`` arguments, and the test signer of chip_smoke.py
against cryptography's.

No JAX bundle is proved here: payload parity with the JAX package is held
for each sub-proof's AIR in the earlier files (test_torch_header.py,
test_torch_statement_*.py, test_torch_ed25519_*.py), and the bundle code
adds host checks only.
"""

import dataclasses
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu.circuits import scale as jscale
from vectorx_tpu_torch.circuits import commitments, scale
from vectorx_tpu_torch.stark import air_header as ah
from vectorx_tpu_torch.stark import serialize
from vectorx_tpu_torch.stark import statements as st
from vectorx_tpu_torch.stark.air_ed25519 import dummy_sig
from vectorx_tpu_torch.stark.prover import StarkConfig

torch.set_num_threads(1)

RNG = np.random.default_rng(31)
CFG = StarkConfig(rate_bits=1, num_queries=4, final_poly_len=4)
TRUSTED_BLOCK = 128
N_HEADERS = 2
TREE = 2
MAX_CHUNKS = 2
N_AUTH = 1          # signs: 1*3 > 1*2 meets the threshold
SET_ID = 11
ROUND = 1


def make_chain(trusted_hash: bytes, trusted_block: int, n: int, size: int):
    """SCALE-shaped headers forming a valid blake2b chain."""
    headers, metas = [], []
    parent = trusted_hash
    for i in range(n):
        state_root, data_root = RNG.bytes(32), RNG.bytes(32)
        body = (parent + scale.encode_compact_u32(trusted_block + 1 + i)
                + state_root)
        header = body + RNG.bytes(size - len(body) - 32) + data_root
        headers.append(header)
        metas.append(dict(state_root=state_root, data_root=data_root))
        parent = hashlib.blake2b(header, digest_size=32).digest()
    return headers, metas, parent


def seeded_keys(rng, n: int):
    """n keys made from seeded bytes, and their public keys."""
    keys = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
            for _ in range(n)]
    return keys, [k.public_key().public_bytes(serialization.Encoding.Raw,
                                              serialization.PublicFormat.Raw)
                  for k in keys]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    trusted_hash = RNG.bytes(32)
    headers, metas, target_hash = make_chain(trusted_hash, TRUSTED_BLOCK,
                                             N_HEADERS, 150)
    keys, pubs = seeded_keys(RNG, N_AUTH)
    msg = scale.encode_precommit_bytes(target_hash, TRUSTED_BLOCK + N_HEADERS,
                                       ROUND, SET_ID)
    sigs = [k.sign(msg) for k in keys]
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    args = (TRUSTED_BLOCK, TRUSTED_BLOCK + N_HEADERS, headers, pubs, sigs,
            SET_ID, ROUND, CFG)
    kwargs = dict(tree_size=TREE, max_chunks=MAX_CHUNKS,
                  max_authorities=N_AUTH, device="cpu", checkpoint=ckpt)
    bundle = st.prove_header_range(*args, **kwargs)
    return dict(trusted_hash=trusted_hash, metas=metas, target_hash=target_hash,
                pubs=pubs, bundle=bundle, args=args, kwargs=kwargs)


def _verify(s, bundle=None, target=TRUSTED_BLOCK + N_HEADERS, set_hash=None):
    return st.verify_header_range(
        bundle or s["bundle"], TRUSTED_BLOCK, s["trusted_hash"], SET_ID,
        set_hash or commitments.authority_set_hash(s["pubs"]), target, CFG,
        device="cpu")


def test_bundle_verifies_and_matches_reference_outputs(setup):
    target_hash, state_c, data_c = _verify(setup)
    assert target_hash == setup["target_hash"]
    want = commitments.range_commitments(
        [m["state_root"] for m in setup["metas"]],
        [m["data_root"] for m in setup["metas"]], TREE)
    assert (state_c, data_c) == tuple(want)
    b = setup["bundle"]
    assert len(b.sig_proofs) == len(b.sha512_proofs) == N_AUTH


def test_bundle_rejects_broken_chain_link(setup):
    b = setup["bundle"]
    bad_pub = [list(p) for p in b.header_publics]
    # claim a different parent hash for header 1 (γs honestly re-derived)
    bad_pub[1][ah.P_PARENT] = (bad_pub[1][ah.P_PARENT] + 1) % (1 << 32)
    bad_pub[1][ah.P_G1], bad_pub[1][ah.P_G2] = ah.derive_gammas(
        bad_pub[1][:ah.P_G1], "cpu")
    with pytest.raises(st.VerificationError, match="chain link"):
        _verify(setup, dataclasses.replace(b, header_publics=bad_pub))


def test_bundle_rejects_wrong_target_block(setup):
    with pytest.raises(st.VerificationError):
        _verify(setup, target=TRUSTED_BLOCK + N_HEADERS + 1)


def test_bundle_rejects_wrong_authority_set(setup):
    with pytest.raises(st.VerificationError, match="authority-set"):
        _verify(setup, set_hash=hashlib.sha256(b"not the set").digest())


def test_bundle_rejects_forged_merkle_leaf(setup):
    b = setup["bundle"]
    pub = [int(p) for p in b.state_merkle_publics]
    pub[0] = (pub[0] + 1) % (1 << 32)
    with pytest.raises(st.VerificationError, match="state merkle leaves"):
        _verify(setup, dataclasses.replace(b, state_merkle_publics=pub))


def test_bundle_rejects_unsigned_majority(setup):
    b = setup["bundle"]
    # flip one lane to unsigned: its lane no longer matches a dummy claim
    with pytest.raises(st.VerificationError, match="must be dummy"):
        _verify(setup, dataclasses.replace(b, signed=[False]))
    # and with the lane made a dummy too, 0*3 is not > 1*2
    with pytest.raises(st.VerificationError, match="2/3 threshold"):
        _verify(setup, dataclasses.replace(b, signed=[False],
                                           shard_sigs=[[dummy_sig()]]))


def test_bundle_serialization_round_trip(setup):
    b = setup["bundle"]
    blob = st.serialize_header_range(b, CFG)
    back, cfg = st.deserialize_header_range(blob, "cpu")
    assert cfg == CFG
    for f in dataclasses.fields(b):
        got, want = getattr(back, f.name), getattr(b, f.name)
        if f.name.endswith("proof"):
            assert serialize.payload(got) == serialize.payload(want)
        elif f.name.endswith("proofs"):
            assert ([serialize.payload(p) for p in got]
                    == [serialize.payload(p) for p in want])
        else:
            assert got == want, f.name
    assert st.serialize_header_range(back, CFG) == blob
    with pytest.raises(ValueError):
        st.deserialize_header_range(b"VXB0" + blob[4:], "cpu")


def test_checkpoint_reads_every_sub_proof_back(setup):
    """A second prove with the same checkpoint directory proves nothing
    and gives the same bundle."""
    again = st.prove_header_range(*setup["args"], **setup["kwargs"])
    b = setup["bundle"]
    assert st.serialize_header_range(again, CFG) == st.serialize_header_range(
        b, CFG)


def test_checkpoint_key_equals_reference():
    """The store keys a sub-proof as the JAX package's store does (its
    blobs are the port's own serialize_proof)."""
    from vectorx_tpu.stark import checkpoint as jckpt
    from vectorx_tpu.stark.prover import StarkConfig as JStarkConfig
    from vectorx_tpu_torch.stark import checkpoint
    parts = (b"header bytes", b"16")
    assert checkpoint.Checkpoint(None)._key("hdr", CFG, parts) == \
        jckpt.Checkpoint(None)._key("hdr", JStarkConfig(**vars(CFG)), parts)


def test_parallel_arguments_procs_and_device_list(setup, monkeypatch):
    """procs > 1 sends the header proofs to worker processes, which hand
    them back through the checkpoint (here the fixture's, which holds every
    one: the workers find them and the bundle is the fixture's); without a
    checkpoint it refuses, as the JAX package does. A list of devices
    spreads the sub-proofs round-robin (header i on device i, the trees and
    the chain after the headers): over two devices, each the CPU, every
    sub-proof comes from the checkpoint on its slot's device and the bundle
    is the one-device bundle's bytes."""
    args, kwargs = setup["args"], setup["kwargs"]
    again = st.prove_header_range(*args, **dict(kwargs, procs=2))
    want = st.serialize_header_range(setup["bundle"], CFG)
    assert st.serialize_header_range(again, CFG) == want
    no_ckpt = dict(kwargs, checkpoint=None)
    with pytest.raises(AssertionError, match="checkpoint"):
        st.prove_header_range(*args, **dict(no_ckpt, procs=2))
    loads = []
    load = st.Checkpoint.load

    def recording_load(self, label, config, parts, air, device=None):
        loads.append((label, device))
        return load(self, label, config, parts, air, device)

    two = [torch.device("cpu"), torch.device("cpu", 0)]
    monkeypatch.setattr(st.Checkpoint, "load", recording_load)
    spread = st.prove_header_range(*args, **dict(kwargs, device=two))
    assert st.serialize_header_range(spread, CFG) == want
    slots = list(range(N_HEADERS)) + [N_HEADERS, N_HEADERS + 1,
                                      N_HEADERS + 2, 0, 0]
    assert loads == [(label, two[i % 2]) for label, i in zip(
        ["hdr"] * N_HEADERS + ["merkle", "merkle", "chain", "sig", "sha512"],
        slots)]


@pytest.mark.parametrize("block", [0, 1, 0xFFFFFFFF])
def test_precommit_codec_equal_reference(block):
    h = RNG.bytes(32)
    enc = scale.encode_precommit_bytes(h, block, 2**64 - 1, 7)
    assert enc == jscale.encode_precommit_bytes(h, block, 2**64 - 1, 7)
    assert len(enc) == 53
    assert scale.decode_precommit_bytes(enc) == (h, block, 2**64 - 1, 7)
    assert scale.decode_precommit_bytes(enc) == jscale.decode_precommit_bytes(enc)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(8))
def test_chip_smoke_signer_equals_cryptography(seed):
    """chip_smoke.py signs with its own RFC 8032 signer (the card's machine
    has no cryptography package); its bytes must be cryptography's."""
    rng = np.random.default_rng(seed)
    secret, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 120)))
    key = Ed25519PrivateKey.from_private_bytes(secret)
    pub = key.public_key().public_bytes(serialization.Encoding.Raw,
                                        serialization.PublicFormat.Raw)
    signer = _chip_smoke()
    assert signer.ed25519_sign(secret, msg) == (pub, key.sign(msg))
    assert signer.ed25519_public_key(secret) == pub
