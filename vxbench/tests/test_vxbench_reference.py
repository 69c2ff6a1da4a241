"""The plain reference on its own: Ed25519 against RFC 8032's vectors,
the chain hash against hashlib, Poseidon's two forms against each other,
and the STARK check on a proof of the port (accepted; refused when it is
altered or departs from the stated configuration)."""

import hashlib

import numpy as np
import pytest
import torch

from vxbench.reference import ed25519, goldilocks as gf, poseidon, sha256_chain

# RFC 8032 7.1, TEST 1-3: (secret, public key, message, signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("secret,pub,msg,sig", RFC8032)
def test_ed25519_rfc8032_vectors(secret, pub, msg, sig):
    secret, pub, msg, sig = (bytes.fromhex(v) for v in (secret, pub, msg, sig))
    assert ed25519.public_key(secret) == pub
    assert ed25519.sign(secret, msg) == (pub, sig)
    assert ed25519.verify(pub, msg, sig)
    bad = bytearray(sig)
    bad[40] ^= 1
    assert not ed25519.verify(pub, msg, bytes(bad))
    assert not ed25519.verify(pub, msg + b"x", sig)


def test_ed25519_lanes():
    msg = bytes(range(53))
    pub, sig = ed25519.sign(bytes(32), msg)
    lanes = ed25519.lanes([pub, pub], [sig, None], msg)
    assert lanes[1] == ed25519.dummy_lane()
    assert all(ed25519.lane_holds(lane) for lane in lanes)
    a, r, s, h = lanes[0]
    assert not ed25519.lane_holds((a, r, s, (h + 1) % ed25519.L))
    assert ed25519.shard_publics(lanes[:1], 2) == ed25519.shard_publics(
        lanes, 2)
    assert ed25519.shard_publics(lanes, 2)[0] == 2


def test_chain_hash_against_hashlib():
    keys = [bytes([i]) * 32 for i in range(5)]
    h = hashlib.sha256(keys[0]).digest()
    for k in keys[1:]:
        h = hashlib.sha256(h + k).digest()
    assert sha256_chain.chain_hash(keys) == h
    pubs = sha256_chain.chain_publics(keys, 5)
    assert pubs[0] == 5 and b"".join(
        w.to_bytes(4, "big") for w in pubs[1:]) == h
    assert sha256_chain.chain_publics(keys, 0) == [0] * 9


def test_goldilocks_against_python_ints():
    rng = np.random.default_rng(1)
    a = rng.integers(0, gf.P, 2000, dtype=np.uint64)
    b = rng.integers(0, gf.P, 2000, dtype=np.uint64)
    a[:3] = [0, 1, gf.P - 1]
    b[:3] = [gf.P - 1, gf.P - 1, gf.P - 1]
    for fn, op in ((gf.mul, lambda x, y: x * y), (gf.add, lambda x, y: x + y),
                   (gf.sub, lambda x, y: x - y)):
        got = fn(a, b)
        assert all(int(g) == op(int(x), int(y)) % gf.P
                   for g, x, y in zip(got, a, b))
    assert gf.sum_rows(a[None, :]) == [sum(int(x) for x in a) % gf.P]
    w = gf.root_of_unity(5)
    assert pow(w, 32, gf.P) == 1 and pow(w, 16, gf.P) != 1


def test_poseidon_numpy_against_ints():
    rng = np.random.default_rng(2)
    states = rng.integers(0, gf.P, (5, 12), dtype=np.uint64)
    got = poseidon.permute_np(states)
    for s, g in zip(states, got):
        assert poseidon.permute_ints([int(v) for v in s]) == [int(v) for v in g]
    rows = rng.integers(0, gf.P, (3, 11), dtype=np.uint64)
    state = [0] * 12
    for i in (0, 8):
        chunk = [int(v) for v in rows[1, i:i + 8]]
        state = poseidon.permute_ints(chunk + [0] * (8 - len(chunk))
                                      + state[8:])
    assert [int(v) for v in poseidon.hash_rows(rows)[0][1]] == state[:4]


@pytest.fixture(scope="module")
def chain_proof():
    """A ChainedSha256Air(4) proof of the port on the CPU, at 9 queries
    and 4 bits of grinding."""
    torch.set_num_threads(2)
    from vectorx_tpu_torch.field import goldilocks as pgl
    from vectorx_tpu_torch.stark import prover
    from vectorx_tpu_torch.stark.air_sha256_chain import ChainedSha256Air
    from vxbench import proofs, stark_job
    air = ChainedSha256Air(4)
    keys = [bytes([7 * i + 1]) * 32 for i in range(4)]
    trace, publics, _ = air.make_trace(air.pubkeys_to_words(keys, 4), 4, "cpu")
    cfg = prover.StarkConfig(rate_bits=2, num_queries=9, final_poly_len=8,
                             pow_bits=4)
    proof = prover.prove(air, trace, [pgl.to_fp(int(p), "cpu")
                                      for p in publics], cfg)
    shape = {"log_n": 10, "num_cols": 314, "n_aux": 0, "n_consts": 10,
             "n_chunks": 2}
    guarantee = {"rate_bits": 2, "num_queries": 9, "final_poly_len": 8,
                 "cap_height": 0, "pow_bits": 4}
    return (proof, sha256_chain.chain_publics(keys, 4), shape, guarantee,
            stark_job.vk_cap(air, cfg, "cpu"), proofs)


def test_stark_check_accepts_the_port_proof(chain_proof):
    from vxbench.reference import stark
    proof, publics, shape, guarantee, vk, proofs = chain_proof
    assert stark.check(proofs.as_arrays(proof), publics, shape, guarantee,
                       vk, sha256_chain.constant_columns(4)) == []


@pytest.mark.parametrize("change", ["row", "publics", "queries", "grinding",
                                    "rate", "vk", "constants"])
def test_stark_check_refuses(chain_proof, change):
    from vxbench.reference import stark
    proof, publics, shape, guarantee, vk, proofs = chain_proof
    constants = sha256_chain.constant_columns(4)
    arrays = proofs.as_arrays(proof)
    if change == "row":
        arrays = proofs.as_arrays(proofs.tampered(proof, "quot_rows_b"))
    elif change == "publics":
        publics = publics[:1] + [publics[1] ^ 1] + publics[2:]
    elif change == "queries":
        guarantee = dict(guarantee, num_queries=10)
    elif change == "grinding":
        guarantee = dict(guarantee, pow_bits=20)
    elif change == "rate":
        guarantee = dict(guarantee, rate_bits=3)
    elif change == "vk":
        vk = vk.copy()
        vk[0, 0] ^= 1
    else:
        constants[9, 5] ^= 1
    assert stark.check(arrays, publics, shape, guarantee, vk, constants)


def test_false_statement_fails_only_the_constraints():
    """The chain's witness under a digest the reference refutes: the
    reference's check (transcript, grinding, commitments, FRI, DEEP,
    constants) passes it, the port's verifier refuses it, and a verifier
    without its constraints at ζ accepts it."""
    torch.set_num_threads(2)
    from vxbench import faults, proofs, stark_job
    from vxbench.jobs import authority_chains as kind
    from vxbench.reference import stark
    cfg = stark_job.prover.StarkConfig(rate_bits=2, num_queries=9,
                                       final_poly_len=8, pow_bits=4)
    job = {"keys": [bytes([3 * i + 2]) * 32 for i in range(4)], "active": 3}
    ctx = {"n_max": 4, "device": torch.device("cpu")}
    air, trace, publics, verifier_air = kind.false_statement(job, ctx)
    assert publics != sha256_chain.chain_publics(job["keys"], 3)
    proof = stark_job.prove(air, trace, publics, cfg)
    shape = {"log_n": 10, "num_cols": 314, "n_aux": 0, "n_consts": 10,
             "n_chunks": 2}
    guarantee = {"rate_bits": 2, "num_queries": 9, "final_poly_len": 8,
                 "cap_height": 0, "pow_bits": 4}
    assert stark.check(proofs.as_arrays(proof), publics, shape, guarantee,
                       stark_job.vk_cap(verifier_air, cfg, "cpu"),
                       sha256_chain.constant_columns(4)) == []
    assert not stark_job.verify(verifier_air, proof, publics, cfg)
    with faults.planted("verifier_skips_ali", None):
        assert stark_job.verify(verifier_air, proof, publics, cfg)


def test_sha256_round_constants():
    k = sha256_chain.round_constants()
    assert (k[0], k[1], k[63]) == (0x428A2F98, 0x71374491, 0xC67178F2)


@pytest.mark.parametrize("n_max", [1, 2, 5, 300])
def test_chain_constants_are_the_port_statement(n_max):
    from vectorx_tpu_torch.stark.air_sha256_chain import ChainedSha256Air
    air = ChainedSha256Air(n_max)
    assert np.array_equal(air.constant_columns(air.n_rows),
                          sha256_chain.constant_columns(n_max))


@pytest.mark.parametrize("bits", [8, 9, 13])
def test_ed25519_constants_are_the_port_statement(bits):
    from vectorx_tpu_torch.stark.air_ed25519 import Ed25519VerifyAir
    from vxbench.jobs import ed25519_shards as kind
    _, pool = kind.make_pool(2 ** 31 + 5, {"slots": 5, "signers": 3},
                             {"ed25519_shard_bits": 8})
    job = pool[0]
    lanes = ed25519.lanes(job["pubs"], job["sigs"], job["message"])
    air = Ed25519VerifyAir(job["lanes"], B=bits)
    assert np.array_equal(air.constant_columns(air.n_rows),
                          ed25519.constant_columns(lanes, bits))


def test_interpolation_against_python_ints():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 2 ** 63, (3, 16)).astype(np.uint64) % np.uint64(
        gf.P)
    coeffs = gf.coefficients(vals)
    g = gf.root_of_unity(4)
    for row, cs in zip(vals, coeffs):
        for i, v in enumerate(row):
            x = pow(g, i, gf.P)
            assert sum(int(c) * pow(x, j, gf.P)
                       for j, c in enumerate(cs)) % gf.P == int(v)
    z = (123456789, 987654321)
    for cs, got in zip(coeffs, gf.evaluate(coeffs, z)):
        acc = (0, 0)
        for c in reversed(cs):
            acc = gf.e_add(gf.e_mul(acc, z), (int(c), 0))
        assert got == acc
