"""Port vs reference: the STARK prover/verifier on FibonacciAir.

The same trace, publics and StarkConfig go through vectorx_tpu.stark (JAX,
CPU) and vectorx_tpu_torch.stark (torch, CPU). The proofs' serialized
payloads must be equal byte for byte, each verifier must accept the other
package's proof, and the port verifier must reject tampered proofs. The
JAX package's proofs and its verifier's verdicts are recorded
(tests/reference_data/test_torch_stark.json, made by
tests/reference_data/record.py); with the payloads equal, the JAX verifier's
verdict on its own proof is its verdict on the port's.
"""

import pytest
import torch

from vectorx_tpu_torch import convert
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import Air, FibonacciAir, check_constraints

import reference_data as rd
from reference_data import inputs

torch.set_num_threads(1)

LOG_N = inputs.STARK_LOG_N
CONFIGS = inputs.STARK_CONFIGS


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's proofs, with its verifier's verdicts, as recorded."""
    return rd.load("test_torch_stark", inputs.test_torch_stark())


@pytest.fixture(scope="module")
def port_side():
    trace, publics = FibonacciAir.make_trace(1 << LOG_N, device="cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    proofs = {name: prover.prove(FibonacciAir(), trace, pubs,
                                 prover.StarkConfig(**kw))
              for name, kw in CONFIGS.items()}
    return proofs, pubs


def _payload_fields(proof, want) -> list:
    return rd.payload_fields(serialize.payload(proof), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_payload_parity_with_reference(name, jax_side, port_side):
    want = jax_side[name]["payload"]
    assert _payload_fields(port_side[0][name], want) == want["fields"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_verifier_accepts_port_and_reference_proofs(name, jax_side, port_side):
    cfg = prover.StarkConfig(**CONFIGS[name])
    proof, pubs = port_side[0][name], port_side[1]
    assert verifier.verify(FibonacciAir(), proof, pubs, LOG_N, cfg)
    leaves = rd.payload_planes(jax_side[name]["payload"])
    from_jax = convert.proof_from_pairs(list(zip(leaves[0::2], leaves[1::2])), proof,
                                      "cpu")
    assert verifier.verify(FibonacciAir(), from_jax, pubs, LOG_N, cfg)


def test_reference_verifier_accepts_port_proof(jax_side, port_side):
    want = jax_side["entry"]
    assert _payload_fields(port_side[0]["entry"], want["payload"]) == (
        want["payload"]["fields"])
    assert want["jax_verifier_accepts"] is True


def _tampered(proof, field, index):
    import copy
    bad = copy.copy(proof)
    t = getattr(proof, field).clone()
    t.view(-1)[index] ^= 1
    setattr(bad, field, t)
    return bad


@pytest.mark.parametrize("field", ["trace_rows_a", "quot_rows_b", "trace_cap"])
def test_port_verifier_rejects_tampered_proof(field, port_side):
    cfg = prover.StarkConfig(**CONFIGS["pow8"])
    bad = _tampered(port_side[0]["pow8"], field, 1)
    assert not verifier.verify(FibonacciAir(), bad, port_side[1], LOG_N, cfg)


def test_port_verifier_rejects_wrong_public_and_nonce(port_side):
    cfg = prover.StarkConfig(**CONFIGS["pow8"])
    proof, pubs = port_side[0]["pow8"], port_side[1]
    wrong = list(pubs[:2]) + [gl.add(pubs[2], gl.ones((), "cpu"))]
    assert not verifier.verify(FibonacciAir(), proof, wrong, LOG_N, cfg)
    import copy
    bad = copy.copy(proof)
    bad.fri_proof = copy.copy(proof.fri_proof)
    bad.fri_proof.pow_nonce = proof.fri_proof.pow_nonce + 1
    assert not verifier.verify(FibonacciAir(), bad, pubs, LOG_N, cfg)


def test_serialize_round_trip(port_side):
    cfg = prover.StarkConfig(**CONFIGS["entry"])
    proof = port_side[0]["entry"]
    data = serialize.serialize_proof(proof)
    like = serialize.empty_proof_like_shapes(FibonacciAir(), cfg, LOG_N)
    back = serialize.deserialize_proof(data, like, "cpu")
    assert serialize.payload(back) == serialize.payload(proof)
    assert verifier.verify(FibonacciAir(), back, port_side[1], LOG_N, cfg)
    with pytest.raises(ValueError):
        serialize.deserialize_proof(data[:-4], like, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_deserialized_proof_serializes_to_the_same_bytes(name, port_side):
    """Every leaf keeps its shape through a round trip, the 0-d grinding
    nonce included (it used to come back with shape (1,), so a bundle
    re-serialized from a deserialized one differed in its header)."""
    proof = port_side[0][name]
    data = serialize.serialize_proof(proof)
    like = serialize.empty_proof_like_shapes(
        FibonacciAir(), prover.StarkConfig(**CONFIGS[name]), LOG_N)
    back = serialize.deserialize_proof(data, like, "cpu")
    assert back.fri_proof.pow_nonce.shape == proof.fri_proof.pow_nonce.shape == ()
    assert serialize.serialize_proof(back) == data


def test_check_constraints_on_trace():
    trace, publics = FibonacciAir.make_trace(16, device="cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    assert check_constraints(FibonacciAir(), trace, pubs)
    bad = trace.clone()
    bad[1, 5] = gl.add(bad[1, 5], gl.ones((), "cpu"))
    assert not check_constraints(FibonacciAir(), bad, pubs)


def test_out_of_range_lookup_air_is_rejected():
    """An AIR with LogUp lookups proves: the proof carries an aux
    commitment. The Fibonacci column leaves the table [0, 16), so this
    proof must not verify (honest lookups, and parity with the reference,
    are in test_torch_lookup.py)."""
    class LookupAir(FibonacciAir):
        def lookup_range_columns(self):
            return [0]

    trace, publics = FibonacciAir.make_trace(16, device="cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=2)
    assert not hasattr(prover, "require_no_aux")
    proof = prover.prove(LookupAir(), trace, pubs, cfg)
    assert proof.aux_cap is not None
    assert proof.aux_zeta[0].shape == (prover.num_aux_cols(1),)
    assert not verifier.verify(LookupAir(), proof, pubs, 4, cfg)
