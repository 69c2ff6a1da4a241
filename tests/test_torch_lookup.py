"""Port vs reference: the LogUp/RAM aux phase of the prover and verifier.

The range AIR of tests/test_lookup.py, the RAM AIR of
tests/test_ram_multiset.py and the constant-column AIR of
tests/test_const_vk.py are defined once for each package. The same traces,
publics and StarkConfig go through vectorx_tpu.stark (JAX, CPU) and
vectorx_tpu_torch.stark (torch, CPU): the aux trace for the same γ, δ and
the proof payload must be equal (tolerance 0), each verifier must accept
the other package's proof, and the port's verifier must reject every
tampered case of the three JAX test files. Also the modular prefix sum
against Python ints. The JAX package's proofs, aux traces and verifier
verdicts are recorded (tests/reference_data/test_torch_lookup.json, made
by tests/reference_data/record.py); with the payloads equal, the JAX
verifier's verdict on its own proof is its verdict on the port's.
"""

import copy

import numpy as np
import pytest
import torch

from vectorx_tpu.stark import prover as jprover
from vectorx_tpu_torch import convert
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import Air

import reference_data as rd
from oracle import P
from reference_data import inputs
from reference_data.inputs import (DELTA, GAMMA, const_air as _const_air,
                                   ram_air as _ram_air,
                                   ram_vals as _ram_vals)

torch.set_num_threads(1)

# one trace length for every case, so that the JAX side compiles its
# transforms once
LOG_N = inputs.LOOKUP_LOG_N
N = inputs.LOOKUP_N
CFG = inputs.LOOKUP_CFG

# the three AIRs (and the odd-column range AIR) are defined once for both
# packages in tests/reference_data/inputs.py

# name -> (air factory, (trace values, publics), log_n)
CASES = inputs.LOOKUP_CASES
# aux trace only (no proof): three looked columns
ODD_RANGE = inputs.ODD_RANGE
# tampered witnesses: the proof is made, and must not verify
BAD_WITNESS = {
    "range_out_of_range": inputs.BAD_RANGE,
    "ram_wrong_load_value": (_ram_air, _ram_vals(wrong_load=True), LOG_N),
    "ram_unmatched_load": (lambda base: _ram_air(base, unmatched=True),
                           _ram_vals(unmatched=True), LOG_N),
}


def _port_prove(name, table=CASES):
    make, (vals, publics), log_n = table[name]
    air = make(Air)
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    proof = prover.prove(air, gl.to_fp(vals, "cpu"), pubs,
                         prover.StarkConfig(**CFG))
    return air, proof, pubs, log_n


@pytest.fixture(scope="module")
def port_side():
    return {name: _port_prove(name) for name in CASES}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's proofs and aux traces, with its verifier's
    verdicts, as recorded (tests/reference_data/test_torch_lookup.json)."""
    return rd.load("test_torch_lookup", inputs.test_torch_lookup())


def _port_ext(v):
    return gl.to_fp(v[0], "cpu"), gl.to_fp(v[1], "cpu")


def _payload_fields(proof, want) -> list:
    return rd.payload_fields(serialize.payload(proof), want)


# -- the modular prefix sum ----------------------------------------------------

@pytest.mark.parametrize("n", [1, 1 << 12])
def test_prefix_sum_mod_against_python_ints(n):
    """The exclusive running sum: out[i] = x[0] + ... + x[i-1] mod p."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, P, (3, n), dtype=np.uint64)
    # biased to [p - 2^32, p): the halves' sums carry at almost every step
    x[1] = np.uint64(P) - rng.integers(1, 1 << 32, n, dtype=np.uint64)
    x[2, ::3] = P - 1
    got = gl.to_u64(gl.prefix_sum_mod(gl.to_fp(x, "cpu")))
    for row, out in zip(x, got):
        acc, want = 0, []
        for v in row:
            want.append(acc)
            acc = (acc + int(v)) % P
        assert [int(v) for v in out] == want


# -- aux trace, payload, cross-verification --------------------------------------

@pytest.mark.parametrize("n_lookups", [0, 1, 2, 3, 76])
def test_aux_column_and_constraint_counts_equal_reference(n_lookups):
    for has_ram in (False, True):
        assert (prover.num_aux_cols(n_lookups, has_ram)
                == jprover.num_aux_cols(n_lookups, has_ram))
    assert (prover._num_lookup_constraints(n_lookups)
            == jprover._num_lookup_constraints(n_lookups))


@pytest.mark.parametrize("name", ["range", "range_odd", "ram"])
def test_aux_trace_equals_reference(name, jax_side):
    make, (vals, _), log_n = CASES.get(name, ODD_RANGE)
    n = 1 << log_n
    air = make(Air)
    cfp = (gl.to_fp(np.asarray(air.constant_columns(n), dtype=object), "cpu")
           if air.ram_multiset() is not None else None)
    got = prover._build_aux(air, gl.to_fp(vals, "cpu"),
                            air.lookup_range_columns(), _port_ext(GAMMA),
                            _port_ext(DELTA), n, cfp)
    assert got.shape[0] == prover.total_aux_cols(air)
    assert rd.array(gl.to_u64(got)) == jax_side["aux"][name]


def test_aux_trace_counts_no_out_of_range_cell(jax_side):
    make, (vals, _), _ = BAD_WITNESS["range_out_of_range"]
    aux = prover._build_aux(make(Air), gl.to_fp(vals, "cpu"), [0, 1],
                            _port_ext(GAMMA), None, N, None)
    assert int(aux[4].sum()) == 2 * N - 1           # the multiplicity column
    assert rd.array(gl.to_u64(aux)) == jax_side["aux"]["range_out_of_range"]


@pytest.mark.parametrize("name", list(CASES))
def test_payload_parity_with_reference(name, jax_side, port_side):
    want = jax_side["proofs"][name]["payload"]
    assert _payload_fields(port_side[name][1], want) == want["fields"]


@pytest.mark.parametrize("name", list(CASES))
def test_port_verifier_accepts_port_and_reference_proofs(name, jax_side,
                                                         port_side):
    air, proof, pubs, log_n = port_side[name]
    cfg = prover.StarkConfig(**CFG)
    assert verifier.verify(air, proof, pubs, log_n, cfg)
    leaves = rd.payload_planes(jax_side["proofs"][name]["payload"])
    from_jax = convert.proof_from_pairs(
        list(zip(leaves[0::2], leaves[1::2])), proof, "cpu")
    assert verifier.verify(air, from_jax, pubs, log_n, cfg)


@pytest.mark.parametrize("name", ["range", "ram"])
def test_reference_verifier_accepts_port_proof(name, jax_side, port_side):
    want = jax_side["proofs"][name]
    assert _payload_fields(port_side[name][1], want["payload"]) == (
        want["payload"]["fields"])
    assert want["jax_verifier_accepts"] is True


# -- what the verifier must reject -------------------------------------------------

@pytest.mark.parametrize("name", list(BAD_WITNESS))
def test_port_verifier_rejects_bad_witness(name):
    air, proof, pubs, log_n = _port_prove(name, BAD_WITNESS)
    assert not verifier.verify(air, proof, pubs, log_n,
                               prover.StarkConfig(**CFG))


def _flip(proof, field, component=None):
    bad = copy.copy(proof)
    value = getattr(proof, field)
    if component is None:
        t = value.clone()
        t.view(-1)[0] ^= 1
        setattr(bad, field, t)
    else:
        parts = [v.clone() for v in value]
        parts[component].view(-1)[0] ^= 1
        setattr(bad, field, tuple(parts))
    return bad


@pytest.mark.parametrize("name,field,component", [
    ("range", "aux_rows_a", None),        # forged aux row: Merkle check
    ("range", "aux_zeta", 0),             # forged aux opening: ALI / DEEP
    ("range", "aux_cap", None),
    ("ram", "aux_rows_b", None),
    ("const_vk", "const_zeta", 0),
    ("const_vk", "const_rows_a", None),
])
def test_port_verifier_rejects_tampered_proof(name, field, component,
                                              port_side):
    air, proof, pubs, log_n = port_side[name]
    assert not verifier.verify(air, _flip(proof, field, component), pubs,
                               log_n, prover.StarkConfig(**CFG))


def test_port_verifier_rejects_wrong_vk(port_side):
    """A proof built against other constants (same shapes) must not verify:
    the VK cap is recomputed from the verifier's AIR."""
    _, proof, pubs, log_n = port_side["const_vk"]
    other = _const_air(Air, seed=1)
    assert not verifier.verify(other, proof, pubs, log_n,
                               prover.StarkConfig(**CFG))


def test_port_verifier_rejects_proof_without_aux(port_side):
    air, proof, pubs, log_n = port_side["range"]
    bad = copy.copy(proof)
    bad.aux_cap = None
    assert not verifier.verify(air, bad, pubs, log_n,
                               prover.StarkConfig(**CFG))


@pytest.mark.parametrize("name", ["range", "ram"])
def test_serialize_round_trip_with_aux(name, port_side):
    air, proof, pubs, log_n = port_side[name]
    cfg = prover.StarkConfig(**CFG)
    like = serialize.empty_proof_like_shapes(air, cfg, log_n)
    back = serialize.deserialize_proof(serialize.serialize_proof(proof), like,
                                       "cpu")
    assert serialize.payload(back) == serialize.payload(proof)
    assert back.aux_zeta[0].shape == (prover.total_aux_cols(air),)
