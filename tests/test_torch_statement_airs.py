"""Port vs reference: the statement AIRs of the header_range bundle's hash
half, and PoseidonChainAir.

PoseidonChainAir (2 permutations, 64 rows), ChainedSha256Air(2) (512 rows),
MerkleSha256Air of 4 leaves (1024 rows) and Sha512ChallengeAir(B=8) (one
lane, 256 rows, 76 looked-up columns) are built in both packages from the
same numpy-seeded inputs. Trace, constant columns and publics must be equal
(tolerance 0), the public outputs must be hashlib's, check_constraints must
hold on the honest trace and fail on the tampers of the JAX package's own
AIR tests, and the port's proof payload must equal the JAX package's (one
JAX prove per AIR, at rate_bits=1, num_queries=2, final_poly_len=4).

The JAX package's side (trace, constant columns, publics, looked-up
columns and proof of each AIR) is recorded, one file per test module
(tests/reference_data/test_torch_statement_*.json, made by
tests/reference_data/record.py): the JAX proves are the expensive part.
This file holds the cases, the checks (``check_*``, called with an AIR's
name) and the tests of PoseidonChainAir, ChainedSha256Air and the public
outputs; MerkleSha256Air is in test_torch_statement_sha256_merkle.py and
Sha512ChallengeAir in test_torch_statement_sha512.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from vectorx_tpu_torch.circuits import commitments as cm
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.stark import air_poseidon as pos
from vectorx_tpu_torch.stark import air_sha256_chain as chain
from vectorx_tpu_torch.stark import air_sha256_merkle as merkle
from vectorx_tpu_torch.stark import air_sha512 as a512
from vectorx_tpu_torch.stark import prover, serialize
from vectorx_tpu_torch.stark.air import check_constraints

import reference_data as rd
from reference_data import inputs

torch.set_num_threads(1)

CFG = inputs.STMT_CFG
MSG = inputs.STMT_MSG
STATE = inputs.STMT_STATE
KEYS = inputs.STMT_KEYS
LEAVES = inputs.STMT_LEAVES
_lane = inputs.sha512_lane


def _digest(words):
    return b"".join(int(w).to_bytes(4, "big") for w in words)


def _build(name):
    """(air, trace, publics) of the port, the trace on the CPU."""
    if name == "poseidon_chain":
        air = pos.PoseidonChainAir()
        trace, publics, _ = air.make_trace(STATE, 2, "cpu")
    elif name == "sha256_chain":
        air = chain.ChainedSha256Air(2)
        words = air.pubkeys_to_words(KEYS, 2)
        trace, publics, _ = air.make_trace(words, 2, "cpu")
    elif name == "sha256_merkle":
        air = merkle.MerkleSha256Air(inputs.leaf_words(LEAVES))
        trace, publics, _ = air.make_trace("cpu")
    else:
        air = a512.Sha512ChallengeAir([_lane(7)], MSG, B=8)
        trace, publics = air.make_trace("cpu")
    return air, trace, [int(p) for p in publics]


AIRS = ("poseidon_chain", "sha256_chain", "sha256_merkle", "sha512")
# AIR -> the test module whose recording holds its JAX side
MODULE_OF = {name: module for module, names in inputs.STMT_MODULES.items()
             for name in names}
# name -> [(column, row, xor mask)]: the tampers of the JAX package's tests
TAMPERS = {
    "poseidon_chain": [(0, 40, 2)],
    "sha256_chain": [(chain.CHN + 2, 200, 3)],
    "sha256_merkle": [(merkle.IS + 8 + 2, 700, 5)],
    "sha512": [(a512.DB, a512.R_RED + 3, 1), (a512.A + 5, 40, 1)],
}

_port_cache = {}
_jax_cache = {}


def _port(name):
    if name not in _port_cache:
        _port_cache[name] = _build(name)
    return _port_cache[name]


def _jax(name):
    """The JAX package's side of AIR `name`, as recorded."""
    module = MODULE_OF[name]
    if module not in _jax_cache:
        _jax_cache[module] = rd.load(module, inputs.statement(module))
    return _jax_cache[module][name]


def _port_pubs(publics):
    return [gl.to_fp(p, "cpu") for p in publics]


def check_trace_constants_publics(name):
    want = _jax(name)
    air, trace, publics = _port(name)
    assert publics == want["publics"]
    assert trace.shape == (air.num_cols, want["trace"]["shape"][1])
    assert rd.array(gl.to_u64(trace)) == want["trace"]
    n = trace.shape[1]
    assert (rd.array(np.asarray(air.constant_columns(n), dtype=np.uint64))
            == want["constant_columns"])
    assert air.lookup_range_columns() == want["lookup_range_columns"]


def check_honest_trace(name):
    air, trace, publics = _port(name)
    assert check_constraints(air, trace, _port_pubs(publics))


def check_tampered_trace(name, tamper):
    air, trace, publics = _port(name)
    col, row, mask = tamper
    bad = trace.clone()
    bad[col, row] ^= mask
    assert not check_constraints(air, bad, _port_pubs(publics))


def check_payload_parity(name):
    """One port prove against the recorded JAX prove of the same case."""
    want = _jax(name)["payload"]
    air, trace, publics = _port(name)
    proof = prover.prove(air, trace, _port_pubs(publics),
                         prover.StarkConfig(**CFG))
    assert (proof.aux_cap is not None) == (name == "sha512")
    assert rd.payload_fields(serialize.payload(proof), want) == want["fields"]


# -- PoseidonChainAir, ChainedSha256Air, and what spans the AIRs --------------------

HERE = ("poseidon_chain", "sha256_chain")


@pytest.mark.parametrize("name", HERE)
def test_trace_constants_publics_equal_reference(name):
    check_trace_constants_publics(name)


def test_public_outputs_are_hashlibs():
    want = STATE
    for _ in range(2):
        want = ps.permute_ints(want)
    assert _port("poseidon_chain")[2][12:] == want
    chain_pubs = _port("sha256_chain")[2]
    assert chain_pubs[0] == 2
    assert _digest(chain_pubs[1:]) == cm.authority_set_hash(KEYS)
    assert _digest(chain_pubs[1:]) == hashlib.sha256(
        hashlib.sha256(KEYS[0]).digest() + KEYS[1]).digest()
    assert _digest(_port("sha256_merkle")[2][-8:]) == cm.simple_merkle_root(LEAVES)
    air = _port("sha512")[0]
    assert len(air.lookup_range_columns()) == 76
    assert prover.total_aux_cols(air) == 82
    assert _port("sha512")[2][0] == 1


def test_masked_chain_and_sizes():
    """num_active below n_max: only the first keys count."""
    air = chain.ChainedSha256Air(2)
    trace, publics, out = air.make_trace(air.pubkeys_to_words(KEYS, 2), 1, "cpu")
    assert _digest(out) == hashlib.sha256(KEYS[0]).digest()
    assert check_constraints(air, trace, _port_pubs(publics))
    assert chain.num_blocks_for(300) == 1024
    assert chain.ChainedSha256Air(300).n_rows == 131072


@pytest.mark.parametrize("name", HERE)
def test_check_constraints_accepts_honest_trace(name):
    check_honest_trace(name)


@pytest.mark.parametrize("name,tamper", [(n, t) for n in HERE
                                         for t in TAMPERS[n]])
def test_check_constraints_rejects_tampered_trace(name, tamper):
    check_tampered_trace(name, tamper)


@pytest.mark.parametrize("name", HERE)
def test_payload_parity_with_reference(name):
    check_payload_parity(name)
