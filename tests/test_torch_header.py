"""Port vs reference: the Avail-header AIR stack (SHA-256 compression base,
Blake2b, HeaderAir) and one HeaderAir(max_chunks=1) proof.

The JAX package's trace, constant columns, publics and proof of the
header are recorded (tests/reference_data/test_torch_header.json, made by
tests/reference_data/record.py); payload equality with that proof makes a
JAX verify of the port proof redundant.
"""

import hashlib

import numpy as np
import pytest
import torch

from vectorx_tpu.circuits import scale as jscale
from vectorx_tpu.stark import air_blake2b as jb2
from vectorx_tpu.stark import air_header as jah
from vectorx_tpu.stark import air_sha256 as jsha
from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import air_blake2b as b2
from vectorx_tpu_torch.stark import air_header as ah
from vectorx_tpu_torch.stark import air_sha256 as sha
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import check_constraints

import reference_data as rd
from reference_data import inputs

torch.set_num_threads(1)

CFG = inputs.HEADER_CFG
HEADER = inputs.HEADER


def _u64(j):
    return (np.asarray(j[0], np.uint64) | (np.asarray(j[1], np.uint64) << np.uint64(32)))


@pytest.fixture(scope="module")
def port_case():
    air = ah.HeaderAir(max_chunks=1)
    trace, publics, digest = air.make_trace(HEADER, "cpu")
    pubs = [gl.to_fp(int(p), "cpu") for p in publics]
    proof = prover.prove(air, trace, pubs, prover.StarkConfig(**CFG))
    return air, trace, publics, pubs, digest, proof


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's HeaderAir(1) trace, constants, publics and proof
    of HEADER, as recorded."""
    return rd.load("test_torch_header", inputs.test_torch_header())


# -- codec and AIR witnesses ---------------------------------------------------

@pytest.mark.parametrize("v", [0, 63, 64, 16383, 16384, (1 << 30) - 1,
                               1 << 30, 0xFFFFFFFF])
def test_compact_codec_matches_reference(v):
    enc = scale.encode_compact_u32(v)
    assert enc == jscale.encode_compact_u32(v)
    assert scale.decode_compact_u32(enc + bytes(5)) == jscale.decode_compact_u32(enc + bytes(5))


def test_decode_header_matches_reference():
    assert scale.decode_header_bytes(HEADER) == jscale.decode_header_bytes(HEADER)


def test_sha256_compress_trace_matches_reference():
    rng = np.random.default_rng(5)
    state = [int(x) for x in rng.integers(0, 1 << 32, 8, dtype=np.uint64)]
    msg = [int(x) for x in rng.integers(0, 1 << 32, 16, dtype=np.uint64)]
    trace, publics, out = sha.Sha256CompressAir.make_trace(state, msg, "cpu")
    jtrace, jpublics, jout = jsha.Sha256CompressAir.make_trace(state, msg)
    assert out == jout and publics == jpublics
    assert np.array_equal(gl.to_u64(trace), _u64(jtrace))
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    assert check_constraints(sha.Sha256CompressAir(), trace, pubs)
    bad = [gl.to_fp(p, "cpu") for p in publics[:-1]] + [gl.to_fp(publics[-1] ^ 1, "cpu")]
    assert not check_constraints(sha.Sha256CompressAir(), trace, bad)


def test_blake2b_single_chunk_trace_matches_reference():
    msg = bytes(range(77))
    trace, publics, digest = b2.Blake2bAir.make_trace(msg, "cpu")
    jtrace, jpublics, jdigest = jb2.Blake2bAir.make_trace(msg)
    assert digest == jdigest == hashlib.blake2b(msg, digest_size=32).digest()
    assert publics == jpublics
    assert np.array_equal(gl.to_u64(trace), _u64(jtrace))
    assert check_constraints(b2.Blake2bAir(), trace, [gl.to_fp(p, "cpu") for p in publics])


def test_blake2b_var_air_constants_match_reference():
    air, jair = b2.Blake2bVarAir(3), jb2.Blake2bVarAir(3)
    assert np.array_equal(air.constant_columns(air.n_rows),
                          jair.constant_columns(jair.n_rows))
    msg = bytes(range(200))
    trace, publics, digest = air.make_trace(msg, "cpu")
    assert digest == hashlib.blake2b(msg, digest_size=32).digest()
    assert check_constraints(air, trace, [gl.to_fp(p, "cpu") for p in publics])


def test_header_trace_and_constants_match_reference(port_case, jax_case):
    air, trace, publics, _, digest, _ = port_case
    jpublics = jax_case["publics"]
    assert digest == hashlib.blake2b(HEADER, digest_size=32).digest()
    assert publics == jpublics
    assert rd.array(gl.to_u64(trace)) == jax_case["trace"]
    assert (rd.array(air.constant_columns(air.n_rows))
            == jax_case["constant_columns"])
    assert ah.derive_gammas(publics[:ah.P_G1], "cpu") == jah.derive_gammas(publics[:ah.P_G1])
    fields = ah.header_publics_fields(publics, device="cpu")
    assert fields == jah.header_publics_fields(jpublics)
    assert fields["data_root"] == HEADER[-32:]


def test_header_constraints_hold(port_case):
    air, trace, _, pubs, _, _ = port_case
    assert check_constraints(air, trace, pubs)


# -- the proof ----------------------------------------------------------------------

def test_header_payload_parity_with_reference(port_case, jax_case):
    proof = port_case[5]
    jpayload = jax_case["payload"]
    assert (rd.payload_fields(serialize.payload(proof), jpayload)
            == jpayload["fields"])
    n_leaves = len(jpayload["fields"])
    assert 2 * len(serialize.convert.tensor_leaves(proof)) == n_leaves


def test_port_verifier_accepts_header_proof(port_case):
    air, _, _, pubs, _, proof = port_case
    log_n = air.n_rows.bit_length() - 1
    assert verifier.verify(air, proof, pubs, log_n, prover.StarkConfig(**CFG))


def test_port_verifier_rejects_changed_data_root(port_case):
    air, _, publics, pubs, _, proof = port_case
    log_n = air.n_rows.bit_length() - 1
    bad = list(pubs)
    bad[ah.P_DR + 5] = gl.to_fp((publics[ah.P_DR + 5] + 1) % 256, "cpu")
    assert not verifier.verify(air, proof, bad, log_n, prover.StarkConfig(**CFG))
