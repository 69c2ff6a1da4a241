"""Port vs reference: Ed25519VerifyAir at B = 8 (one lane on 256 rows,
6683 columns, 6444 of them looked up, 42 constant columns).

Two lanes, each built in both packages: a real signature (a key made from
seeded bytes signs a seeded 53-byte precommit with cryptography's signer)
and the disabled-lane dummy. Held with tolerance 0:

- the trace of both witness functions (``make_trace``, Python ints, and
  ``make_trace_vec``, numpy rows) of both packages, the constant columns
  and the publics;
- the layout: looked-up columns, constraint count, ``phase_cache_key``;
- the transition under BaseVecAlgebra, the prover's algebra, on 8 seeded
  random values per column, constraint by constraint. With the trace,
  constants and publics equal, and the prover core held to payload parity
  with its LogUp aux phase (test_torch_lookup.py,
  test_torch_statement_*.py), this fixes the proof payload without a JAX
  prove of this AIR, which takes about 11 minutes on a CPU
  (test_torch_ed25519_parity.py has that one, marked slow);
- check_constraints holds on both honest traces and fails on a tampered
  limb, and a wrong challenge h has no witness.

The transition under ExtAlgebra, the verifier's algebra, is in
test_torch_ed25519_ext.py. The JAX package's traces and constraint values
are recorded (tests/reference_data/test_torch_ed25519_air.json, made by
tests/reference_data/record.py, which signs with its own RFC 8032 signer:
the lanes must be the ones signed here).
"""

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu.stark import air_ed25519 as jed
from vectorx_tpu_torch.circuits.ed25519 import L_ORDER
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import air_ed25519 as ped
from vectorx_tpu_torch.stark import ed25519_prove
from vectorx_tpu_torch.stark.air import check_constraints

import reference_data as rd
import test_torch_gadget_vec as common
from reference_data import inputs
from reference_data.inputs import random_columns

torch.set_num_threads(1)

B = 8
N_CONSTRAINTS = 24
MSG = np.random.default_rng(53).bytes(53)


def signed_lane(seed: int, msg: bytes = MSG):
    """(A, R, s, h) of a signature by the key made from seeded bytes."""
    key = Ed25519PrivateKey.from_private_bytes(
        np.random.default_rng(seed).bytes(32))
    pub = key.public_key().public_bytes(serialization.Encoding.Raw,
                                        serialization.PublicFormat.Raw)
    return ed25519_prove.sigs_from_justification([pub], [key.sign(msg)],
                                                 [True], msg)[0]


LANES = {"signed": signed_lane(7), "dummy": ped.dummy_sig()}
_cache = {}


def _air(pkg, lane):
    mod = ped if pkg == "port" else jed
    return mod.Ed25519VerifyAir([LANES[lane]], B=B)


@pytest.fixture(scope="module")
def jax_rec():
    """The JAX package's traces, publics and constraint values, as
    recorded."""
    return rd.load("test_torch_ed25519_air",
                   inputs.test_torch_ed25519_air(LANES))


def _trace_u64(lane, make):
    """(trace as uint64, publics) of one port witness function."""
    key = (lane, make)
    if key not in _cache:
        trace, publics = getattr(_air("port", lane), make)("cpu")
        _cache[key] = gl.to_u64(trace), [int(p) for p in publics]
    return _cache[key]


# -- witness, constants, publics, layout --------------------------------------------

@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("make", ["make_trace", "make_trace_vec"])
def test_trace_equal_reference(lane, make, jax_rec):
    """Each port witness function against the JAX package's make_trace (its
    make_trace_vec is held to it in the JAX package's own tests)."""
    got, publics = _trace_u64(lane, make)
    want = jax_rec["traces"][f"{lane}-make_trace"]
    assert (list(got.shape) == want["trace"]["shape"]
            == [_air("port", lane).num_cols, 1 << B])
    assert rd.array(got) == want["trace"]
    assert publics == want["publics"]


@pytest.mark.parametrize("lane", LANES)
def test_reference_witness_functions_agree(lane, jax_rec):
    traces = jax_rec["traces"]
    assert (traces[f"{lane}-make_trace_vec"]["trace"]
            == traces[f"{lane}-make_trace"]["trace"])


@pytest.mark.parametrize("lane", LANES)
def test_constants_and_publics_equal_reference(lane):
    air, jair_ = _air("port", lane), _air("jax", lane)
    for n in (2, 1 << B):
        assert np.array_equal(np.asarray(air.constant_columns(n), np.uint64),
                              np.asarray(jair_.constant_columns(n), np.uint64))
    assert air.publics_list() == jair_.publics_list()
    assert air.publics_list()[0] == 1


def test_layout_equal_reference():
    air, jair_ = _air("port", "signed"), _air("jax", "signed")
    assert air.num_cols == jair_.num_cols == 6683
    assert air.lookup_range_columns() == jair_.lookup_range_columns()
    assert len(air.lookup_range_columns()) == 6444
    assert air.num_constraints() == N_CONSTRAINTS
    assert air.phase_cache_key() == jair_.phase_cache_key()
    assert air.constant_columns(2).shape[0] == 42


# -- the constraints under the prover's algebra ----------------------------------

def _base():
    key = "base"
    if key not in _cache:
        air = _air("port", "signed")
        rng = np.random.default_rng(8)
        k = air.constant_columns(2).shape[0]
        cols = (random_columns(rng, air.num_cols, 8),
                random_columns(rng, air.num_cols, 8),
                random_columns(rng, k, 8),
                random_columns(rng, k, 8))
        _cache[key] = common.base_eval(air, cols)
    return _cache[key]


@pytest.mark.parametrize("i", range(N_CONSTRAINTS))
def test_base_constraints_equal_reference(i, jax_rec):
    assert len(_base()) == len(jax_rec["base"]) == N_CONSTRAINTS
    common.assert_equal_base(_base()[i], jax_rec["base"][i])


# -- check_constraints and the witness's own checks ---------------------------------

def _port_case(lane):
    air = _air("port", lane)
    trace, publics = air.make_trace_vec("cpu")
    return air, trace, [gl.to_fp(p, "cpu") for p in publics]


@pytest.mark.parametrize("lane", LANES)
def test_check_constraints_accepts_honest_trace(lane):
    assert check_constraints(*_port_case(lane))


@pytest.mark.parametrize("what", ["accumulator", "carry", "decompression"])
def test_check_constraints_rejects_tampered_limb(what):
    air, trace, pubs = _port_case("signed")
    col, row = {"accumulator": (air.acc[0][0], 100),
                "carry": (air.vm.chain.ul[4, 0, 7], 50),
                "decompression": (air.xpt[3], 254)}[what]
    bad = trace.clone()
    bad[col, row] ^= 1
    assert not check_constraints(air, bad, pubs)


@pytest.mark.parametrize("make", ["make_trace", "make_trace_vec"])
def test_wrong_h_has_no_witness(make):
    a, r, s, h = LANES["signed"]
    air = ped.Ed25519VerifyAir([(a, r, s, (h + 1) % L_ORDER)], B=B)
    with pytest.raises(AssertionError):
        getattr(air, make)("cpu")
