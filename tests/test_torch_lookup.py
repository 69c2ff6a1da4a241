"""Port vs reference: the LogUp/RAM aux phase of the prover and verifier.

The range AIR of tests/test_lookup.py, the RAM AIR of
tests/test_ram_multiset.py and the constant-column AIR of
tests/test_const_vk.py are defined once for each package. The same traces,
publics and StarkConfig go through vectorx_tpu.stark (JAX, CPU) and
vectorx_tpu_torch.stark (torch, CPU): the aux trace for the same γ, δ and
the proof payload must be equal (tolerance 0), each verifier must accept
the other package's proof, and the port's verifier must reject every
tampered case of the three JAX test files. Also the modular prefix sum
against Python ints.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.stark import prover as jprover
from vectorx_tpu.stark import serialize as jserialize
from vectorx_tpu.stark import verifier as jverifier
from vectorx_tpu.stark.air import Air as JAir
from vectorx_tpu_torch import convert
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import Air

from oracle import P

torch.set_num_threads(1)

# one trace length for every case, so that the JAX side compiles its
# transforms once
LOG_N = 5
N = 1 << LOG_N
CFG = dict(rate_bits=2, num_queries=6, final_poly_len=4)
GAMMA = (0x0123456789ABCDEF % P, P - 5)
DELTA = (P - (1 << 32) + 7, 0xFEDCBA9876543210 % P)


# -- the three AIRs, once for each package ---------------------------------------

def _range_air(base):
    class RangeAir(base):
        """Two committed columns, both range-checked to [0, N) via LogUp."""
        num_cols = 2
        num_publics = 1
        max_constraint_degree = 3

        def lookup_range_columns(self):
            return [0, 1]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]
    return RangeAir()


def _odd_range_air(base):
    class OddRangeAir(base):
        """Three looked columns: the odd count repeats the last."""
        num_cols = 3
        num_publics = 1

        def lookup_range_columns(self):
            return [0, 1, 2]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]
    return OddRangeAir()


def _ram_air(base, unmatched=False):
    class RamAir(base):
        """One committed value column; mult/load/addr/active in consts.
        Rows 0-7 store addrs 100..107; rows 12-19 load them reversed; row
        24 re-loads addr 100; row 25 is a zero-multiplicity store."""
        num_cols = 1
        num_publics = 1
        n_rows = N

        def ram_multiset(self):
            return (0, 1, 2, 3, 0)

        def constant_columns(self, n_rows):
            out = np.zeros((4, n_rows), dtype=np.uint64)
            for i in range(8):
                out[0, i] = 2 if i == 0 else 1
                out[2, i] = 100 + i
                out[3, i] = 1
            for i in range(8):
                out[1, 12 + i] = 1
                out[2, 12 + i] = 107 - i
                out[3, 12 + i] = 1
            out[1, 24], out[2, 24], out[3, 24] = 1, 100, 1
            out[2, 25], out[3, 25] = 200, 1
            if unmatched:                  # a load from a never-stored address
                out[1, 26], out[2, 26], out[3, 26] = 1, 55, 1
            return out
    return RamAir()


def _const_air(base, seed=0):
    class ConstAffineAir(base):
        """One column x with x' = x + c(i); c is a public constant column."""
        num_cols = 1
        num_publics = 2

        def constant_columns(self, n_rows):
            out = np.zeros((1, n_rows), dtype=np.uint64)
            for i in range(n_rows):
                out[0, i] = (7 * i * i + 3 * i + 1 + seed) % P
            return out

        def transition(self, alg, local, next_row, publics, consts=(),
                       consts_next=()):
            return [alg.sub(next_row[0], alg.add(local[0], consts[0]))]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]

        def last_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[1]))]
    return ConstAffineAir()


def _range_case(n, cols=2, bad=False):
    rng = np.random.default_rng(11)
    vals = rng.integers(0, n, (cols, n), dtype=np.uint64)
    if bad:
        vals[1, 17] = n + 3                 # out of range
    return vals.astype(object), [int(vals[0, 0])]


def _ram_vals(wrong_load=False, unmatched=False):
    vals = np.zeros(N, dtype=object)
    stored = {100 + i: 1000 + 7 * i for i in range(8)}
    for i in range(8):
        vals[i] = stored[100 + i]
        vals[12 + i] = stored[107 - i]
    vals[24] = stored[100]
    vals[25] = 424242
    if wrong_load:
        vals[12] = 999999
    if unmatched:
        vals[26] = 1234
    return vals[None, :], [7]


def _const_case(seed=0, n=N):
    c = _const_air(Air, seed).constant_columns(n)[0]
    xs = [5]
    for i in range(n - 1):
        xs.append((xs[-1] + int(c[i])) % P)
    return np.array([xs], dtype=object), [5, xs[-1]]


# name -> (air factory, (trace values, publics), log_n)
CASES = {
    "range": (_range_air, _range_case(N), LOG_N),
    "ram": (_ram_air, _ram_vals(), LOG_N),
    "const_vk": (_const_air, _const_case(), LOG_N),
}
# aux trace only (no proof): three looked columns
ODD_RANGE = (_odd_range_air, _range_case(N, cols=3), LOG_N)
# tampered witnesses: the proof is made, and must not verify
BAD_WITNESS = {
    "range_out_of_range": (_range_air, _range_case(N, bad=True), LOG_N),
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


def _jax_prove(name):
    make, (vals, publics), log_n = CASES[name]
    air = make(JAir)
    pubs = [jgl.to_fp(p) for p in publics]
    proof = jprover.prove(air, jgl.to_fp(vals), pubs,
                          jprover.StarkConfig(**CFG))
    return air, proof, pubs, log_n


@pytest.fixture(scope="module")
def port_side():
    return {name: _port_prove(name) for name in CASES}


@pytest.fixture(scope="module")
def jax_side():
    return {name: _jax_prove(name) for name in CASES}


def _jax_ext(v):
    return jgl.to_fp(v[0]), jgl.to_fp(v[1])


def _port_ext(v):
    return gl.to_fp(v[0], "cpu"), gl.to_fp(v[1], "cpu")


def _u64(pair):
    return (np.asarray(pair[0], np.uint64)
            | (np.asarray(pair[1], np.uint64) << np.uint64(32)))


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
def test_aux_trace_equals_reference(name):
    make, (vals, _), log_n = CASES.get(name, ODD_RANGE)
    n = 1 << log_n
    jair, air = make(JAir), make(Air)
    want = jprover._build_aux(jair, jgl.to_fp(vals),
                              jair.lookup_range_columns(), _jax_ext(GAMMA),
                              _jax_ext(DELTA), n)
    cfp = (gl.to_fp(np.asarray(air.constant_columns(n), dtype=object), "cpu")
           if air.ram_multiset() is not None else None)
    got = prover._build_aux(air, gl.to_fp(vals, "cpu"),
                            air.lookup_range_columns(), _port_ext(GAMMA),
                            _port_ext(DELTA), n, cfp)
    assert got.shape[0] == prover.total_aux_cols(air)
    assert np.array_equal(gl.to_u64(got), _u64(want))


def test_aux_trace_counts_no_out_of_range_cell():
    make, (vals, _), _ = BAD_WITNESS["range_out_of_range"]
    aux = prover._build_aux(make(Air), gl.to_fp(vals, "cpu"), [0, 1],
                            _port_ext(GAMMA), None, N, None)
    assert int(aux[4].sum()) == 2 * N - 1           # the multiplicity column
    jaux = jprover._build_aux(make(JAir), jgl.to_fp(vals), [0, 1],
                              _jax_ext(GAMMA), None, N)
    assert np.array_equal(gl.to_u64(aux), _u64(jaux))


@pytest.mark.parametrize("name", list(CASES))
def test_payload_parity_with_reference(name, jax_side, port_side):
    want = serialize.split_payload(
        jserialize.serialize_proof(jax_side[name][1]))
    assert serialize.payload(port_side[name][1]) == want


@pytest.mark.parametrize("name", list(CASES))
def test_port_verifier_accepts_port_and_reference_proofs(name, jax_side,
                                                         port_side):
    air, proof, pubs, log_n = port_side[name]
    cfg = prover.StarkConfig(**CFG)
    assert verifier.verify(air, proof, pubs, log_n, cfg)
    leaves = [np.asarray(x)
              for x in jax.tree_util.tree_leaves(jax_side[name][1])]
    from_jax = convert.proof_from_pairs(
        list(zip(leaves[0::2], leaves[1::2])), proof, "cpu")
    assert verifier.verify(air, from_jax, pubs, log_n, cfg)


@pytest.mark.parametrize("name", ["range", "ram"])
def test_reference_verifier_accepts_port_proof(name, jax_side, port_side):
    jair, jproof, jpubs, log_n = jax_side[name]
    pairs = convert.proof_to_pairs(port_side[name][1])
    leaves = [jax.numpy.asarray(x) for pair in pairs for x in pair]
    rebuilt = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jproof), leaves)
    assert bool(jverifier.verify(jair, rebuilt, jpubs, log_n,
                                 jprover.StarkConfig(**CFG)))


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
