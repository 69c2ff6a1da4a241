"""Port vs JAX package: the recursion machine (stark/recursion_air.py).

The inner proofs are the port's, proved on the CPU; their payloads equal
the JAX package's inner proofs of the same traces, which went through the
JAX ``record_stark_verify`` (recorded: tests/reference_data/
test_torch_recursion.json, made by tests/reference_data/record.py). The
port's records them, plain and streamed, at the shapes
of tests/test_recursion_air.py and tests/test_recursion_stream.py
(FibonacciAir, the LogUp range AIR and the constant-column AIR at 16
rows, rate 1, 2 queries; also PoseidonChainAir at 64 rows): the row
count, K, ``schedule_digest``, the constant columns and ``make_trace``
must be equal bit for bit. RecursionAir itself recorded as an inner AIR
(the two-level case) is compared from the claim shape (rows, K, digest,
constant columns). Tolerance: exact equality throughout.

Also: RecursionAir.transition against the JAX one on seeded rows; ONE
``prove_recursive`` of FibonacciAir(8) whose payload equals the JAX
package's and which each verifier accepts (the JAX prove is the module's
heaviest part: ~3 min); tampered caps, leaves, publics and RAM values and
a broken reduce link make the machine unsatisfiable; the verifier-side
rebuilds give the prover's schedule digest. Each comparison with a
recorded machine first holds the port's inner proof to the JAX package's
inner payload.
"""

import copy

import numpy as np
import pytest
import torch

from vectorx_tpu.stark import recursion_air as jra
from vectorx_tpu_torch.field import ext
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark import recursion_air as ra
from vectorx_tpu_torch.stark.air import (Air, BaseVecAlgebra, FibonacciAir,
                                         check_constraints)
from vectorx_tpu_torch.stark.air_poseidon import PoseidonChainAir

import reference_data as rd
from oracle import P
from reference_data import inputs
from reference_data.inputs import const_air, range_air

torch.set_num_threads(1)

LOG_N = inputs.REC_LOG_N
CFG = inputs.REC_CFG
PCFG = prover.StarkConfig(**CFG)


def _inner_case(spec):
    """The port's inner trace values and publics from INNER's spec (the
    JAX package's trace builders made the recorded inner proofs)."""
    if "fibonacci" in spec:
        trace, publics = FibonacciAir.make_trace(spec["fibonacci"],
                                                 device="cpu")
        return gl.from_fp(trace), publics
    if "poseidon_chain" in spec:
        trace, publics, _ = PoseidonChainAir.make_trace(
            *spec["poseidon_chain"], "cpu")
        return gl.from_fp(trace), [int(p) for p in publics]
    return spec["values"]


# name -> (port air, (trace values, publics), log_n)
INNER = {
    "fib": (FibonacciAir(), _inner_case(inputs.REC_INNER["fib"][0]), LOG_N),
    "range": (range_air(Air), _inner_case(inputs.REC_INNER["range"][0]),
              LOG_N),
    "const": (const_air(Air), _inner_case(inputs.REC_INNER["const"][0]),
              LOG_N),
    "poseidon": (PoseidonChainAir(),
                 _inner_case(inputs.REC_INNER["poseidon"][0]),
                 inputs.REC_INNER["poseidon"][1]),
}


@pytest.fixture(scope="module")
def jax_rec():
    """The JAX package's inner payloads, machines, transition values and
    outer proof, as recorded."""
    return rd.load("test_torch_recursion", inputs.test_torch_recursion())


def _port_inner(name):
    air, (vals, publics), log_n = INNER[name]
    pubs = [gl.to_fp(int(p) % P, "cpu") for p in publics]
    proof = prover.prove(air, gl.to_fp(vals, "cpu"), pubs, PCFG)
    assert verifier.verify(air, proof, pubs, log_n, PCFG)
    return air, proof, pubs, log_n


def assert_same_payload(proof, want) -> None:
    """The port's proof has the recorded JAX proof's payload, plane by
    plane."""
    assert rd.payload_fields(serialize.payload(proof), want) == want["fields"]


def _record(mod, air, proof, pubs, log_n, cfg, stream, **kw):
    mb = mod.MachineBuilder()
    cells = [mb.pin_public(v) for v in ra._pub_ints(pubs)]
    mod.record_stark_verify(mb, air, proof, cells, log_n, cfg, stream=stream,
                            **kw)
    return mod.RecursionAir(mb)


def _assert_same_machine(oair, want, trace=True):
    """`oair` against a JAX RecursionAir as recorded (record.py's
    ``machine``): rows, shape, publics, schedule digest, constant columns
    and, with `trace`, make_trace."""
    assert len(oair.mb.rows) == want["rows"]
    assert (oair.n_rows, oair.K, oair.num_cols, oair.num_consts,
            oair.has_ram) == tuple(want["shape"])
    assert oair.mb.publics == want["publics"]
    assert oair.schedule_digest() == want["schedule_digest"]
    assert (rd.array(oair.constant_columns(oair.n_rows))
            == want["constant_columns"])
    if trace:
        got, pubs = oair.make_trace("cpu")
        assert pubs == want["trace_publics"]
        assert rd.array(gl.to_u64(got)) == want["trace"]


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "streamed"])
@pytest.mark.parametrize("name", list(INNER))
def test_record_equals_reference(name, stream, jax_rec):
    air, proof, pubs, log_n = _port_inner(name)
    assert_same_payload(proof, jax_rec["inner"][name])
    oair = _record(ra, air, proof, pubs, log_n, PCFG, stream)
    _assert_same_machine(
        oair, jax_rec["record"][f"{name}-{'streamed' if stream else 'plain'}"])
    assert oair.has_ram == stream
    trace, opubs = oair.make_trace("cpu")
    assert check_constraints(oair, trace, [gl.to_fp(p, "cpu") for p in opubs])
    # the verifier's claim-shape rebuild gives the prover's schedule
    vair = ra.outer_air_for(air, log_n, PCFG, len(pubs), stream=stream,
                            device="cpu")
    assert vair.schedule_digest() == oair.schedule_digest()


@pytest.fixture(scope="module")
def fib8_outer_air():
    """The verifier's rebuild of FibonacciAir(8)'s recursion machine from
    its claim shape (3 publics), shared by the tests that need it."""
    return ra.outer_air_for(FibonacciAir(), 3, PCFG, 3, device="cpu")


def test_two_level_schedule_equals_reference(jax_rec, fib8_outer_air):
    """RecursionAir as the inner AIR (a RecursionAir proof recursed): its
    transition records through XAlgMB into the same rows as the JAX
    package's, from the claim shape alone (the level-1 machine verifies
    FibonacciAir(8); the level-1 config has final_poly_len 32 as in
    tests/test_recursion_air.py)."""
    cfg1 = dict(rate_bits=1, num_queries=2, final_poly_len=32)
    assert cfg1 == inputs.REC_TWO_LEVEL_CFG1
    l1 = fib8_outer_air
    _assert_same_machine(l1, jax_rec["two_level"]["l1"], trace=False)
    log_n1 = l1.n_rows.bit_length() - 1
    l2 = ra.outer_air_for(l1, log_n1, prover.StarkConfig(**cfg1), 3,
                          device="cpu")
    _assert_same_machine(l2, jax_rec["two_level"]["l2"], trace=False)


def _bare_machine(mod):
    """tests/test_recursion_air.py's bare machine: ALU rows, a canonical
    64-bit decomposition, a sponge and a two-to-one compression."""
    mb = mod.MachineBuilder()
    a = mb.pin_public(5)
    b = mb.pin_public(7)
    d = mb.axpy(mb.mul(a, b), a, 3)          # 5·7 + 3·5 = 50
    bits = mb.decompose64(d)
    mb.sponge([a, b])
    mb.eq_cells(mb.mux(bits[1], a, b), b)
    mb.eq_cells(mb.ladder(bits[:6], 3), mb.const(pow(3, 50, P)))
    mb.compress([mb.const(v) for v in (1, 2, 3, 4)],
                [mb.const(v) for v in (5, 6, 7, 8)])
    return mod.RecursionAir(mb)


def test_bare_machine_equals_reference_and_rejects_tampering():
    oair, jout = _bare_machine(ra), _bare_machine(jra)
    _assert_same_machine(oair, rd.machine(jout, trace=True))
    trace, pubs = oair.make_trace("cpu")
    fp = [gl.to_fp(p, "cpu") for p in pubs]
    assert check_constraints(oair, trace, fp)
    bad = trace.clone()
    bad[oair.COL_C, 5] ^= 1
    assert not check_constraints(oair, bad, fp)
    wrong = list(fp)
    wrong[0] = gl.to_fp(6, "cpu")              # a public the machine pins
    assert not check_constraints(oair, trace, wrong)


def test_transition_equals_reference_on_seeded_rows(jax_rec):
    """RecursionAir.transition and first_row under BaseVecAlgebra on 8
    seeded random rows per column, constant and public (the machine of a
    streamed FibonacciAir record: K registers in several banks, the RAM
    columns, three publics)."""
    air, proof, pubs, log_n = _port_inner("fib")
    assert_same_payload(proof, jax_rec["inner"]["fib"])
    oair = _record(ra, air, proof, pubs, log_n, PCFG, True)
    rng = np.random.default_rng(inputs.REC_TRANSITION_SEED)
    m = 8
    cols = rng.integers(0, P, (oair.num_cols, m), dtype=np.uint64)
    nxt = rng.integers(0, P, (oair.num_cols, m), dtype=np.uint64)
    cst = rng.integers(0, P, (oair.num_consts, m), dtype=np.uint64)
    cstn = rng.integers(0, P, (oair.num_consts, m), dtype=np.uint64)
    publics = [int(v) for v in rng.integers(0, P, oair.num_publics,
                                            dtype=np.uint64)]

    def port_rows(a):
        return list(gl.to_fp(a, "cpu"))

    alg = BaseVecAlgebra((m,), "cpu")
    ppubs = [gl.to_fp(p, "cpu") for p in publics]
    got = oair.transition(alg, port_rows(cols), port_rows(nxt), ppubs,
                          port_rows(cst), port_rows(cstn))
    got += oair.first_row(alg, port_rows(cols), ppubs, port_rows(cst))
    want = jax_rec["transition"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert rd.array(gl.to_u64(g)) == w


def _flip_leaf(t):
    bad = t.clone()
    bad.view(-1)[0] ^= 1
    return bad


@pytest.mark.parametrize("where", ["trace_cap", "fri_leaf", "const_zeta"])
def test_tampered_inner_proof_breaks_machine(where):
    """A tampered inner cap shifts every challenge, a tampered FRI leaf
    breaks its in-AIR Merkle path, a tampered constant opening breaks the
    ALI/DEEP consistency: the recorded witness cannot satisfy the
    machine."""
    name = "const" if where == "const_zeta" else "fib"
    air, proof, pubs, log_n = _port_inner(name)
    bad = copy.copy(proof)
    if where == "trace_cap":
        bad.trace_cap = _flip_leaf(proof.trace_cap)
    elif where == "fri_leaf":
        fp = copy.copy(proof.fri_proof)
        fp.query_leaves = ([_flip_leaf(fp.query_leaves[0])]
                           + list(fp.query_leaves[1:]))
        bad.fri_proof = fp
    else:
        bad.const_zeta = (_flip_leaf(proof.const_zeta[0]),
                          proof.const_zeta[1])
    oair = _record(ra, air, bad, pubs, log_n, PCFG, False)
    trace, opubs = oair.make_trace("cpu")
    assert not check_constraints(oair, trace,
                                 [gl.to_fp(p, "cpu") for p in opubs])


def _ram_balanced(oair, trace) -> bool:
    """The RAM multiset at seeded γ, δ on the trace domain: inverse
    definitions on every row, S steps on transitions, S(0) = 0 and S wraps
    to 0 (tests/test_recursion_stream.py's check)."""
    n = trace.shape[1]
    rng = np.random.default_rng(123)
    gamma, delta = (tuple(gl.to_fp(int(v), "cpu").reshape(())
                          for v in rng.integers(1, P, 2, dtype=np.uint64))
                    for _ in range(2))
    cfp = gl.to_fp(oair.constant_columns(n), "cpu")
    aux = prover._build_ram_aux(oair, trace, gamma, delta, cfp)
    mult_c, ld_c, ad_c, act_c, val_col = oair.ram_multiset()

    def cc(i):
        return ext.from_base(cfp[i])

    r_e, r_t, r_f, r_l = prover._ram_constraint_evals(
        gamma, delta, cc(ad_c), cc(mult_c), cc(ld_c), cc(act_c),
        ext.from_base(trace[val_col]), (aux[0], aux[1]), (aux[2], aux[3]),
        (torch.roll(aux[2], -1), torch.roll(aux[3], -1)))

    def zero(v, sl):
        return bool(torch.all(v[0][sl] == 0) and torch.all(v[1][sl] == 0))

    return (all(zero(c, slice(None)) for c in r_e)
            and all(zero(c, slice(0, n - 1)) for c in r_t)
            and all(zero(c, slice(0, 1)) for c in r_f)
            and all(zero(c, slice(n - 1, n)) for c in r_l))


def test_streamed_ram_balances_and_rejects_tampering():
    """The streamed record's value RAM balances; a flipped value on a RAM
    LOAD row unbalances it; a tampered ζ-opening breaks the
    transcript-replay binding (tests/test_recursion_stream.py)."""
    air, proof, pubs, log_n = _port_inner("fib")
    oair = _record(ra, air, proof, pubs, log_n, PCFG, True)
    trace, opubs = oair.make_trace("cpu")
    fp = [gl.to_fp(p, "cpu") for p in opubs]
    assert _ram_balanced(oair, trace)
    load_rows = np.nonzero(oair.constant_columns(oair.n_rows)[oair.C_RLOAD])[0]
    assert load_rows.size > 0
    bad = trace.clone()
    bad[oair.COL_C, int(load_rows[0])] ^= 1
    assert not (_ram_balanced(oair, bad) and check_constraints(oair, bad, fp))

    re = proof.trace_zeta[0].clone()
    re[0] = gl.add(re[0], gl.ones((), "cpu"))
    tampered = copy.copy(proof)
    tampered.trace_zeta = (re, proof.trace_zeta[1])
    oair2 = _record(ra, air, tampered, pubs, log_n, PCFG, True)
    t2, p2 = oair2.make_trace("cpu")
    assert not (check_constraints(oair2, t2, [gl.to_fp(p, "cpu") for p in p2])
                and _ram_balanced(oair2, t2))


def _reduce_program(children, links, expose, forge_start=False):
    """tests/test_recursion_air.py's reduce node, optionally with child B
    claiming a start one past A's end (a broken link)."""
    mb = ra.MachineBuilder()
    cl = [[mb.loadw(v) for v in ra._pub_ints(pu)]
          for (_, _, pu, _, _) in children]
    if forge_start:
        cl[1][0] = mb.loadw((ra._pub_ints(children[1][2])[0] + 1) % P)
    for (ci, pi) in expose:
        pc = mb.pin_public(mb.vals[cl[ci][pi]])
        mb.eq_cells(pc, cl[ci][pi])
    for (ci, pi, cj, pj) in links:
        mb.eq_cells(cl[ci][pi], cl[cj][pj])
    for (ai, pri, pu, ln, cf), cc in zip(children, cl):
        ra.record_stark_verify(mb, ai, pri, cc, ln, cf)
    return ra.RecursionAir(mb)


def test_reduce_links_expose_and_broken_link():
    """Two chained FibonacciAir claims in one reduce node: satisfiable,
    the exposed claim is (a0_A, b0_A, res_B), record_reduce and the
    verifier's reduce_air_for give this schedule; a forged continuation
    breaks the link."""
    air, prA, pubA, log_n = _port_inner("fib")
    trA, _ = FibonacciAir.make_trace(1 << log_n, device="cpu")
    a_last, b_last = (int(v) for v in gl.from_fp(trA[:, -1]))
    trB, pB = FibonacciAir.make_trace(1 << log_n, a_last, b_last,
                                      device="cpu")
    pubB = [gl.to_fp(p, "cpu") for p in pB]
    prB = prover.prove(air, trB, pubB, PCFG)
    children = [(air, prA, pubA, log_n, PCFG), (air, prB, pubB, log_n, PCFG)]
    links = [(0, 2, 1, 0)]
    expose = [(0, 0), (0, 1), (1, 2)]
    oair = _reduce_program(children, links, expose)
    trace, opubs = oair.make_trace("cpu")
    assert check_constraints(oair, trace, [gl.to_fp(p, "cpu") for p in opubs])
    assert opubs == [ra._pub_ints(pubA)[0], ra._pub_ints(pubA)[1],
                     ra._pub_ints(pubB)[2]]
    rec = ra.RecursionAir(ra.record_reduce(children, links, expose))
    assert rec.schedule_digest() == oair.schedule_digest()
    vair = ra.reduce_air_for([(air, log_n, PCFG, 3)] * 2, links, expose,
                             device="cpu")
    assert vair.schedule_digest() == oair.schedule_digest()

    bad = _reduce_program(children, links, expose, forge_start=True)
    t2, p2 = bad.make_trace("cpu")
    assert not check_constraints(bad, t2, [gl.to_fp(p, "cpu") for p in p2])


@pytest.fixture(scope="module")
def recursive_proof():
    """ONE outer proof of FibonacciAir(8)'s verification, on the CPU (the
    module's heaviest part: its own phase under the time limit)."""
    n = inputs.REC_RECURSIVE_N
    trace, publics = FibonacciAir.make_trace(n, device="cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    air = FibonacciAir()
    inner = prover.prove(air, trace, pubs, PCFG)
    return (air, pubs, inner) + ra.prove_recursive(air, inner, pubs, 3, PCFG,
                                                   PCFG, device="cpu")


def test_prove_recursive_payload_equals_reference_and_verifies_both_ways(
        jax_rec, recursive_proof, fib8_outer_air):
    """ONE outer proof of FibonacciAir(8)'s verification: the port's CPU
    payload equals the JAX package's; the port verifier accepts it against
    outer_air_for's rebuild and refuses a changed public; the JAX verifier
    accepts the port's proof (its recorded verdict on its own proof, whose
    payload and publics the port's equal)."""
    want = jax_rec["prove_recursive"]
    air, pubs, inner, oair, oproof, opubs = recursive_proof
    assert_same_payload(inner, want["inner"])
    assert opubs == want["opubs"]
    assert_same_payload(oproof, want["payload"])

    olog = oair.n_rows.bit_length() - 1
    assert len(pubs) == 3
    vair = fib8_outer_air
    assert vair.schedule_digest() == oair.schedule_digest()
    ofp = [gl.to_fp(p, "cpu") for p in opubs]
    assert verifier.verify(vair, oproof, ofp, olog, PCFG)
    bad = list(ofp)
    bad[2] = gl.to_fp((opubs[2] + 1) % P, "cpu")
    assert not verifier.verify(vair, oproof, bad, olog, PCFG)
    assert want["jax_verifier_accepts"] is True
