"""Port vs JAX package: the DSL (stark/dsl.py) and the Poseidon chain AIR
re-authored in it (stark/air_poseidon_dsl.py), the analogues of
tests/test_dsl.py.

The DSL Poseidon AIR accepts the hand-written PoseidonChainAir's witness
and rejects a flipped cell; it proves and verifies, its CPU payload equals
the JAX DSL AIR's (the module's one JAX prove, ~110 s) and the port's
hand-written AIR's; the u32/bit/select accumulator authored in the DSL
rejects a flipped bit and a flag of 2. The accumulator and an AIR using
every other DSL construct give the JAX package's constraint values,
constraint for constraint, on seeded rows under the base-field and the
extension ring, and the Poseidon proof recorded
through the recursion machine's ring (XAlgMB) gives the JAX package's
machine (rows, K, schedule digest, constant columns; the trace on 4,096
sampled rows, as test_torch_recursion_leaf.py compares it: the JAX
make_trace of this 131,072-row machine takes ~70 s). ``ctx.nxt()``
outside a transition raises in the port (the JAX package reads the
current row there); no DSL AIR in use calls it, so the payloads above
are unchanged. Tolerance: exact equality throughout.

The JAX package's side is recorded (tests/reference_data/test_torch_dsl.json,
made by tests/reference_data/record.py): its hand-written PoseidonChainAir
trace, the DSL AIR's proof of it and that proof's two machines, and the
constraint values; the port's trace and proof equal the recorded ones
before the machines are compared.
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.stark import dsl as jdsl
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import dsl, prover, serialize, verifier
from vectorx_tpu_torch.stark import recursion_air as ra
from vectorx_tpu_torch.stark.air import (BaseVecAlgebra, ExtAlgebra,
                                         check_constraints)
from vectorx_tpu_torch.stark.air_poseidon import PoseidonChainAir
from vectorx_tpu_torch.stark.air_poseidon_dsl import build_poseidon_chain_air

import reference_data as rd
from oracle import P
from reference_data import inputs
from reference_data.inputs import acc_air as _acc_air
from reference_data.inputs import combinators_air as _combinators_air
from test_torch_recursion import (_assert_same_machine, _record,
                                  assert_same_payload)
from test_torch_recursion_leaf import assert_trace_sample_equal

torch.set_num_threads(1)

CFG = inputs.DSL_CFG
PCFG = prover.StarkConfig(**CFG)
LOG_N = inputs.DSL_LOG_N


def _fp(publics):
    return [gl.to_fp(int(p) % P, "cpu") for p in publics]


def _poseidon_case():
    trace, publics, _ = PoseidonChainAir.make_trace(*inputs.DSL_POSEIDON,
                                                    "cpu")
    return trace, [int(p) for p in publics]


def _acc_case():
    """The accumulator's witness through the port's TraceWriter."""
    b, air, v, flag = _acc_air(dsl)
    n = 16
    w = dsl.TraceWriter(b, n)
    val = 250
    for r in range(n):
        w.set_uint(v, r, val)
        f = 1 if r % 2 == 0 and r < n - 1 else 0
        w.set(flag, r, f)
        val += f
    return air, v, flag, w.finish("cpu"), [250, val]


@pytest.fixture(scope="module")
def jax_poseidon():
    """The JAX side, as recorded: the JAX package's PoseidonChainAir trace
    and publics, the JAX DSL Poseidon AIR's proof of them (the module's
    JAX prove) and its two recursion machines."""
    want = rd.load("test_torch_dsl", inputs.test_torch_dsl())
    trace, publics = _poseidon_case()
    assert rd.array(gl.to_u64(trace)) == want["poseidon"]["trace"]
    assert publics == want["poseidon"]["publics"]
    return want


def test_dsl_poseidon_port_accepts_handwritten_witness():
    air, (s, x3, x7, ph) = build_poseidon_chain_air()
    ref = PoseidonChainAir()
    assert (air.num_cols, air.num_publics) == (ref.num_cols, ref.num_publics)
    assert [c.idx for c in s + x3 + x7 + ph] == list(range(ref.num_cols))
    trace, publics = _poseidon_case()
    assert check_constraints(air, trace, _fp(publics))
    bad = trace.clone()
    bad[0, 5] ^= 1
    assert not check_constraints(air, bad, _fp(publics))


def test_dsl_poseidon_port_proves_verifies_and_matches_reference(
        jax_poseidon):
    air, _ = build_poseidon_chain_air()
    trace, publics = _poseidon_case()
    proof = prover.prove(air, trace, _fp(publics), PCFG)
    assert verifier.verify(air, proof, _fp(publics), LOG_N, PCFG)
    bad = list(publics)
    bad[12] = (bad[12] + 1) % P
    assert not verifier.verify(air, proof, _fp(bad), LOG_N, PCFG)
    payload = serialize.payload(proof)
    want = jax_poseidon["poseidon"]["payload"]
    assert rd.payload_fields(payload, want) == want["fields"]
    # the same constraints in the same order as the hand-written AIR
    hand = prover.prove(PoseidonChainAir(), trace, _fp(publics), PCFG)
    assert payload == serialize.payload(hand)


def test_dsl_typed_families_and_select():
    """u32 (bytes-of-bits) well-formedness + the select combinator."""
    air, v, flag, trace, publics = _acc_case()
    assert trace.device == torch.device("cpu")
    assert trace.shape == (air.num_cols, 16) and air.num_cols == 38
    assert check_constraints(air, trace, _fp(publics))
    # a BIT inside the byte family: the recomposition breaks
    bad = trace.clone()
    bad[v.parts[0].parts[3].idx, 4] ^= 1
    assert not check_constraints(air, bad, _fp(publics))
    # a flag of 2: booleanity breaks
    bad2 = trace.clone()
    bad2[flag.idx, 2] = 2
    assert not check_constraints(air, bad2, _fp(publics))
    cfg = prover.StarkConfig(**CFG)
    proof = prover.prove(air, trace, _fp(publics), cfg)
    assert verifier.verify(air, proof, _fp(publics), 4, cfg)


def _dsl_airs(which):
    if which == "acc":
        return _acc_air(dsl)[1], _acc_air(jdsl)[1]
    return _combinators_air(dsl), _combinators_air(jdsl)


@pytest.mark.parametrize("ring", ["base", "ext"])
@pytest.mark.parametrize("which", ["acc", "combinators"])
def test_constraint_values_equal_reference(which, ring, jax_poseidon):
    """transition, first_row and last_row of the port's and the JAX
    package's DSL AIR on the same seeded rows, constants and publics:
    under the base-field ring on 8 rows, and under the extension ring at
    one point. (The Poseidon DSL AIR's values are held by its payload
    above: its quotient is the JAX package's at every LDE point.) The JAX
    package's values are recorded."""
    air, jair = _dsl_airs(which)
    k = air.constant_columns(8).shape[0]
    assert k == jair.constant_columns(8).shape[0]
    # [local, next, consts, consts_next] x [re, im] x columns x points
    vals, pubs = inputs.dsl_constraint_inputs(air.num_cols, k,
                                              air.num_publics, ring)
    m = vals.shape[3]
    widths = (air.num_cols, air.num_cols, k, k)
    if ring == "base":
        alg = BaseVecAlgebra((m,), "cpu")
        port = [list(gl.to_fp(vals[i, 0, :w], "cpu"))
                for i, w in enumerate(widths)]
    else:
        alg = ExtAlgebra("cpu")
        port = []
        for i, w in enumerate(widths):
            re, im = (gl.to_fp(vals[i, j, :w, 0], "cpu") for j in (0, 1))
            port.append([(re[c], im[c]) for c in range(w)])
    ppubs = [gl.to_fp(p, "cpu").reshape(()) for p in pubs]
    got = (air.transition(alg, port[0], port[1], ppubs, port[2], port[3])
           + air.first_row(alg, port[0], ppubs, port[2])
           + air.last_row(alg, port[0], ppubs, port[2]))
    want = jax_poseidon["constraints"][f"{which}-{ring}"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        pairs = zip(g, w) if ring == "ext" else [(g, w)]
        for a, b in pairs:
            assert rd.array(np.broadcast_to(gl.to_u64(a), b["shape"])) == b


def test_nxt_outside_a_transition_raises():
    """ctx.nxt in first_row / last_row, Col.nxt evaluated there, and a
    next-row read in an every_row function (which the last-row class also
    runs) raise ValueError; transitions read the next row as before."""
    alg = BaseVecAlgebra((2,), "cpu")
    row = [gl.zeros((2,), "cpu")]

    def air_with(register, fn):
        b = dsl.AirBuilder(num_publics=0)
        c = b.felt("c")
        getattr(b, register)(lambda ctx: fn(ctx, c))
        return b.build()

    first = air_with("first_row", lambda ctx, c: ctx.eq(ctx.nxt(c), 0))
    with pytest.raises(ValueError, match="next row"):
        first.first_row(alg, row, [])
    last = air_with("last_row", lambda ctx, c: ctx.eq(ctx.nxt(c), 0))
    with pytest.raises(ValueError, match="next row"):
        last.last_row(alg, row, [])
    direct = air_with("first_row", lambda ctx, c: ctx.eq(c.nxt(), 0))
    with pytest.raises(ValueError, match="next row"):
        direct.first_row(alg, row, [])
    every = air_with("every_row", lambda ctx, c: ctx.eq(ctx.nxt(c), 0))
    assert len(every.transition(alg, row, row, [])) == 1
    with pytest.raises(ValueError, match="next row"):
        every.last_row(alg, row, [])
    # a constant column's next row is refused the same way
    b = dsl.AirBuilder(num_publics=0)
    k = b.constant("k", [1, 2])
    b.felt("c")
    b.first_row(lambda ctx: ctx.eq(k.nxt(), 0))
    with pytest.raises(ValueError, match="next row"):
        b.build().first_row(alg, row, [], [gl.zeros((2,), "cpu")])


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "streamed"])
def test_recorded_dsl_poseidon_equals_reference(stream, jax_poseidon):
    """The DSL Poseidon AIR's proof recorded through XAlgMB (the DSL's
    expressions on the machine ring) gives the JAX package's machine."""
    air, _ = build_poseidon_chain_air()
    trace, publics = _poseidon_case()
    proof = prover.prove(air, trace, _fp(publics), PCFG)
    assert_same_payload(proof, jax_poseidon["poseidon"]["payload"])
    want = jax_poseidon["poseidon"]["streamed" if stream else "plain"]
    oair = _record(ra, air, proof, publics, LOG_N, PCFG, stream)
    assert oair.has_ram == stream
    _assert_same_machine(oair, want, trace=False)
    assert_trace_sample_equal(oair, want)
    vair = ra.outer_air_for(air, LOG_N, PCFG, len(publics), stream=stream,
                            device="cpu")
    assert vair.schedule_digest() == oair.schedule_digest()


def test_trace_writer_fills_the_uint_families():
    """set_uint writes a u32's value column, its bytes and their bits, in
    the builder's column order (the device default of finish is held in
    test_torch_device.py)."""
    b, _, v, _ = _acc_air(dsl)
    w = dsl.TraceWriter(b, 4)
    w.set_uint(v, 0, 0x01020304)
    got = [int(x) for x in gl.from_fp(w.finish("cpu")[:, 0])]
    assert got[:20] == [0x01020304, 4, 0, 0, 1, 0, 0, 0, 0, 0,
                        3, 1, 1, 0, 0, 0, 0, 0, 0, 2]
