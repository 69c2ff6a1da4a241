"""Record the JAX package's side of the port's parity tests.

    JAX_PLATFORMS=cpu python tests/reference_data/record.py [module ...] [--out DIR]

For each named test module (all of them by default) this computes, with
the frozen ``vectorx_tpu`` on the CPU, every costly value the module's
parity tests compare the port against (proof payloads, traces, constant
columns, recursion machines, constraint values, verifier verdicts), from
the inputs ``inputs.py`` builds, and writes ``<module>.json`` into DIR
(default: this directory). Imports nothing of ``vectorx_tpu_torch``.
The output depends only on the inputs and the package: a rerun writes
the same values (``tests/test_recorded_reference.py``, ``-m slow``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parents[1]), str(HERE.parent)]

# the tests' JAX environment (tests/conftest.py): an 8-device CPU mesh
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import reference_data as rd  # noqa: E402
from reference_data import inputs  # noqa: E402
from vectorx_tpu.field import goldilocks as jgl  # noqa: E402
from vectorx_tpu.stark import prover as jprover  # noqa: E402
from vectorx_tpu.stark import serialize as jserialize  # noqa: E402
from vectorx_tpu.stark import verifier as jverifier  # noqa: E402

RECORDERS = {}


def recorder(fn):
    RECORDERS[fn.__name__] = fn
    return fn


def proof_payload(jproof, data: bool = False) -> dict:
    """The payload of a JAX StarkProof, plane by plane under its path; the
    planes are exactly split_payload(serialize_proof(jproof))."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jproof)
    names = [jax.tree_util.keystr(path) for path, _ in flat]
    planes = [np.asarray(leaf) for _, leaf in flat]
    data_bytes = jserialize.serialize_proof(jproof)
    hlen = int.from_bytes(data_bytes[4:8], "little")
    assert b"".join(p.tobytes() for p in planes) == data_bytes[8 + hlen:]
    return rd.payload(planes, names, data)


# -- the recorders, one per test module ---------------------------------------------

@recorder
def test_torch_header():
    from vectorx_tpu.stark import air_header as jah
    inp = inputs.test_torch_header()
    air = jah.HeaderAir(max_chunks=1)
    trace, publics, _ = air.make_trace(inp["header"])
    pubs = [jgl.to_fp(int(p)) for p in publics]
    proof = jprover.prove(air, trace, pubs, jprover.StarkConfig(**inp["cfg"]))
    return inp, {
        "publics": [int(p) for p in publics],
        "trace": rd.array(rd.u64(trace)),
        "constant_columns": rd.array(air.constant_columns(air.n_rows)),
        "payload": proof_payload(proof),
    }


@recorder
def test_torch_stark():
    from vectorx_tpu.stark.air import FibonacciAir
    inp = inputs.test_torch_stark()
    log_n = inp["log_n"]
    trace, publics = FibonacciAir.make_trace(1 << log_n)
    pubs = [jgl.to_fp(p) for p in publics]
    out = {}
    for name, kw in inp["configs"].items():
        cfg = jprover.StarkConfig(**kw)
        proof = jprover.prove(FibonacciAir(), trace, pubs, cfg)
        out[name] = {
            "payload": proof_payload(proof, data=True),
            "jax_verifier_accepts": bool(jverifier.verify(
                FibonacciAir(), proof, pubs, log_n, cfg)),
        }
    return inp, out


@recorder
def test_torch_lookup():
    from vectorx_tpu.stark.air import Air
    inp = inputs.test_torch_lookup()
    cfg = jprover.StarkConfig(**inputs.LOOKUP_CFG)
    proofs = {}
    for name, (make, (vals, publics), log_n) in inputs.LOOKUP_CASES.items():
        air = make(Air)
        pubs = [jgl.to_fp(p) for p in publics]
        proof = jprover.prove(air, jgl.to_fp(vals), pubs, cfg)
        proofs[name] = {
            "payload": proof_payload(proof, data=True),
            "jax_verifier_accepts": bool(jverifier.verify(air, proof, pubs,
                                                          log_n, cfg)),
        }

    def ext(v):
        return jgl.to_fp(v[0]), jgl.to_fp(v[1])

    aux = {}
    for name, case in (("range", inputs.LOOKUP_CASES["range"]),
                       ("range_odd", inputs.ODD_RANGE),
                       ("ram", inputs.LOOKUP_CASES["ram"])):
        make, (vals, _), log_n = case
        air = make(Air)
        aux[name] = rd.array(rd.u64(jprover._build_aux(
            air, jgl.to_fp(vals), air.lookup_range_columns(),
            ext(inputs.GAMMA), ext(inputs.DELTA), 1 << log_n)))
    make, (vals, _), log_n = inputs.BAD_RANGE
    aux["range_out_of_range"] = rd.array(rd.u64(jprover._build_aux(
        make(Air), jgl.to_fp(vals), [0, 1], ext(inputs.GAMMA), None,
        1 << log_n)))
    return inp, {"proofs": proofs, "aux": aux}


# -- the recursion machine -------------------------------------------------------------

def record_machine(air, proof, publics, log_n, cfg, stream):
    """The JAX package's RecursionAir of one inner proof's verification."""
    from vectorx_tpu.stark import recursion_air as jra
    mb = jra.MachineBuilder()
    cells = [mb.pin_public(int(v) % inputs.P) for v in publics]
    jra.record_stark_verify(mb, air, proof, cells, log_n, cfg, stream=stream)
    return jra.RecursionAir(mb)


def jax_trace_rows(jout, rows) -> np.ndarray:
    """(num_cols, len(rows)) uint64: the JAX machine's trace at the sorted
    `rows`, as the JAX package's RecursionAir.make_trace fills it (hash
    lanes from the sponge snapshots, the final state on pad rows; x3/x7
    of h + the row's round constants; each register holding its last
    write from an earlier row; the A/B/C values of recorded rows). The
    JAX make_trace fills an object array of every cell: minutes at 2^18
    rows."""
    from vectorx_tpu.hashes import poseidon as jps
    P = inputs.P
    mb = jout.mb
    nr = len(mb.rows)
    rows = [int(r) for r in rows]
    out = np.zeros((jout.num_cols, len(rows)), dtype=np.uint64)
    rcs = jps.round_constants()
    for j, i in enumerate(rows):
        row = mb.rows[i] if i < nr else None
        h = mb.hsnap[i] if i < nr else mb.h
        rc = rcs[row.hround] if row is not None and row.hround >= 0 else None
        t = [(x + (rc[k] if rc else 0)) % P for k, x in enumerate(h)]
        x3 = [(v * v % P) * v % P for v in t]
        x7 = [(a * a % P) * v % P for a, v in zip(x3, t)]
        out[jout.COL_H:jout.COL_H + 12, j] = h
        out[jout.COL_X3:jout.COL_X3 + 12, j] = x3
        out[jout.COL_X7:jout.COL_X7 + 12, j] = x7
        if row is not None:
            out[[jout.COL_A, jout.COL_B, jout.COL_C], j] = [
                row.aval % P, row.bval % P, row.cval % P]
    regs = [0] * jout.K
    k = 0
    for i in range(rows[-1] + 1):
        while k < len(rows) and rows[k] == i:
            out[jout.COL_R:jout.COL_R + jout.K, k] = regs
            k += 1
        if i < nr:
            row = mb.rows[i]
            if row.cell >= 0 and jout.reg[row.cell] >= 0:
                regs[jout.reg[row.cell]] = mb.vals[row.cell]
    return out


def trace_sample(jout) -> dict:
    """make_trace's publics, and its values on inputs.sample_rows."""
    rows = inputs.sample_rows(jout.n_rows)
    return {"trace_publics": [int(p) for p in jout.mb.publics],
            "trace_rows": rd.array(jax_trace_rows(jout, rows))}


def fib_trace(n, a0=0, b0=1):
    from vectorx_tpu.stark.air import FibonacciAir
    return FibonacciAir.make_trace(n, a0, b0)


def rec_inner(name, cfg):
    """The JAX inner proof of test_torch_recursion's INNER[name], from the
    JAX package's own trace builders -> (air, proof, publics, log_n)."""
    from vectorx_tpu.stark.air import Air, FibonacciAir
    from vectorx_tpu.stark.air_poseidon import PoseidonChainAir
    spec, log_n = inputs.REC_INNER[name]
    air = {"fib": FibonacciAir, "poseidon": PoseidonChainAir,
           "range": lambda: inputs.range_air(Air),
           "const": lambda: inputs.const_air(Air)}[name]()
    if "fibonacci" in spec:
        trace, publics = fib_trace(spec["fibonacci"])
    elif "poseidon_chain" in spec:
        trace, publics, _ = PoseidonChainAir.make_trace(*spec["poseidon_chain"])
    else:
        vals, publics = spec["values"]
        trace = jgl.to_fp(vals)
    publics = [int(p) % inputs.P for p in publics]
    proof = jprover.prove(air, trace, [jgl.to_fp(p) for p in publics], cfg)
    return air, proof, publics, log_n


@recorder
def test_torch_recursion():
    from vectorx_tpu.stark import recursion_air as jra
    from vectorx_tpu.stark.air import BaseVecAlgebra, FibonacciAir
    inp = inputs.test_torch_recursion()
    P = inputs.P
    cfg = jprover.StarkConfig(**inputs.REC_CFG)
    inner, record = {}, {}
    for name in inputs.REC_INNER:
        air, proof, publics, log_n = rec_inner(name, cfg)
        inner[name] = proof_payload(proof)
        for stream in (False, True):
            jout = record_machine(air, proof, publics, log_n, cfg, stream)
            record[f"{name}-{'streamed' if stream else 'plain'}"] = rd.machine(
                jout, trace=True)
            if name == "fib" and stream:
                fib_streamed = jout

    cfg1 = jprover.StarkConfig(**inputs.REC_TWO_LEVEL_CFG1)
    l1 = jra.outer_air_for(FibonacciAir(), 3, cfg, 3)
    l2 = jra.outer_air_for(l1, l1.n_rows.bit_length() - 1, cfg1, 3)
    two_level = {"l1": rd.machine(l1), "l2": rd.machine(l2)}

    jout = fib_streamed
    rng = np.random.default_rng(inputs.REC_TRANSITION_SEED)
    m = 8
    cols = rng.integers(0, P, (jout.num_cols, m), dtype=np.uint64)
    nxt = rng.integers(0, P, (jout.num_cols, m), dtype=np.uint64)
    cst = rng.integers(0, P, (jout.num_consts, m), dtype=np.uint64)
    cstn = rng.integers(0, P, (jout.num_consts, m), dtype=np.uint64)
    publics = [int(v) for v in rng.integers(0, P, jout.num_publics,
                                            dtype=np.uint64)]

    def jax_rows(a):
        fp = jgl.to_fp(a)
        return [(fp[0][i], fp[1][i]) for i in range(a.shape[0])]

    jalg = BaseVecAlgebra((m,))
    jpubs = [jgl.to_fp(p) for p in publics]
    want = jout.transition(jalg, jax_rows(cols), jax_rows(nxt), jpubs,
                           jax_rows(cst), jax_rows(cstn))
    want += jout.first_row(jalg, jax_rows(cols), jpubs, jax_rows(cst))
    transition = [rd.array(rd.u64(w)) for w in want]

    n = inputs.REC_RECURSIVE_N
    trace, publics = fib_trace(n)
    jpubs = [jgl.to_fp(int(p)) for p in publics]
    jinner = jprover.prove(FibonacciAir(), trace, jpubs, cfg)
    jair_out, jproof, jopubs = jra.prove_recursive(
        FibonacciAir(), jinner, jpubs, n.bit_length() - 1, cfg, cfg)
    opubs = [int(p) for p in jopubs]
    olog = jair_out.n_rows.bit_length() - 1
    recursive = {
        "inner": proof_payload(jinner),
        "opubs": opubs,
        "payload": proof_payload(jproof),
        "jax_verifier_accepts": bool(jverifier.verify(
            jair_out, jproof, [jgl.to_fp(p) for p in opubs], olog, cfg)),
    }
    return inp, {"inner": inner, "record": record, "two_level": two_level,
                 "transition": transition, "prove_recursive": recursive}


@recorder
def test_torch_aggregate():
    from vectorx_tpu.stark import recursion_air as jra
    from vectorx_tpu.stark.air import FibonacciAir
    inp = inputs.test_torch_aggregate()
    cfg = jprover.StarkConfig(**inputs.REC_CFG)
    n = inputs.AGG_N
    log_n = n.bit_length() - 1
    trace_a, pub_a = fib_trace(n)
    a_last, b_last = (int(v) for v in rd.u64(trace_a)[:, -1])
    trace_b, pub_b = fib_trace(n, a_last, b_last)
    children = []
    for trace, publics in ((trace_a, pub_a), (trace_b, pub_b)):
        publics = [int(p) % inputs.P for p in publics]
        proof = jprover.prove(FibonacciAir(), trace,
                              [jgl.to_fp(p) for p in publics], cfg)
        children.append((FibonacciAir(), proof, publics, log_n, cfg))
    mb = jra.MachineBuilder()
    cl = [[mb.loadw(v) for v in pu] for (_, _, pu, _, _) in children]
    for (ci, pi) in inputs.AGG_EXPOSE:
        pc = mb.pin_public(mb.vals[cl[ci][pi]])
        mb.eq_cells(pc, cl[ci][pi])
    for (ci, pi, cj, pj) in inputs.AGG_LINKS:
        mb.eq_cells(cl[ci][pi], cl[cj][pj])
    for (a, pr, pu, ln, cf), cc in zip(children, cl):
        jra.record_stark_verify(mb, a, pr, cc, ln, cf)
    return inp, {"inner": [proof_payload(c[1]) for c in children],
                 "reduce": rd.machine(jra.RecursionAir(mb), trace=True)}


@recorder
def test_torch_dsl():
    from vectorx_tpu.stark import dsl as jdsl
    from vectorx_tpu.stark.air import BaseVecAlgebra, ExtAlgebra
    from vectorx_tpu.stark.air_poseidon import PoseidonChainAir
    from vectorx_tpu.stark.air_poseidon_dsl import build_poseidon_chain_air
    inp = inputs.test_torch_dsl()
    cfg = jprover.StarkConfig(**inputs.DSL_CFG)
    log_n = inputs.DSL_LOG_N
    jair, _ = build_poseidon_chain_air()
    trace, publics, _ = PoseidonChainAir.make_trace(*inputs.DSL_POSEIDON)
    publics = [int(p) % inputs.P for p in publics]
    proof = jprover.prove(jair, trace, [jgl.to_fp(p) for p in publics], cfg)
    poseidon = {"trace": rd.array(rd.u64(trace)), "publics": publics,
                "payload": proof_payload(proof)}
    for stream in (False, True):
        jout = record_machine(jair, proof, publics, log_n, cfg, stream)
        poseidon["streamed" if stream else "plain"] = {
            **rd.machine(jout), **trace_sample(jout)}

    constraints = {}
    for which, make in inputs.DSL_AIRS.items():
        air = make(jdsl)
        k = air.constant_columns(8).shape[0]
        widths = (air.num_cols, air.num_cols, k, k)
        for ring in ("base", "ext"):
            vals, pubs = inputs.dsl_constraint_inputs(
                air.num_cols, k, air.num_publics, ring)
            m = vals.shape[3]
            if ring == "base":
                alg = BaseVecAlgebra((m,))
                fps = [jgl.to_fp(vals[i, 0, :w]) for i, w in enumerate(widths)]
                rows = [[(f[0][c], f[1][c]) for c in range(w)]
                        for f, w in zip(fps, widths)]
            else:
                alg = ExtAlgebra()
                rows = []
                for i, w in enumerate(widths):
                    re, im = (jgl.to_fp(vals[i, j, :w, 0]) for j in (0, 1))
                    rows.append([((re[0][c], re[1][c]), (im[0][c], im[1][c]))
                                 for c in range(w)])
            jpubs = [jgl.to_fp(p) for p in pubs]
            want = (air.transition(alg, rows[0], rows[1], jpubs, rows[2],
                                   rows[3])
                    + air.first_row(alg, rows[0], jpubs, rows[2])
                    + air.last_row(alg, rows[0], jpubs, rows[2]))
            constraints[f"{which}-{ring}"] = [
                [rd.array(rd.u64(w[0])), rd.array(rd.u64(w[1]))] if ring == "ext"
                else rd.array(rd.u64(w)) for w in want]
    return inp, {"poseidon": poseidon, "constraints": constraints}


@recorder
def test_torch_recursion_leaf():
    from vectorx_tpu.stark import air_header as jah
    inp = inputs.test_torch_recursion_leaf()
    cfg = jprover.StarkConfig(**inputs.LEAF_CFG)
    log_n = inputs.LEAF_LOG_N
    air = jah.HeaderAir(max_chunks=1)
    trace, publics, _ = air.make_trace(inputs.LEAF_HEADER)
    publics = [int(p) for p in publics]
    proof = jprover.prove(air, trace, [jgl.to_fp(p) for p in publics], cfg)
    jout = record_machine(air, proof, publics, log_n, cfg, False)
    plain = rd.machine(jout, consts=False)
    del jout
    jout = record_machine(air, proof, publics, log_n, cfg, True)
    streamed = {**rd.machine(jout), **trace_sample(jout)}
    return inp, {"inner": proof_payload(proof), "plain": plain,
                 "streamed": streamed}


def statement(module):
    """The JAX package's trace, constants, publics and proof of each
    statement AIR whose parity `module` holds."""
    from vectorx_tpu.stark import air_poseidon as jpos
    from vectorx_tpu.stark import air_sha256_chain as jchain
    from vectorx_tpu.stark import air_sha256_merkle as jmerkle
    from vectorx_tpu.stark import air_sha512 as j512
    inp = inputs.statement(module)
    cfg = jprover.StarkConfig(**inputs.STMT_CFG)
    out = {}
    for name in inputs.STMT_MODULES[module]:
        if name == "poseidon_chain":
            air = jpos.PoseidonChainAir()
            trace, publics, _ = air.make_trace(inputs.STMT_STATE, 2)
        elif name == "sha256_chain":
            air = jchain.ChainedSha256Air(2)
            words = air.pubkeys_to_words(inputs.STMT_KEYS, 2)
            trace, publics, _ = air.make_trace(words, 2)
        elif name == "sha256_merkle":
            air = jmerkle.MerkleSha256Air(
                inputs.leaf_words(inputs.STMT_LEAVES))
            trace, publics, _ = air.make_trace()
        else:
            air = j512.Sha512ChallengeAir([inputs.sha512_lane(7)],
                                          inputs.STMT_MSG, B=8)
            trace, publics = air.make_trace()
        publics = [int(p) for p in publics]
        n = trace[0].shape[1]
        proof = jprover.prove(air, trace, [jgl.to_fp(p) for p in publics], cfg)
        out[name] = {
            "publics": publics,
            "trace": rd.array(rd.u64(trace)),
            "constant_columns": rd.array(np.asarray(air.constant_columns(n),
                                                    dtype=np.uint64)),
            "lookup_range_columns": [int(c) for c in
                                     air.lookup_range_columns()],
            "payload": proof_payload(proof),
        }
    return inp, out


@recorder
def test_torch_statement_airs():
    return statement("test_torch_statement_airs")


@recorder
def test_torch_statement_sha256_merkle():
    return statement("test_torch_statement_sha256_merkle")


@recorder
def test_torch_statement_sha512():
    return statement("test_torch_statement_sha512")


@recorder
def test_torch_gadget_fp25519():
    from test_gadget_fp25519 import Fp25519OpsAir
    ab = inputs.fp25519_inputs()
    inp = inputs.test_torch_gadget_fp25519(ab)
    air = Fp25519OpsAir()
    trace, publics, outs = air.make_trace(*ab)
    publics = [int(p) for p in publics]
    proof = jprover.prove(air, trace, [jgl.to_fp(p) for p in publics],
                          jprover.StarkConfig(**inputs.FP_CFG))
    return inp, {"trace": rd.array(rd.u64(trace)), "publics": publics,
                 "outs": [int(v) for v in outs],
                 "payload": proof_payload(proof)}


# -- constraint values on seeded rows ---------------------------------------------------

def jax_fp(u):
    """uint64 values -> the JAX package's (lo, hi) uint32 pair."""
    import jax.numpy as jnp
    u = np.asarray(u, dtype=np.uint64)
    return (jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((u >> np.uint64(32)).astype(np.uint32)))


def base_eval(air, cols, publics=()) -> list:
    """The transition of `air` under BaseVecAlgebra over the columns'
    width: cols = (local, next, consts, consts_next) uint64 matrices;
    each constraint's values as recorded."""
    from vectorx_tpu.stark.air import BaseVecAlgebra
    rows = [[jax_fp(m[i]) for i in range(m.shape[0])] for m in cols]
    local, nxt, consts, consts_next = rows
    out = air.transition(BaseVecAlgebra((cols[0].shape[1],)), local, nxt,
                         [jax_fp(v) for v in publics], consts, consts_next)
    return [rd.array(rd.u64(c)) for c in out]


def ext_eval(air, cols) -> list:
    """The transition under ExtAlgebra at one point: cols = (local, next,
    consts, consts_next), each a (k, 2) uint64 matrix of (re, im)."""
    from vectorx_tpu.stark.air import ExtAlgebra
    rows = [[(jax_fp(m[i, 0]), jax_fp(m[i, 1])) for i in range(m.shape[0])]
            for m in cols]
    local, nxt, consts, consts_next = rows
    out = air.transition(ExtAlgebra(), local, nxt, [], consts, consts_next)
    return [[rd.array(rd.u64(c[0])), rd.array(rd.u64(c[1]))] for c in out]


def seeded_columns(seed, num_cols, k, n):
    rng = np.random.default_rng(seed)
    return (inputs.random_columns(rng, num_cols, n),
            inputs.random_columns(rng, num_cols, n),
            inputs.random_columns(rng, k, n),
            inputs.random_columns(rng, k, n))


@recorder
def test_torch_gadget_vec():
    from vectorx_tpu.stark import air as jair
    from vectorx_tpu.stark import gadget_vec as jgv
    inp = inputs.test_torch_gadget_vec()
    air = inputs.vec_gadget_air(jgv, jair.Air)
    return inp, {"base": base_eval(air, seeded_columns(5, air.num_cols, 0, 8)),
                 "ext": ext_eval(air, seeded_columns(6, air.num_cols, 0, 2))}


def ed25519_air(lane):
    from vectorx_tpu.stark import air_ed25519 as jed
    return jed.Ed25519VerifyAir([inputs.ED_LANES[lane]], B=inputs.ED_B)


@recorder
def test_torch_ed25519_air():
    inp = inputs.test_torch_ed25519_air()
    traces = {}
    for lane in inputs.ED_LANES:
        for make in ("make_trace", "make_trace_vec"):
            air = ed25519_air(lane)
            trace, _ = getattr(air, make)()
            traces[f"{lane}-{make}"] = {
                "trace": rd.array(rd.u64(trace)),
                "publics": [int(p) for p in air.publics_list()]}
    air = ed25519_air("signed")
    k = air.constant_columns(2).shape[0]
    return inp, {"traces": traces,
                 "base": base_eval(air, seeded_columns(8, air.num_cols, k, 8))}


@recorder
def test_torch_ed25519_ext():
    inp = inputs.test_torch_ed25519_ext()
    air = ed25519_air("signed")
    k = air.constant_columns(2).shape[0]
    return inp, {"ext": ext_eval(air, seeded_columns(9, air.num_cols, k, 2))}


@recorder
def test_torch_statements_rotate():
    from vectorx_tpu.stark import air_rotate as jrot
    inp = inputs.test_torch_statements_rotate()
    air = jrot.RotateHeaderAir(inputs.ROT_MAX_CHUNKS)
    trace, publics, digest, (start, n_auth, pubkeys) = air.make_trace(
        inp["header"])
    k = air.constant_columns(2).shape[0]
    rng = np.random.default_rng(inp["seed"])
    cols = tuple(inputs.random_columns(rng, w, 8)
                 for w in (air.num_cols, air.num_cols, k, k))
    pubs = inputs.random_columns(rng, air.num_publics, 1)[:, 0]
    return inp, {
        "trace": rd.array(rd.u64(trace)),
        "publics": [int(p) for p in publics],
        "digest": digest.hex(),
        "info": [int(start), int(n_auth), [p.hex() for p in pubkeys]],
        "constant_columns": rd.array(np.asarray(
            air.constant_columns(air.n_rows), np.uint64)),
        "transition": base_eval(air, cols, pubs),
    }


@recorder
def test_torch_ed25519_batch():
    import jax.numpy as jnp
    from vectorx_tpu.circuits import ed25519 as jed
    inp = inputs.test_torch_ed25519_batch()
    _, enc = inp["encodings"]
    pt, valid = jed.decompress(jnp.asarray(enc))
    pk, sg, enabled = inp["lanes"]
    ch = jed.compute_challenges([bytes(r) for r in sg[:, :32]],
                                [bytes(p) for p in pk], inputs.EB_MSG)
    ok = jed.verify_batch(jnp.asarray(pk), jnp.asarray(sg[:, :32]),
                          jnp.asarray(sg[:, 32:]), jnp.asarray(ch),
                          jnp.asarray(enabled))
    bits = jed.bytes_to_bits_le(jnp.asarray(inp["scalars"]))
    base = jed.base_point((8,))
    a_pt = jed.Point(*pt)

    def point(p):
        return [rd.values(c) for c in p]

    return inp, {
        "pt": point(pt), "valid": rd.values(valid), "ch": rd.values(ch),
        "ok": rd.values(ok), "window": point(jed.scalar_mul(a_pt, bits)),
        "binary": point(jed.scalar_mul_binary(base, bits)),
        "add": point(jed.point_add(a_pt, base)),
        "double": point(jed.point_double(a_pt)),
        "eq": rd.values(jed.point_eq(jed.scalar_mul(a_pt, bits), a_pt)),
        "bits": rd.values(bits)}


@recorder
def test_torch_header_range():
    import jax.numpy as jnp
    from vectorx_tpu.circuits import header_range as jhr
    from vectorx_tpu.circuits import justification as jjust
    from vectorx_tpu.circuits import rotate as jrot
    from vectorx_tpu.parallel import subchain as jsub
    inp = inputs.test_torch_header_range()
    hr_cases, rot_cases = inp["cases"]

    def justification(rec):
        return jjust.prepare_justification(*rec, inputs.HR_MAX_N)

    def u8(raw):
        return jnp.asarray(np.frombuffer(raw, np.uint8))

    def result(r):
        return {k: rd.values(v) for k, v in r._asdict().items()}

    def header_range(c):
        return result(jhr.header_range(
            jnp.uint32(c["trusted"]), u8(c["trusted_hash"]),
            (jnp.uint32(c["set_id"]), jnp.uint32(0)), u8(c["set_hash"]),
            jnp.uint32(c["target"]), jnp.asarray(c["buf"]),
            jnp.asarray(c["sizes"]), justification(c["rec"])))

    def rotate(c):
        return result(jhr.rotate(
            (jnp.uint32(c["set_id"]), jnp.uint32(0)), u8(c["set_hash"]),
            jnp.uint32(c["block"]), jnp.asarray(c["hb"]),
            jnp.int32(c["size"]), jnp.int32(c["n_new"]),
            jnp.int32(c["start"]), jnp.asarray(c["pk"]),
            justification(c["rec"])))

    c = hr_cases["honest"]
    short = inputs.short_epoch_case(rot_cases["window_past_end"])
    return inp, {
        "subchain": result(jsub.verify_subchain(
            jnp.asarray(c["buf"]), jnp.asarray(c["sizes"]), jnp.int32(c["n"]),
            u8(c["trusted_hash"]), jnp.uint32(c["trusted"]))),
        "hr": {k: header_range(v) for k, v in hr_cases.items()},
        "rot": {k: rotate(v) for k, v in rot_cases.items()},
        "short": bool(jrot.verify_epoch_end_header(
            jnp.asarray(short["hb"]), jnp.int32(short["n_new"]),
            jnp.int32(short["start"]), jnp.asarray(short["pk"])))}


# -- writing ---------------------------------------------------------------------------

def command(modules) -> str:
    return ("JAX_PLATFORMS=cpu python tests/reference_data/record.py "
            + " ".join(modules)).strip()


def write(module: str, directory) -> pathlib.Path:
    inp, values = RECORDERS[module]()
    path = rd.path_of(module, directory)
    path.write_text(json.dumps({
        "module": module,
        "command": command([module]),
        "vectorx_tpu_sources_sha256": rd.vectorx_tpu_sources(),
        "inputs_sha256": rd.inputs_digest(inp),
        "values": values,
    }, indent=1, sort_keys=True) + "\n")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modules", nargs="*",
                    help="test modules to record (default: all)")
    ap.add_argument("--out", default=str(HERE), help="output directory")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.modules) - set(RECORDERS))
    if unknown:
        ap.error(f"no recorder for {unknown}; known: {sorted(RECORDERS)}")
    for module in args.modules or sorted(RECORDERS):
        print(write(module, args.out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
