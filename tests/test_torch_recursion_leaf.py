"""Port vs JAX package: HeaderAir as the inner AIR of the recursion machine,
and the recursion leaf (stark/recursion_leaf.py).

The inner proof is the port's: ``HeaderAir(max_chunks=1)`` (128 rows ×
799 columns + 188 constant columns, 89 publics) over the leaf's 120-byte
header (``recursion_leaf.leaf_header``, the bytes of the JAX package's
scripts/prove_recursion_leaf.py), proved on the CPU at a small inner
config (rate 1, 2 queries, final_poly_len 4); its payload equals the JAX
package's proof of the same header, which went through the JAX
``record_stark_verify``, plain and streamed (recorded: tests/
reference_data/test_torch_recursion_leaf.json, made by tests/
reference_data/record.py). The port's records the port's proof: the row
count, K, the publics and ``schedule_digest`` must be equal (the digest
is the SHA-256 of the constant columns), and so must the streamed
machine's constant columns and trace.

The JAX ``make_trace`` fills an object array of every cell (262,144 rows
× 719 columns streamed: minutes), so the streamed trace is compared on a
seeded sample of 4,096 rows over every column, against the values the
JAX package's ``make_trace`` puts there, computed from the JAX recording
alone (its rows, values, sponge snapshots and register allocation;
record.py's ``jax_trace_rows``). The plain machine (K = 6,393: a 13.5 GB trace)
compares its schedule only. ``outer_air_for`` gives the recorded digest,
and a tampered inner cap leaves zero-pinned rows that the witness cannot
satisfy. Tolerance: exact equality throughout.

One test is marked ``slow`` (~10 min, the JAX side ~4 min): the leaf's
claim shape at the real inner config (rate 10, 9 queries, final_poly_len
32, pow 16), ``outer_air_for(HeaderAir(1), 7, inner_cfg, 89,
stream=True)`` in both packages: 519,571 rows → 2^19, K = 725, 764 + 336
columns and the same digest. ``-m slow`` runs it.
"""

import copy

import numpy as np
import pytest
import torch

from vectorx_tpu.circuits import scale as jscale
from vectorx_tpu.stark import air_header as jah
from vectorx_tpu.stark import prover as jprover
from vectorx_tpu.stark import recursion_air as jra
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import air_header as ah
from vectorx_tpu_torch.stark import prover, verifier
from vectorx_tpu_torch.stark import recursion_air as ra
from vectorx_tpu_torch.stark import recursion_leaf as rl
from vectorx_tpu_torch.stark.air import BaseVecAlgebra

import reference_data as rd
from oracle import P
from reference_data import inputs
from reference_data.inputs import sample_rows
from test_torch_recursion import _record, assert_same_payload

torch.set_num_threads(1)

SMALL = inputs.LEAF_CFG
PCFG = prover.StarkConfig(**SMALL)
LOG_N = inputs.LEAF_LOG_N


def assert_trace_sample_equal(oair, want) -> None:
    """The port's make_trace against the JAX package's on sampled rows
    (as recorded), with the publics in full."""
    trace, pubs = oair.make_trace("cpu")
    assert pubs == want["trace_publics"]
    rows = sample_rows(oair.n_rows)
    got = gl.to_u64(trace[:, torch.from_numpy(rows)])
    assert rd.array(got) == want["trace_rows"]


def _same_shape(oair, want) -> None:
    assert len(oair.mb.rows) == want["rows"]
    assert (oair.n_rows, oair.K, oair.num_cols, oair.num_consts,
            oair.has_ram) == tuple(want["shape"])
    assert oair.mb.publics == want["publics"]


@pytest.fixture(scope="module")
def jax_leaf():
    """The JAX package's inner proof and its two machines, as recorded."""
    return rd.load("test_torch_recursion_leaf",
                   inputs.test_torch_recursion_leaf())


@pytest.fixture(scope="module")
def leaf_inner():
    """The port's HeaderAir(1) proof of the leaf's header at SMALL."""
    air = ah.HeaderAir(max_chunks=1)
    assert rl.leaf_header() == inputs.LEAF_HEADER
    trace, publics, _ = air.make_trace(rl.leaf_header(), "cpu")
    pubs = [gl.to_fp(int(p), "cpu") for p in publics]
    proof = prover.prove(air, trace, pubs, PCFG)
    assert verifier.verify(air, proof, pubs, LOG_N, PCFG)
    return air, proof, [int(p) for p in publics]


def test_leaf_header_and_configs_are_the_scripts():
    """The header and configs of scripts/prove_recursion_leaf.py:55-68."""
    rng = np.random.default_rng(21)
    parent = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    body = parent + jscale.encode_compact_u32(123456)
    body += bytes(rng.integers(0, 256, 120 - len(body) - 32, dtype=np.uint8))
    assert rl.leaf_header() == body + bytes(rng.integers(0, 256, 32,
                                                         dtype=np.uint8))
    want = {"inner": (10, 9, 32, 0, jprover.PRODUCTION_POW_BITS),
            "outer": (1, 84, 8, 0, jprover.PRODUCTION_POW_BITS)}
    for name, cfg in (("inner", rl.LEAF_INNER), ("outer", rl.LEAF_OUTER)):
        assert (cfg.rate_bits, cfg.num_queries, cfg.final_poly_len,
                cfg.cap_height, cfg.pow_bits) == want[name]
    air = ah.HeaderAir(max_chunks=1)
    assert (air.n_rows, air.num_cols, air.num_publics) == (128, 799, 89)
    assert air.constant_columns(128).shape == (188, 128)
    assert ah.NUM_PUBLICS == jah.NUM_PUBLICS


def test_header_record_plain_equals_reference(leaf_inner, jax_leaf):
    """The plain record (every opening a register cell): the schedule.
    Its trace would be 6,432 × 262,144 cells; the streamed test holds
    make_trace."""
    air, proof, publics = leaf_inner
    assert_same_payload(proof, jax_leaf["inner"])
    want = jax_leaf["plain"]
    oair = _record(ra, air, proof, publics, LOG_N, PCFG, False)
    assert (oair.n_rows, oair.K, oair.has_ram) == (1 << 18, 6393, False)
    _same_shape(oair, want)
    digest = oair.schedule_digest()
    oair.__dict__.pop("_consts", None)            # 2.9 GB of columns
    assert digest == want["schedule_digest"]


def test_header_record_streamed_equals_reference(leaf_inner, jax_leaf):
    """The streamed record (the leaf's mode): schedule, constant columns
    and trace equal the JAX package's; outer_air_for rebuilds the digest
    from the claim shape; every zero-pinned row of the honest machine
    holds, and its constraints vanish on the sampled rows."""
    air, proof, publics = leaf_inner
    assert_same_payload(proof, jax_leaf["inner"])
    want = jax_leaf["streamed"]
    oair = _record(ra, air, proof, publics, LOG_N, PCFG, True)
    assert (oair.n_rows, oair.K, oair.num_cols, oair.num_consts,
            oair.has_ram) == (1 << 18, 680, 719, 327, True)
    _same_shape(oair, want)
    assert (rd.array(oair.constant_columns(oair.n_rows))
            == want["constant_columns"])
    assert oair.schedule_digest() == want["schedule_digest"]
    assert_trace_sample_equal(oair, want)
    vair = ra.outer_air_for(ah.HeaderAir(max_chunks=1), LOG_N, PCFG,
                            len(publics), stream=True, device="cpu")
    assert vair.schedule_digest() == oair.schedule_digest()
    assert not _unsatisfied_pins(oair)
    trace, pubs = oair.make_trace("cpu")
    rows = sample_rows(oair.n_rows - 1)          # transitions: not the last
    assert not any(bool(torch.any(c != 0))
                   for c in _transition_at(oair, trace, pubs, rows))


def _unsatisfied_pins(oair):
    """Recorded rows that pin their result to zero and hold a nonzero."""
    return [i for i, row in enumerate(oair.mb.rows)
            if row.zp and row.cval % P != 0]


def _transition_at(oair, trace, pubs, rows):
    """RecursionAir.transition evaluated on the rows `rows` (each with its
    next row), under the base-field ring."""
    n = oair.n_rows
    idx = torch.from_numpy(np.asarray(rows, dtype=np.int64))
    nxt = (idx + 1) % n
    consts = gl.to_fp(oair.constant_columns(n), "cpu")
    alg = BaseVecAlgebra((len(rows),), "cpu")
    return oair.transition(alg, list(trace[:, idx]), list(trace[:, nxt]),
                           [gl.to_fp(p, "cpu") for p in pubs],
                           list(consts[:, idx]), list(consts[:, nxt]))


def test_tampered_inner_cap_breaks_the_machine(leaf_inner):
    """A flipped bit of the inner trace cap shifts every challenge and
    breaks the Merkle paths: the streamed machine has zero-pinned rows
    whose recorded value is not zero, and the transition constraints do
    not vanish there."""
    air, proof, publics = leaf_inner
    bad = copy.copy(proof)
    bad.trace_cap = proof.trace_cap.clone()
    bad.trace_cap.view(-1)[0] ^= 1
    oair = _record(ra, air, bad, publics, LOG_N, PCFG, True)
    pinned = _unsatisfied_pins(oair)
    assert pinned
    trace, pubs = oair.make_trace("cpu")
    cs = _transition_at(oair, trace, pubs, pinned[:64])
    assert any(bool(torch.any(c != 0)) for c in cs)


@pytest.mark.slow
def test_leaf_claim_shape_equals_reference():
    """The leaf's outer machine from the claim shape at the real inner
    config, in both packages (the JAX side ~4 min, the port's ~5 min on a
    CPU: the inner constant VK's LDE of 188 × 2^17 points dominates)."""
    kw = dict(rate_bits=10, num_queries=9, final_poly_len=32,
              pow_bits=jprover.PRODUCTION_POW_BITS)
    vair = ra.outer_air_for(ah.HeaderAir(max_chunks=1), LOG_N,
                            prover.StarkConfig(**kw), ah.NUM_PUBLICS,
                            stream=True, device="cpu")
    assert (len(vair.mb.rows), vair.n_rows, vair.K, vair.num_cols,
            vair.num_consts) == (519571, 1 << 19, 725, 764, 336)
    digest = vair.schedule_digest()
    del vair
    jout = jra.outer_air_for(jah.HeaderAir(max_chunks=1), LOG_N,
                             jprover.StarkConfig(**kw), jah.NUM_PUBLICS,
                             stream=True)
    assert (len(jout.mb.rows), jout.n_rows, jout.K, jout.num_cols,
            jout.num_consts) == (519571, 1 << 19, 725, 764, 336)
    assert jout.schedule_digest() == digest
