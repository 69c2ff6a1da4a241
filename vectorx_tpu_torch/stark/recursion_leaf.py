"""The recursion leaf: a real Avail header proof verified inside ONE outer
proof.

A 1-chunk header is proved through ``HeaderAir(max_chunks=1)`` (128 rows
× 799 columns + 188 constant columns, 89 publics) at a recursion-friendly
inner config (rate 2^10, 9 queries, 16 grinding bits), recorded through
the streamed recorder into a ``RecursionAir`` (2^19 rows, K = 725, 764 +
336 constant columns at these configs) and proved at outer rate 2^1 with
84 queries and 16 grinding bits. The verifier rebuilds the outer AIR from
the claim shape alone (``leaf_verifier_air``) and runs the standard
verifier; the outer publics are the inner publics.

This is the JAX package's ``scripts/prove_recursion_leaf.py`` as functions
of the port's recursion layer, with no checkpoint or cache of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .. import default_device
from ..circuits import scale
from ..field import goldilocks as gl
from . import air_header as ah
from . import prover, verifier
from . import recursion_air as ra

LEAF_INNER = prover.StarkConfig(rate_bits=10, num_queries=9,
                                final_poly_len=32,
                                pow_bits=prover.PRODUCTION_POW_BITS)
LEAF_OUTER = prover.StarkConfig(rate_bits=1, num_queries=84,
                                final_poly_len=8,
                                pow_bits=prover.PRODUCTION_POW_BITS)


def leaf_header() -> bytes:
    """A 120-byte header from ``np.random.default_rng(21)``: a random
    parent hash, block number 123456 as a compact int, random bytes up to
    the last 32, a random data root."""
    rng = np.random.default_rng(21)
    parent = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    body = parent + scale.encode_compact_u32(123456)
    body += bytes(rng.integers(0, 256, 120 - len(body) - 32, dtype=np.uint8))
    return body + bytes(rng.integers(0, 256, 32, dtype=np.uint8))


@dataclass
class LeafProof:
    inner_air: ah.HeaderAir
    inner_proof: prover.StarkProof
    inner_publics: List[int]
    outer_air: ra.RecursionAir
    outer_proof: prover.StarkProof
    outer_publics: List[int]


def prove_leaf(device=None, timer=None) -> LeafProof:
    """Prove and verify the inner header proof of ``leaf_header()``,
    record its verification streamed, and prove the outer machine, all on
    ``device`` (the current CUDA device unless named). ``timer(phase)``, if
    given, is called as each phase ends: inner_prove, inner_verify,
    record, constants, witness, then the outer prover's phases."""
    device = default_device(device)
    air = ah.HeaderAir(max_chunks=1)
    log_n = air.n_rows.bit_length() - 1
    trace, publics, _ = air.make_trace(leaf_header(), device)
    pubs = [gl.to_fp(int(p), device) for p in publics]
    proof = prover.prove(air, trace, pubs, LEAF_INNER)
    ra._mark(timer, "inner_prove")
    if not verifier.verify(air, proof, pubs, log_n, LEAF_INNER):
        raise AssertionError("the inner HeaderAir proof was rejected")
    ra._mark(timer, "inner_verify")
    mb = ra.MachineBuilder()
    cells = [mb.pin_public(v) for v in ra._pub_ints(publics)]
    ra.record_stark_verify(mb, air, proof, cells, log_n, LEAF_INNER,
                           stream=True)
    oair, oproof, opubs = ra._prove_machine(mb, LEAF_OUTER, device, timer)
    return LeafProof(air, proof, [int(p) for p in publics], oair, oproof,
                     [int(p) for p in opubs])


def leaf_verifier_air(device=None) -> ra.RecursionAir:
    """The outer AIR a verifier rebuilds from the claim shape alone (the
    inner constant VK recomputed on ``device``)."""
    air = ah.HeaderAir(max_chunks=1)
    return ra.outer_air_for(air, air.n_rows.bit_length() - 1, LEAF_INNER,
                            ah.NUM_PUBLICS, stream=True, device=device)


def verify_leaf(vair: ra.RecursionAir, outer_proof, outer_publics) -> bool:
    """The standard verifier on a leaf proof against the rebuilt AIR, on
    the proof's device."""
    dev = outer_proof.trace_cap.device
    return bool(verifier.verify(
        vair, outer_proof, [gl.to_fp(int(p), dev) for p in outer_publics],
        vair.n_rows.bit_length() - 1, LEAF_OUTER))
