"""Jobs: the authority-set commitment of each set a rotation goes through.

A seeded set of keys is the first current set; each rotation replaces a
seeded number of its keys at seeded slots, and the new set is the next
job. A job proves ``ChainedSha256Air(n_max)`` over the set (the chained
SHA-256 of the rotate statement, for the current and the new set alike)
and verifies it. The AIR's constant columns depend on n_max alone, so
one air serves every job of the run, as it serves a prover machine.
"""

from __future__ import annotations

import numpy as np

from vectorx_tpu_torch.stark.air_sha256_chain import ChainedSha256Air
from vxbench.reference import sha256_chain as ref

PROOF = "authority_chain"        # the config's key of this proof's widths


def _keys(rng, n: int):
    return [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]


def make_pool(seed: int, traffic: dict, config: dict):
    """-> (warm job, window jobs): a set of its own for the warm-up, then
    the sets of ``rotations`` rotations from the first."""
    n = config["max_authority_set_size"]
    active = traffic["active_keys"]
    rng = np.random.default_rng(seed)
    warm = {"keys": _keys(rng, n), "active": active}
    keys = _keys(rng, n)
    jobs = [{"keys": list(keys), "active": active}]
    for _ in range(traffic["rotations"]):
        slots = rng.choice(active, traffic["replaced_per_rotation"],
                           replace=False)
        for s, k in zip(slots, _keys(rng, len(slots))):
            keys[int(s)] = k
        jobs.append({"keys": list(keys), "active": active})
    return warm, jobs


def setup(config: dict, device) -> dict:
    return {"n_max": config["max_authority_set_size"], "device": device}


def witness(job: dict, ctx: dict):
    air = ChainedSha256Air(ctx["n_max"])
    words = ChainedSha256Air.pubkeys_to_words(job["keys"], air.n_max)
    trace, publics, _ = air.make_trace(words, job["active"], ctx["device"])
    return air, trace, [int(p) for p in publics]


def verifier_air(job: dict, ctx: dict):
    return ChainedSha256Air(ctx["n_max"])


def expected(job: dict, config: dict):
    return ref.chain_publics(job["keys"], job["active"])


def constants(job: dict, config: dict):
    return ref.constant_columns(config["max_authority_set_size"])


def false_statement(job: dict, ctx: dict):
    """-> (air, trace, publics, verifier's air): the job's own witness
    with the first word of its digest flipped in the statement, so the
    reference calls it false, and only the constraints at ζ can tell."""
    air, trace, publics = witness(job, ctx)
    publics = publics[:1] + [publics[1] ^ 1] + publics[2:]
    return air, trace, publics, verifier_air(job, ctx)
