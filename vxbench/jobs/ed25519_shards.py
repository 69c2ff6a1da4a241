"""Jobs: the Ed25519 signature shards of one GRANDPA justification.

A seeded precommit (53 bytes) is signed by a seeded subset of the
authority slots; the other slots are unsigned. The lanes are laid out as
the bundle prover lays them out (``sigs_from_justification``: a signed
slot's (A, R, s, h), the disabled lane for an unsigned one) and cut into
shards of 2^(B-8) lanes (``shard_sigs``); a job proves one shard with
``Ed25519VerifyAir(shard, B)`` and verifies it with an air built anew,
as the bundle prover and verifier do. The window takes the shards in order.
"""

from __future__ import annotations

import numpy as np

from vectorx_tpu_torch.stark.air_ed25519 import Ed25519VerifyAir
from vectorx_tpu_torch.stark.ed25519_prove import (shard_sigs,
                                                   sigs_from_justification)
from vxbench.reference import ed25519 as ref

PROOF = "ed25519_shard"          # the config's key of this proof's widths


def precommit(rng) -> bytes:
    """A GRANDPA precommit: 1 | block hash | block number (u32 LE) |
    round (u64 LE) | authority set id (u64 LE)."""
    return (bytes([1]) + bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            + int(rng.integers(1, 1 << 32)).to_bytes(4, "little")
            + int(rng.integers(1, 1 << 16)).to_bytes(8, "little")
            + int(rng.integers(1, 1 << 16)).to_bytes(8, "little"))


def justification(rng, slots: int, signers: int):
    """-> (message, public keys, signatures or None per slot)."""
    message = precommit(rng)
    seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
             for _ in range(slots)]
    signed = set(int(i) for i in rng.choice(slots, signers, replace=False))
    pubs, sigs = [], []
    for i, seed in enumerate(seeds):
        if i in signed:
            pub, sig = ref.sign(seed, message)
        else:
            pub, sig = ref.public_key(seed), None
        pubs.append(pub)
        sigs.append(sig)
    return message, pubs, sigs


def make_pool(seed: int, traffic: dict, config: dict):
    """-> (warm job, window jobs): the shards of one justification, and a
    shard of a second one for the warm-up."""
    bits = config["ed25519_shard_bits"]
    per = 1 << (bits - 8)
    rng = np.random.default_rng(seed)
    pools = []
    for slots, signers in ((per, per), (traffic["slots"], traffic["signers"])):
        message, pubs, sigs = justification(rng, slots, signers)
        lanes = sigs_from_justification(
            pubs, [s if s is not None else bytes(64) for s in sigs],
            [s is not None for s in sigs], message)
        pools.append([
            {"shard": k, "lanes": shard, "message": message,
             "pubs": pubs[k * per:(k + 1) * per],
             "sigs": sigs[k * per:(k + 1) * per]}
            for k, shard in enumerate(shard_sigs(lanes, bits))])
    return pools[0][0], pools[1]


def setup(config: dict, device) -> dict:
    return {"bits": config["ed25519_shard_bits"], "device": device}


def witness(job: dict, ctx: dict):
    """-> (air, trace on the device, public values)."""
    air = Ed25519VerifyAir(job["lanes"], B=ctx["bits"])
    trace, publics = air.make_trace_vec(ctx["device"])
    return air, trace, [int(p) for p in publics]


def verifier_air(job: dict, ctx: dict):
    return Ed25519VerifyAir(job["lanes"], B=ctx["bits"])


def expected(job: dict, config: dict):
    """The reference's public values of the job, worked out from the
    inputs."""
    lanes = ref.lanes(job["pubs"], job["sigs"], job["message"])
    return ref.shard_publics(lanes, 1 << (config["ed25519_shard_bits"] - 8))


def constants(job: dict, config: dict):
    """The reference's constant columns of the job: its lanes' y
    coordinates, sign bits and the bits of s and h."""
    lanes = ref.lanes(job["pubs"], job["sigs"], job["message"])
    return ref.constant_columns(lanes, config["ed25519_shard_bits"])


def false_statement(job: dict, ctx: dict):
    """-> (air, trace, publics, verifier's air): the job's own witness
    under a statement whose first lane claims the challenge h + 1, which
    the reference refutes ([s]B = R + [h + 1]A would need A = O); only
    the constraints at ζ can tell."""
    _, trace, _ = witness(job, ctx)
    lanes = list(job["lanes"])
    a, r, s, h = lanes[0]
    lanes[0] = (a, r, s, (h + 1) % ref.L)
    if ref.lane_holds(lanes[0]):
        raise RuntimeError("the reference holds the altered lane")
    air = Ed25519VerifyAir(lanes, B=ctx["bits"])
    return (air, trace, [int(p) for p in air.publics_list()],
            Ed25519VerifyAir(lanes, B=ctx["bits"]))
