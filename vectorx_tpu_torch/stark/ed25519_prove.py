"""Sharded Ed25519 STARK proving for GRANDPA justifications.

Signature lanes (A, R, s, h) are packed 2^(B-8) per 2^B-row trace shard
(disabled lanes get the self-satisfying dummy); each shard proves
independently with the Ed25519 verification AIR.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from .. import default_device
from ..circuits.ed25519 import L_ORDER
from ..field import goldilocks as gl
from . import prover, verifier
from .air_ed25519 import Ed25519VerifyAir, dummy_sig

Sig = Tuple[bytes, bytes, int, int]


def sigs_from_justification(pubkeys: Sequence[bytes],
                            signatures: Sequence[bytes],
                            signed: Sequence[bool],
                            message: bytes) -> List[Sig]:
    """Signed lanes -> (A, R, s, h) statements; unsigned lanes -> dummy.

    h = SHA-512(R ‖ A ‖ M) mod L is public (computable from public data),
    as an ed25519 verifier computes it."""
    out: List[Sig] = []
    for pk, sg, en in zip(pubkeys, signatures, signed):
        if not en:
            out.append(dummy_sig())
            continue
        r_bytes, s_bytes = bytes(sg[:32]), bytes(sg[32:])
        s = int.from_bytes(s_bytes, "little")
        assert s < L_ORDER, "non-canonical s (malleable signature)"
        h = int.from_bytes(
            hashlib.sha512(r_bytes + bytes(pk) + message).digest(),
            "little") % L_ORDER
        out.append((bytes(pk), r_bytes, s, h))
    return out


def shard_sigs(sigs: Sequence[Sig], B: int) -> List[List[Sig]]:
    per = 1 << (B - 8)
    return [list(sigs[i:i + per]) for i in range(0, len(sigs), per)]


def device_list(device) -> List:
    """The devices proofs go to round-robin: ``device`` (the current CUDA
    device when None), or each of a list of them (an empty list: the
    default)."""
    if isinstance(device, (list, tuple)):
        return [default_device(d) for d in device] or [default_device()]
    return [default_device(device)]


def prove_sigs(sigs: Sequence[Sig], B: int, config: prover.StarkConfig,
               device=None) -> List[Tuple[Ed25519VerifyAir,
                                          prover.StarkProof, List[int]]]:
    """-> per-shard (air, proof, publics), proved one after another on
    ``device`` (the current CUDA device when None), or round-robin over a
    list of devices: shard i on ``device[i % len(device)]``."""
    devices = device_list(device)
    out = []
    for i, shard in enumerate(shard_sigs(sigs, B)):
        air = Ed25519VerifyAir(shard, B=B)
        dev = devices[i % len(devices)]
        trace, publics = air.make_trace_vec(dev)
        pubs = [gl.to_fp(p, dev) for p in publics]
        out.append((air, prover.prove(air, trace, pubs, config), publics))
    return out


def verify_sigs(shards: Sequence[Tuple[Ed25519VerifyAir, prover.StarkProof,
                                       List[int]]],
                config: prover.StarkConfig) -> bool:
    ok = True
    for air, proof, publics in shards:
        pubs = [gl.to_fp(p, proof.trace_cap.device) for p in publics]
        ok = ok and bool(verifier.verify(air, proof, pubs, air.B, config))
    return ok
