"""Justification indexer — verifies GRANDPA justifications, stores them.

The loop of VectorX's indexer: take each justification the node
announces, rebuild the 53-byte signed precommit message, verify every
precommit signature, require more than 2/3 of the authority set, align the
signatures to the canonical authority order with dummy-filled unsigned
lanes, and persist the record.

The whole precommit set is verified as ONE batch on the device
(``circuits/ed25519.verify_batch``, challenges from the batched SHA-512 of
``compute_challenges``), on the current CUDA device unless ``device``
names another. ``use_device=False`` verifies one signature at a time on
the host (``circuits/ed25519.verify_host``): a choice of the caller,
never a fallback taken when the device fails.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence

import numpy as np
import torch

from .. import default_device
from ..circuits import ed25519 as ed
from ..circuits import scale
from .store import InMemoryStore, StoredJustification

log = logging.getLogger("vectorx.indexer")

DUMMY_SIGNATURE = bytes(64)  # unsigned-lane filler (never verified)


@dataclass
class Justification:
    """Decoded GRANDPA justification (commit + per-precommit sigs)."""
    round: int
    block_hash: bytes       # commit target
    block_number: int
    authority_set_id: int
    precommit_pubkeys: List[bytes]
    precommit_signatures: List[bytes]


class JustificationSource(Protocol):
    async def next_justification(self) -> Justification: ...
    async def get_authorities(self, block: int) -> List[bytes]: ...


def build_signed_message(block_hash: bytes, block_number: int, round_: int,
                         authority_set_id: int) -> bytes:
    """SCALE encode of (PrecommitMessage(precommit), round, set_id) —
    the 53-byte message every authority signs."""
    return scale.encode_precommit_bytes(block_hash, block_number, round_,
                                        authority_set_id)


def _verify_on_device(j: Justification, msg: bytes, device) -> np.ndarray:
    dev = default_device(device)

    def lanes(rows):
        return torch.from_numpy(np.stack(
            [np.frombuffer(bytes(r), np.uint8) for r in rows])).to(dev)

    sigs = j.precommit_signatures
    h = ed.compute_challenges([s[:32] for s in sigs], j.precommit_pubkeys,
                              msg, dev)
    ok = ed.verify_batch(lanes(j.precommit_pubkeys), lanes(s[:32] for s in sigs),
                         lanes(s[32:] for s in sigs),
                         torch.from_numpy(h).to(dev),
                         torch.ones(len(sigs), dtype=torch.bool, device=dev))
    return ok.cpu().numpy()


def verify_justification(
    j: Justification,
    authorities: Sequence[bytes],
    use_device: bool = True,
    device=None,
) -> Optional[StoredJustification]:
    """Verify and canonicalize a justification; None below the threshold
    (the equal-weight 2/3 rule ``signed_count > (n * 2) // 3``)."""
    msg = build_signed_message(j.block_hash, j.block_number, j.round,
                               j.authority_set_id)

    n = len(j.precommit_pubkeys)
    if n == 0:
        return None

    if use_device:
        ok = _verify_on_device(j, msg, device)
    else:
        ok = [ed.verify_host(p, sig, msg) for p, sig in
              zip(j.precommit_pubkeys, j.precommit_signatures)]

    pubkey_to_sig = {
        p: sig for p, sig, valid in
        zip(j.precommit_pubkeys, j.precommit_signatures, ok) if valid
    }

    num_authorities = len(authorities)
    signed_count = len(pubkey_to_sig)
    if signed_count <= (num_authorities * 2) // 3:
        return None

    pubkeys, signatures, validator_signed = [], [], []
    for auth in authorities:  # canonical order
        sig = pubkey_to_sig.get(auth)
        pubkeys.append(auth.hex())
        signatures.append((sig if sig is not None else DUMMY_SIGNATURE).hex())
        validator_signed.append(sig is not None)

    return StoredJustification(
        block_number=j.block_number,
        signed_message=msg.hex(),
        pubkeys=pubkeys,
        signatures=signatures,
        num_authorities=num_authorities,
        validator_signed=validator_signed,
    )


async def run(source: JustificationSource, store: InMemoryStore,
              device=None) -> None:
    """The indexer's main loop: verify each announced justification on
    ``device`` (the current CUDA device unless named) and store it."""
    while True:
        j = await source.next_justification()
        authorities = await source.get_authorities(j.block_number - 1)
        stored = verify_justification(j, authorities, device=device)
        if stored is None:
            log.info("justification for block %d below threshold", j.block_number)
            continue
        store.add_justification(stored)
        log.info("stored justification for block %d (%d/%d signed)",
                 j.block_number, sum(stored.validator_signed), stored.num_authorities)
