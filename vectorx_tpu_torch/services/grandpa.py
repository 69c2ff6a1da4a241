"""GRANDPA finality-proof decoding and justification alignment.

Host-side SCALE decoding of the ``grandpa_proveFinality`` RPC result and
the ``GrandpaJustification`` it wraps, as VectorX justifies an epoch-end
block: the result is aligned to the canonical authority order with
dummy-filled unsigned lanes and handed to the device pipeline as a
``StoredJustification``. The signatures of an aligned record are checked
by the batched Ed25519 verification on the device.
``JustificationProvider`` resolves a block's justification as VectorX
does: an epoch-end block through a finality proof fetched from the node,
every other block from the indexer's store.

SCALE layouts (finality_grandpa / sp-consensus-grandpa):

  FinalityProof        = block_hash [u8;32]
                       | justification Vec<u8>           (compact len)
                       | unknown_headers Vec<Header>     (ignored)
  GrandpaJustification = round u64 LE
                       | commit.target_hash [u8;32]
                       | commit.target_number u32 LE
                       | commit.precommits Vec<SignedPrecommit>
                       | votes_ancestries Vec<Header>    (ignored)
  SignedPrecommit      = precommit.target_hash [u8;32]
                       | precommit.target_number u32 LE
                       | signature [u8;64]
                       | id (pubkey) [u8;32]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import default_device

from ..circuits import scale
from .store import InMemoryStore, StoredJustification

DUMMY_SIGNATURE = bytes(64)


@dataclass(frozen=True)
class SignedPrecommit:
    target_hash: bytes     # 32
    target_number: int
    signature: bytes       # 64
    pubkey: bytes          # 32


@dataclass(frozen=True)
class GrandpaJustification:
    round: int
    target_hash: bytes
    target_number: int
    precommits: List[SignedPrecommit]


def decode_grandpa_justification(data: bytes) -> GrandpaJustification:
    """SCALE decode (trailing votes_ancestries left unparsed)."""
    if len(data) < 8 + 32 + 4 + 1:
        raise ValueError("justification too short")
    round_ = int.from_bytes(data[0:8], "little")
    target_hash = data[8:40]
    target_number = int.from_bytes(data[40:44], "little")
    n, _, clen = scale.decode_compact_u32(data[44:49])
    off = 44 + clen
    precommits = []
    for _ in range(n):
        ph = data[off:off + 32]
        pn = int.from_bytes(data[off + 32:off + 36], "little")
        sig = data[off + 36:off + 100]
        pk = data[off + 100:off + 132]
        if len(pk) != 32:
            raise ValueError("truncated precommit")
        precommits.append(SignedPrecommit(ph, pn, sig, pk))
        off += 132
    return GrandpaJustification(round_, target_hash, target_number, precommits)


def decode_finality_proof(data: bytes) -> Tuple[bytes, GrandpaJustification]:
    """FinalityProof bytes -> (block_hash, decoded justification)."""
    block_hash = data[0:32]
    jlen, _, clen = scale.decode_compact_u32(data[32:37])
    off = 32 + clen
    return block_hash, decode_grandpa_justification(data[off:off + jlen])


def align_justification(
    j: GrandpaJustification,
    authorities: Sequence[bytes],
    authority_set_id: int,
    verify: bool = True,
    device=None,
) -> StoredJustification:
    """Canonical-order alignment with dummy-filled unsigned lanes, and
    (``verify``) the batched signature check on the current CUDA device
    unless ``device`` names another.

    The signed message is rebuilt from the FIRST precommit (all honest
    precommits in a commit share the target)."""
    if not j.precommits:
        raise ValueError("empty commit")
    p0 = j.precommits[0]
    message = scale.encode_precommit_bytes(p0.target_hash, p0.target_number,
                                           j.round, authority_set_id)

    by_pubkey = {p.pubkey: p.signature for p in j.precommits}
    pubkeys, signatures, signed = [], [], []
    for pk in authorities:
        sig = by_pubkey.get(bytes(pk))
        pubkeys.append(bytes(pk).hex())
        signatures.append((sig or DUMMY_SIGNATURE).hex())
        signed.append(sig is not None)

    if verify:
        from ..circuits import ed25519 as ed
        dev = default_device(device)
        pk_arr = np.frombuffer(b"".join(bytes(pk) for pk in authorities),
                               np.uint8).reshape(-1, 32)
        sg_arr = np.frombuffer(b"".join(bytes.fromhex(s) for s in signatures),
                               np.uint8).reshape(-1, 64)
        ch = ed.compute_challenges([bytes(s[:32]) for s in sg_arr],
                                   [bytes(p) for p in pk_arr], message, dev)

        def on_dev(a):
            return torch.from_numpy(np.array(a)).to(dev)

        ok = ed.verify_batch(on_dev(pk_arr), on_dev(sg_arr[:, :32]),
                             on_dev(sg_arr[:, 32:]), on_dev(ch),
                             on_dev(np.asarray(signed)))
        if not bool(torch.all(ok)):
            raise ValueError("invalid signature in finality proof")

    return StoredJustification(
        block_number=p0.target_number,
        signed_message=message.hex(),
        pubkeys=pubkeys,
        signatures=signatures,
        num_authorities=len(authorities),
        validator_signed=signed,
    )


class JustificationProvider:
    """A block's justification: at an epoch end (the set id changes at
    the block) ``grandpa_proveFinality``, decoded and aligned to the
    previous set with its signatures verified on the current CUDA device
    unless ``device`` names another; otherwise the store's record."""

    def __init__(self, client, store: InMemoryStore, device=None):
        self.client = client
        self.store = store
        self.device = device

    async def get(self, block_number: int) -> StoredJustification:
        curr = await self.client.get_authority_set_id(block_number)
        prev = await self.client.get_authority_set_id(block_number - 1)
        if curr == prev + 1:
            raw = await self.client.call("grandpa_proveFinality", [block_number])
            data = bytes.fromhex(raw.removeprefix("0x"))
            _, just = decode_finality_proof(data)
            if just.target_number != block_number:
                raise ValueError("finality proof targets a different block")
            authorities = await self.client.get_authorities(block_number - 1)
            return align_justification(just, authorities, prev,
                                       device=self.device)
        rec = self.store.get_justification(block_number)
        if rec is None:
            raise LookupError(f"no stored justification for {block_number}")
        return rec


def to_device_justification(rec: StoredJustification, max_authorities: int,
                            device=None):
    """StoredJustification -> circuits.justification.JustificationData on
    the current CUDA device unless ``device`` names another."""
    from ..circuits import justification as just
    return just.prepare_justification(
        rec.pubkeys, rec.signatures, rec.validator_signed,
        rec.num_authorities, bytes.fromhex(rec.signed_message),
        max_authorities, device)
