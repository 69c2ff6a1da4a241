"""GRANDPA justification verification — batched, on the device.

The four checks of VectorX's ``verify_simple_justification``:

  1. the chained authority-set commitment equals the trusted hash
     (chained SHA-256 with active masking);
  2. the 53-byte precommit decodes to the expected block number,
     authority-set id and block hash;
  3. every signature flagged ``validator_signed`` verifies over the shared
     precommit message (ONE batched Ed25519 pass);
  4. more than 2/3 of the active authorities signed
     (num_signed * 3 > num_active * 2, equal voting power).

The EdDSA challenges (SHA-512(R || A || M) mod L) are witness input,
computed on the device by ``prepare_justification``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import default_device
from . import ed25519 as ed
from . import scale
from .commitments import _words_to_bytes32, authority_set_hash_vec

M32 = 0xFFFFFFFF


class JustificationData(NamedTuple):
    """Witness data, canonically ordered (the indexer's record)."""
    pubkeys: torch.Tensor            # (N, 32) uint8
    signatures: torch.Tensor         # (N, 64) uint8 (dummy on unsigned lanes)
    validator_signed: torch.Tensor   # (N,) bool
    num_authorities: torch.Tensor    # () int64
    encoded_precommit: torch.Tensor  # (53,) uint8
    challenges: torch.Tensor         # (N, 32) uint8 — SHA512(R||A||M) mod L, LE


def u32(value, device) -> torch.Tensor:
    """A 0-d int64 tensor holding ``value`` mod 2^32 (an int or a tensor)."""
    return torch.as_tensor(value, dtype=torch.int64, device=device) & M32


def verify_simple_justification(block_number, block_hash: torch.Tensor,
                                authority_set_id, authority_set_hash: torch.Tensor,
                                j: JustificationData) -> torch.Tensor:
    """block_number: a u32; block_hash, authority_set_hash: (32,) uint8;
    authority_set_id: its (lo, hi) u32 halves. Returns () bool — all four
    checks hold."""
    dev = j.pubkeys.device
    # 1. authority-set commitment
    commit = _words_to_bytes32(authority_set_hash_vec(j.pubkeys,
                                                      j.num_authorities))
    ok = torch.all(commit == authority_set_hash)

    # 2. precommit decode + match
    dec = scale.decode_precommit_vec(j.encoded_precommit[None])
    ok = ok & dec.valid[0]
    ok = ok & (dec.block_number[0] == u32(block_number, dev))
    ok = ok & (dec.authority_set_id[0][0] == u32(authority_set_id[0], dev))
    ok = ok & (dec.authority_set_id[1][0] == u32(authority_set_id[1], dev))
    ok = ok & torch.all(dec.block_hash[0] == block_hash)

    # 3. conditional batch EdDSA over the shared message
    sig_ok = ed.verify_batch(j.pubkeys, j.signatures[:, :32],
                             j.signatures[:, 32:], j.challenges,
                             j.validator_signed)
    ok = ok & torch.all(sig_ok)

    # 4. threshold: num_signed * 3 > num_active * 2 (u32 arithmetic)
    num_signed = j.validator_signed.to(torch.int64).sum()
    return ok & ((num_signed * 3) & M32 > (u32(j.num_authorities, dev) * 2) & M32)


# ---------------------------------------------------------------------------
# Host-side witness preparation
# ---------------------------------------------------------------------------

def prepare_justification(pubkeys_hex, signatures_hex, validator_signed,
                          num_authorities: int, encoded_precommit: bytes,
                          max_authorities: int, device=None) -> JustificationData:
    """Pad an indexer record to the static MAX width and compute the
    challenges, on the current CUDA device unless ``device`` names
    another."""
    dev = default_device(device)
    n = max_authorities
    pk = np.zeros((n, 32), np.uint8)
    sg = np.zeros((n, 64), np.uint8)
    vs = np.zeros((n,), bool)
    for i, (p, s) in enumerate(zip(pubkeys_hex, signatures_hex)):
        pk[i] = np.frombuffer(bytes.fromhex(p), np.uint8)
        sg[i] = np.frombuffer(bytes.fromhex(s), np.uint8)
        vs[i] = bool(validator_signed[i])

    ch = ed.compute_challenges([sg[i, :32].tobytes() for i in range(n)],
                               [pk[i].tobytes() for i in range(n)],
                               encoded_precommit, dev)
    return JustificationData(
        pubkeys=torch.from_numpy(pk).to(dev),
        signatures=torch.from_numpy(sg).to(dev),
        validator_signed=torch.from_numpy(vs).to(dev),
        num_authorities=torch.tensor(num_authorities, device=dev),
        encoded_precommit=torch.tensor(list(encoded_precommit),
                                       dtype=torch.uint8, device=dev),
        challenges=torch.from_numpy(ch).to(dev))
