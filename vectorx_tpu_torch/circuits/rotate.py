"""Rotate (authority-set handoff) — the epoch-end header checks.

The encoding is the GRANDPA ScheduledChange consensus log of a SCALE
header: the digest item whose consensus flag is 0x04 and engine id "FRNK",
whose message is the ScheduledChange enum (flag 0x01), then the
compact-encoded new-authority count, the validator records (pubkey ‖
weight 1 as u64 LE) and a zero u32 delay.

- ``verify_epoch_end_header`` checks it on the device, at a witnessed
  offset, with dynamic-offset windows;
- ``new_authority_set_hash`` is the new set's chained SHA-256;
- ``find_scheduled_change`` is the host parser that finds the offset.

A window reads as ``jnp.take_along_axis`` reads: a byte past the end of
the buffer reads 255 (``scale.take_along_fill``). The record window is
``max_n * 40 + 4`` bytes whatever the set's size, so for a set well below
``max_n`` it runs past the end of a header padded to whole chunks; a delay
field that lies past the buffer then reads 255 and is rejected, as the JAX
package rejects it.
"""

from __future__ import annotations

import torch

from . import scale
from .commitments import _words_to_bytes32, authority_set_hash_vec
from .consts import (CONSENSUS_ENGINE_ID_PREFIX_LENGTH, DELAY_LENGTH,
                     MAX_COMPACT_UINT_BYTES, MAX_PREFIX_LENGTH, PUBKEY_LENGTH,
                     VALIDATOR_LENGTH)

_FRNK = (70, 82, 78, 75)
_WEIGHT_ONE = (1, 0, 0, 0, 0, 0, 0, 0)


def _window(arr: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Dynamic-offset window gather: arr (..., S), start (...,) -> (..., size)."""
    idx = start[..., None] + torch.arange(size, device=arr.device)
    return scale.take_along_fill(arr, idx)


def verify_epoch_end_header(header_bytes: torch.Tensor, num_authorities,
                            start_position,
                            new_pubkeys: torch.Tensor) -> torch.Tensor:
    """header_bytes: (S,) uint8; num_authorities, start_position: ints or
    0-d tensors (start_position: the digest item's first byte);
    new_pubkeys: (MAX_N, 32) uint8. Returns () bool."""
    dev = header_bytes.device
    max_n = new_pubkeys.shape[0]
    num = torch.as_tensor(num_authorities, dtype=torch.int64, device=dev)
    start = torch.as_tensor(start_position, dtype=torch.int64, device=dev)
    ok = num > 0

    prefix = _window(header_bytes[None], start[None], MAX_PREFIX_LENGTH)[0]

    # consensus log: flag 0x04 + engine id "FRNK"
    ok = ok & (prefix[1] == 4)
    ok = ok & torch.all(prefix[2:6] == torch.tensor(_FRNK, dtype=torch.uint8,
                                                    device=dev))

    # scheduled-change message length (value unchecked) + flag 0x01
    msg_len = scale.decode_compact_u32_vec(
        prefix[None, CONSENSUS_ENGINE_ID_PREFIX_LENGTH:
               CONSENSUS_ENGINE_ID_PREFIX_LENGTH + MAX_COMPACT_UINT_BYTES])
    cursor = CONSENSUS_ENGINE_ID_PREFIX_LENGTH + msg_len.length[0]
    ok = ok & (scale.take_clamp(prefix, cursor) == 1)
    cursor = cursor + 1

    # encoded new-authority-set size must equal the witnessed count
    enc_n = _window(prefix[None], cursor[None], MAX_COMPACT_UINT_BYTES)
    dec_n = scale.decode_compact_u32_vec(enc_n)
    ok = ok & (dec_n.value[0] == num & 0xFFFFFFFF)
    total_prefix_length = cursor + dec_n.length[0]

    # validator records: (pubkey || weight=1u64 LE) x n, then delay=0u32
    sub = _window(header_bytes[None], (start + total_prefix_length)[None],
                  max_n * VALIDATOR_LENGTH + DELAY_LENGTH)[0]
    recs = sub[:max_n * VALIDATOR_LENGTH].reshape(max_n, VALIDATOR_LENGTH)
    active = torch.arange(max_n, device=dev) < num
    pk_match = torch.all(recs[:, :PUBKEY_LENGTH] == new_pubkeys, dim=-1)
    wt_match = torch.all(recs[:, PUBKEY_LENGTH:] == torch.tensor(
        _WEIGHT_ONE, dtype=torch.uint8, device=dev), dim=-1)
    ok = ok & torch.all(pk_match & wt_match | ~active)

    # delay bytes directly after the last validator record
    delay = _window(sub[None], (num * VALIDATOR_LENGTH)[None], DELAY_LENGTH)[0]
    return ok & torch.all(delay == 0)


def new_authority_set_hash(new_pubkeys: torch.Tensor,
                           num_authorities) -> torch.Tensor:
    """(32,) uint8 — the chained SHA-256 over the new set."""
    return _words_to_bytes32(authority_set_hash_vec(new_pubkeys,
                                                    num_authorities))


def find_scheduled_change(header_bytes: bytes):
    """-> (start_position, num_authorities, pubkeys) or None.

    start_position points at the digest item's *first byte* (the byte
    before the 0x04 consensus flag)."""
    data = header_bytes
    # scan for the pattern 0x04 'F' 'R' 'N' 'K' then a ScheduledChange
    for pos in range(1, len(data) - 6):
        if data[pos] == 0x04 and data[pos + 1:pos + 5] == b"FRNK":
            cursor = pos + 5
            try:
                _, _, clen = scale.decode_compact_u32(data[cursor:cursor + 5])
            except IndexError:
                continue
            cursor += clen
            if cursor >= len(data) or data[cursor] != 0x01:
                continue  # not a ScheduledChange message
            cursor += 1
            try:
                n_auth, _, clen2 = scale.decode_compact_u32(
                    data[cursor:cursor + 5])
            except IndexError:
                continue
            cursor += clen2
            end = cursor + n_auth * VALIDATOR_LENGTH + DELAY_LENGTH
            if end > len(data):
                continue
            pubkeys = [data[cursor + i * VALIDATOR_LENGTH:
                            cursor + i * VALIDATOR_LENGTH + PUBKEY_LENGTH]
                       for i in range(n_auth)]
            # the weights must be 1 and the delay 0
            weights_ok = all(
                data[cursor + i * VALIDATOR_LENGTH + PUBKEY_LENGTH:
                     cursor + (i + 1) * VALIDATOR_LENGTH]
                == b"\x01\x00\x00\x00\x00\x00\x00\x00"
                for i in range(n_auth))
            delay_ok = data[end - DELAY_LENGTH:end] == b"\x00" * DELAY_LENGTH
            if weights_ok and delay_ok:
                return pos - 1, n_auth, pubkeys
    return None
