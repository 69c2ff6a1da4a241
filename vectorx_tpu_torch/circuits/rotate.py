"""Rotate (authority-set handoff) — the host parser of the epoch-end
header.

``find_scheduled_change`` locates the GRANDPA ScheduledChange consensus log
in a SCALE header: the digest item whose consensus flag is 0x04 and engine
id "FRNK", whose message is the ScheduledChange enum (flag 0x01), then the
compact-encoded new-authority count, the validator records (pubkey ‖
weight 1 as u64 LE) and a zero u32 delay. The batched in-circuit checks of
the same encoding (``verify_epoch_end_header``, ``new_authority_set_hash``)
wait for the circuits slice of the port; the rotate statement checks the
window on the host (stark/air_rotate.rotate_window_fields).
"""

from __future__ import annotations

from . import scale
from .consts import DELAY_LENGTH, PUBKEY_LENGTH, VALIDATOR_LENGTH


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
