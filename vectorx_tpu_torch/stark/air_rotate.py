"""Epoch-end (rotate) header AIR — HeaderAir + the ScheduledChange window.

The whole consensus-log region [start_position, end) of the epoch-end
header — prefix ‖ validator records ‖ delay — is bound to the hashed
header bytes by one dynamic-length γ-RLC window on top of the HeaderAir
byte-rows; the *encoding checks on the (public) window content* are the
verifier's, on the host (``rotate_window_fields``).

Extra publics (appended to HeaderAir's 89):
  [89]       window start (byte offset of the digest item)
  [90]       window length
  [91..99)   SHA-256 words (BE) of the claimed window bytes
  [99, 100]  RHS Horner values Σ_j byte_j γ_i^(len-1-j) for γ1, γ2

γ1/γ2 are derived from HeaderAir's claim publics PLUS start/length/window
digest, so the window-content claim is Fiat-Shamir-bound before the RLC
challenge exists."""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np
import torch

from .. import default_device
from ..circuits import scale
from ..circuits.consts import DELAY_LENGTH, VALIDATOR_LENGTH
from ..circuits.rotate import find_scheduled_change
from ..field import goldilocks as gl
from . import air_header as ah
from .air_header import HC_CIDX, MB, HeaderAir, derive_gammas

P = gl.MODULUS

S1R = ah.H_NUM_COLS
S2R = S1R + 1
RRA1 = S2R + 1
RRA2 = RRA1 + 1
R_NUM_COLS = RRA2 + 1

P_WSTART = ah.NUM_PUBLICS
P_WLEN = P_WSTART + 1
P_WDIG = P_WLEN + 1
P_RHS1 = P_WDIG + 8
P_RHS2 = P_RHS1 + 1
R_NUM_PUBLICS = P_RHS2 + 1


def window_end(header: bytes, start_position: int) -> int:
    """Parse the ScheduledChange log at start_position -> end offset."""
    c = start_position + 6                     # skip [pad, 0x04, F,R,N,K]
    _, _, clen = scale.decode_compact_u32(header[c:c + 5])
    c += clen
    assert header[c] == 0x01, "not a ScheduledChange message"
    c += 1
    n_auth, _, clen2 = scale.decode_compact_u32(header[c:c + 5])
    c += clen2
    return c + n_auth * VALIDATOR_LENGTH + DELAY_LENGTH


def rotate_gammas(publics: List[int], device=None) -> Tuple[int, int]:
    return derive_gammas(list(publics[:ah.P_G1])
                         + list(publics[P_WSTART:P_RHS1]), device)


def _horner(data: bytes, gamma: int) -> int:
    acc = 0
    for b in data:
        acc = (acc * gamma + b) % P
    return acc


def _rlc_column(buf: bytes, start: int, length: int, gamma: int,
                n: int) -> np.ndarray:
    """0 before the window, the running Horner value inside, frozen after."""
    acc = 0
    vals = np.zeros(n, dtype=np.uint64)
    for j in range(length):
        acc = (acc * gamma + buf[start + j]) % P
        vals[start + j] = acc
    vals[start + length:] = acc
    return vals


class RotateHeaderAir(HeaderAir):
    """Epoch-end header: hash + field extraction + ScheduledChange window."""

    num_publics = R_NUM_PUBLICS
    num_cols = R_NUM_COLS

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        cs = super().transition(alg, local, next_row, publics,
                                consts, consts_next)
        one = alg.one()
        wstart = publics[P_WSTART]
        wend = gl.add(wstart, publics[P_WLEN])
        for col, pos in ((S1R, wstart), (S2R, wend)):
            d = alg.sub(next_row[col], local[col])
            cs.append(alg.sub(alg.mul(d, d), d))
            cs.append(alg.mul(d, alg.sub(consts_next[HC_CIDX],
                                         alg.lift(pos))))
        ins = alg.sub(next_row[S1R], next_row[S2R])
        for acc, gp in ((RRA1, ah.P_G1), (RRA2, ah.P_G2)):
            gamma = alg.lift(publics[gp])
            upd = alg.add(alg.mul(alg.mul(local[acc], gamma), ins),
                          alg.mul(ins, next_row[MB]))
            cs.append(alg.sub(
                next_row[acc],
                alg.add(upd, alg.mul(alg.sub(one, ins), local[acc]))))
        return cs

    def first_row(self, alg, local, publics, consts=()):
        cs = super().first_row(alg, local, publics, consts)
        for col in (S1R, S2R, RRA1, RRA2):
            cs.append(local[col])
        return cs

    def last_row(self, alg, local, publics, consts=()):
        cs = super().last_row(alg, local, publics, consts)
        one = alg.one()
        for col in (S1R, S2R):
            cs.append(alg.sub(local[col], one))
        cs.append(alg.sub(local[RRA1], alg.lift(publics[P_RHS1])))
        cs.append(alg.sub(local[RRA2], alg.lift(publics[P_RHS2])))
        return cs

    def make_trace(self, msg: bytes, device=None):
        """-> (trace on ``device``, publics[101], digest, rotate_info) where
        rotate_info = (start_position, num_authorities, new_pubkeys)."""
        found = find_scheduled_change(msg)
        assert found is not None, "no ScheduledChange log in header"
        start, n_auth, pubkeys = found
        end = window_end(msg, start)
        wlen = end - start
        assert end <= len(msg)

        device = default_device(device)
        trace_h, publics, digest = super().make_trace(msg, device)
        window = msg[start:end]
        wdig = hashlib.sha256(window).digest()
        publics = list(publics)
        publics += [start, wlen]
        publics += [int.from_bytes(wdig[4 * i:4 * i + 4], "big")
                    for i in range(8)]
        g1, g2 = rotate_gammas(publics, device)
        publics[ah.P_G1], publics[ah.P_G2] = g1, g2
        publics += [_horner(window, g1), _horner(window, g2)]

        n = self.n_rows
        buf = msg + b"\x00" * (128 * self.num_blocks - len(msg))
        cidx = np.arange(n, dtype=np.int64)
        extra = np.zeros((R_NUM_COLS - ah.H_NUM_COLS, n), dtype=np.uint64)
        extra[S1R - ah.H_NUM_COLS] = (cidx >= start).astype(np.uint64)
        extra[S2R - ah.H_NUM_COLS] = (cidx >= end).astype(np.uint64)
        extra[RRA1 - ah.H_NUM_COLS] = _rlc_column(buf, start, wlen, g1, n)
        extra[RRA2 - ah.H_NUM_COLS] = _rlc_column(buf, start, wlen, g2, n)

        # the HeaderAir trace was built with the pre-γ-override publics;
        # only the γ-dependent SR/DR accumulator columns are refilled
        refill = np.zeros((4, n), dtype=np.uint64)
        clen = ah.compact_len(msg[32])
        rows = (ah.SRA1, ah.SRA2, ah.DRA1, ah.DRA2)
        for k, (s0, g) in enumerate(((32 + clen, g1), (32 + clen, g2),
                                     (len(msg) - 32, g1),
                                     (len(msg) - 32, g2))):
            refill[k] = _rlc_column(buf, s0, 32, g, n)
        trace = trace_h.clone()
        trace[list(rows)] = torch.from_numpy(refill.view(np.int64)).to(device)
        trace = torch.cat([trace, torch.from_numpy(
            extra.view(np.int64)).to(device)])
        return trace, publics, digest, (start, n_auth, pubkeys)


def rotate_window_fields(publics: List[int], window: bytes,
                         device=None) -> dict:
    """Verifier-side validation of the ScheduledChange window claim.
    `window` is the claimed byte content (bundle data); the γ transcript
    runs on ``device``. Returns num_authorities + the new pubkeys with the
    header fields. Raises AssertionError on any malformed claim."""
    fields = ah.header_publics_fields(publics, check_gamma=False)
    start = int(publics[P_WSTART])
    wlen = int(publics[P_WLEN])
    assert len(window) == wlen, "window length mismatch"
    assert start >= 1 and start + wlen <= fields["length"], \
        "window outside header bytes"
    wdig = hashlib.sha256(window).digest()
    assert [int.from_bytes(wdig[4 * i:4 * i + 4], "big")
            for i in range(8)] == [int(p) for p in
                                   publics[P_WDIG:P_WDIG + 8]], \
        "window digest mismatch"
    g1, g2 = rotate_gammas(publics, device)
    assert int(publics[ah.P_G1]) == g1 and int(publics[ah.P_G2]) == g2, \
        "γ challenges not derived from the claim"
    assert int(publics[P_RHS1]) == _horner(window, g1), "RHS1 mismatch"
    assert int(publics[P_RHS2]) == _horner(window, g2), "RHS2 mismatch"

    # ScheduledChange encoding checks
    assert window[1] == 0x04 and window[2:6] == b"FRNK", "consensus log"
    c = 6
    _, _, clen = scale.decode_compact_u32(window[c:c + 5])
    c += clen
    assert window[c] == 0x01, "ScheduledChange flag"
    c += 1
    n_auth, _, clen2 = scale.decode_compact_u32(window[c:c + 5])
    c += clen2
    assert n_auth > 0
    assert wlen == c + n_auth * VALIDATOR_LENGTH + DELAY_LENGTH, \
        "window must cover exactly the validator records + delay"
    pubkeys = []
    for i in range(n_auth):
        rec = window[c + i * VALIDATOR_LENGTH:
                     c + (i + 1) * VALIDATOR_LENGTH]
        assert rec[32:] == b"\x01\x00\x00\x00\x00\x00\x00\x00", \
            f"validator {i} weight"
        pubkeys.append(rec[:32])
    assert window[-DELAY_LENGTH:] == b"\x00" * DELAY_LENGTH, "delay"
    return dict(num_authorities=n_auth, new_pubkeys=pubkeys, **fields)
