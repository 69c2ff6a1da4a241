"""Avail-header AIR — Blake2b-256 hash + SCALE field extraction in-STARK.

Extends the variable-length Blake2b AIR (air_blake2b.Blake2bVarAir) with
in-trace decoding of the header: the proof binds, to the SAME bytes that
are hashed,

  - parent_hash   = bytes 0..32      (fixed offset — first-row MW pins),
  - block number  = compact-int bytes 32..37 (fixed offset — selector pins;
                    the verifier decodes these public bytes),
  - state_root    = bytes 32+clen .. 64+clen  (clen ∈ {1,2,4,5} public),
  - data_root     = last 32 bytes (dynamic offset).

A byte-rows column family carries message byte r of chunk c on row 128c+r,
tied to the hashed message words by running word-accumulator constraints;
window contents are bound through two independent γ-RLC accumulators whose
challenges are Poseidon-derived from all claim publics. Constraint text
follows the JAX package's module line for line.

Publics (89):
  [0]      byte length
  [1..9)   digest halves (4x u64 as lo,hi)
  [9..17)  parent-hash halves
  [17]     clen — compact-int encoded length of the block number
  [18..23) the 5 bytes at offsets 32..37 (block-number window; bytes
           beyond clen belong to state_root and must match it)
  [23..55) state_root bytes
  [55..87) data_root bytes
  [87,88]  γ1, γ2 (MUST equal derive_gammas(publics[:87]))

Requires 65 <= length <= 128*num_blocks - 4 (the last word-half of the
final block has no word-tie row — transition constraints exclude the last
trace row — so the top 4 bytes must be padding).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import default_device
from ..field import goldilocks as gl
from .air_blake2b import (Blake2bVarAir, MW, N_ROWS, V_NUM_COLS,
                          V_NUM_CONSTS)
from .challenger import Challenger

P = gl.MODULUS

# --- columns appended after the Blake2b var layout -------------------------
MB = V_NUM_COLS        # 1: message byte for this row
MBB = MB + 1           # 8: bits of MB
WACC = MBB + 8         # 1: running word-half accumulator (resets every 4)
S1S = WACC + 1         # state-root window step markers
S2S = S1S + 1
S1D = S2S + 1          # data-root window step markers
S2D = S1D + 1
SRA1 = S2D + 1         # γ-RLC accumulators
SRA2 = SRA1 + 1
DRA1 = SRA2 + 1
DRA2 = DRA1 + 1
H_NUM_COLS = DRA2 + 1

# --- constant columns appended after the Blake2b var consts ----------------
HC_CIDX = V_NUM_CONSTS     # global byte index 128*blk + rr
HC_BPOW = HC_CIDX + 1      # 256^(rr % 4)
HC_WSTART = HC_BPOW + 1    # 1 at rr % 4 == 0
HC_HSEL = HC_WSTART + 1    # 32: one-hot, HSEL[q]=1 at rows rr=4q+3
HC_BNSEL = HC_HSEL + 32    # 5: one-hot at global rows 32..36
H_NUM_CONSTS = HC_BNSEL + 5

# --- public indices ---------------------------------------------------------
P_LEN = 0
P_DIGEST = 1
P_PARENT = 9
P_CLEN = 17
P_BN = 18
P_SR = 23
P_DR = 55
P_G1 = 87
P_G2 = 88
NUM_PUBLICS = 89

_COMPACT_LEN = {0: 1, 1: 2, 2: 4, 3: 5}


def compact_len(first_byte: int) -> int:
    """SCALE compact-int byte length from its first byte (mode = 2 LSBs;
    mode 3 is the big-int form, 4 value bytes for block numbers —
    decoder.rs:94-103 / consts.rs MAX_COMPACT_UINT_BYTES=5)."""
    if (first_byte & 3) == 3:
        assert first_byte >> 2 == 0, "compact big-int wider than 4 bytes"
    return _COMPACT_LEN[first_byte & 3]


def derive_gammas(publics_87: List[int], device=None) -> Tuple[int, int]:
    """Fiat-Shamir challenges binding the extraction claims: Poseidon
    transcript over every non-γ public, run on ``device``."""
    ch = Challenger.new(device)
    ch.observe(gl.to_fp([int(p) for p in publics_87], device))
    g = gl.from_fp(ch.squeeze(2))
    return int(g[0]), int(g[1])


class HeaderAir(Blake2bVarAir):
    """One Avail header per trace: hash + field extraction."""

    num_publics = NUM_PUBLICS
    num_cols = H_NUM_COLS

    def constant_columns(self, n_rows: int):
        out = np.zeros((H_NUM_CONSTS, n_rows), dtype=np.uint64)
        if n_rows != self.n_rows:     # shape-only probe (Air.num_constraints)
            return out
        out[:V_NUM_CONSTS] = super().constant_columns(n_rows)
        for blk in range(self.num_blocks):
            r0 = blk * N_ROWS
            for rr in range(N_ROWS):
                out[HC_CIDX, r0 + rr] = r0 + rr
                out[HC_BPOW, r0 + rr] = 1 << (8 * (rr % 4))
                if rr % 4 == 0:
                    out[HC_WSTART, r0 + rr] = 1
                if rr % 4 == 3:
                    out[HC_HSEL + rr // 4, r0 + rr] = 1
        for k in range(5):
            out[HC_BNSEL + k, 32 + k] = 1
        return out

    # -- constraints ---------------------------------------------------

    def transition_iter(self, alg, local, next_row, publics, consts=(),
                        consts_next=()):
        # streaming form (see Blake2bVarAir.transition_iter); the list
        # wrapper `transition` is inherited
        yield from super().transition_iter(alg, local, next_row, publics,
                                           consts, consts_next)
        one = alg.one()
        St = self._stack

        # byte bits: boolean; MB = Σ 2^k bits
        bits = St([local[MBB + k] for k in range(8)])
        yield alg.sub(alg.mul(bits, bits), bits)
        mb_val = alg.zero()
        for k in range(8):
            mb_val = alg.add(mb_val,
                             alg.mul(alg.constant(1 << k), local[MBB + k]))
        yield alg.sub(local[MB], mb_val)

        # word-half accumulator: WACC' = MB'*BPOW' + (1-WSTART')*WACC
        yield alg.sub(
            next_row[WACC],
            alg.add(alg.mul(next_row[MB], consts_next[HC_BPOW]),
                    alg.mul(alg.sub(one, consts_next[HC_WSTART]),
                            local[WACC])))
        # word tie at half-end rows: WACC == blended MW half
        wend = alg.zero()
        blend = alg.zero()
        for q in range(32):
            wend = alg.add(wend, consts[HC_HSEL + q])
            blend = alg.add(blend, alg.mul(consts[HC_HSEL + q],
                                           local[MW + q]))
        yield alg.sub(alg.mul(wend, local[WACC]), blend)

        # block-number window byte pins (static rows 32..36)
        for k in range(5):
            yield alg.mul(consts[HC_BNSEL + k],
                          alg.sub(local[MB],
                                  alg.lift(publics[P_BN + k])))

        # window step markers: d boolean; jump row pinned by CIDX
        # (positions computed IN-RING from the public cells so the same
        # code records on the recursion machine — publics are degree-0
        # in every ring, so constraint degrees are unchanged)
        len_x = alg.lift(publics[P_LEN])
        clen_x = alg.lift(publics[P_CLEN])
        c32 = alg.constant(32)
        c64 = alg.constant(64)
        positions = [
            (S1S, alg.add(c32, clen_x)),         # state root start
            (S2S, alg.add(c64, clen_x)),         # state root end
            (S1D, alg.sub(len_x, c32)),          # data root start
            (S2D, len_x),                        # data root end
        ]
        for col, pos in positions:
            d = alg.sub(next_row[col], local[col])
            yield alg.sub(alg.mul(d, d), d)
            yield alg.mul(d, alg.sub(consts_next[HC_CIDX], pos))

        # γ-RLC window accumulators:
        #   A' = in'*(A*γ + MB') + (1-in')*A
        for s1, s2, acc_cols in ((S1S, S2S, (SRA1, SRA2)),
                                 (S1D, S2D, (DRA1, DRA2))):
            ins = alg.sub(next_row[s1], next_row[s2])
            for acc, gp in zip(acc_cols, (P_G1, P_G2)):
                gamma = alg.lift(publics[gp])
                upd = alg.add(alg.mul(alg.mul(local[acc], gamma), ins),
                              alg.mul(ins, next_row[MB]))
                yield alg.sub(
                    next_row[acc],
                    alg.add(upd, alg.mul(alg.sub(one, ins), local[acc])))

    def first_row(self, alg, local, publics, consts=()):
        cs = super().first_row(alg, local, publics, consts)
        # parent hash = message words 0..3 of chunk 0
        for i in range(8):
            cs.append(alg.sub(local[MW + i],
                              alg.lift(publics[P_PARENT + i])))
        cs.append(alg.sub(local[WACC], local[MB]))
        for col in (S1S, S2S, S1D, S2D, SRA1, SRA2, DRA1, DRA2):
            cs.append(local[col])
        return cs

    def last_row(self, alg, local, publics, consts=()):
        cs = super().last_row(alg, local, publics, consts)
        one = alg.one()
        for col in (S1S, S2S, S1D, S2D):
            cs.append(alg.sub(local[col], one))
        # Horner over claimed window bytes: Σ_j byte_j γ^(31-j)
        for base, acc_cols in ((P_SR, (SRA1, SRA2)),
                               (P_DR, (DRA1, DRA2))):
            for acc, gp in zip(acc_cols, (P_G1, P_G2)):
                gamma_x = alg.lift(publics[gp])
                rhs = alg.zero()
                for j in range(32):
                    rhs = alg.add(alg.mul(rhs, gamma_x),
                                  alg.lift(publics[base + j]))
                cs.append(alg.sub(local[acc], rhs))
        return cs

    # -- witness ---------------------------------------------------------

    def make_trace(self, msg: bytes, device=None):
        """msg: SCALE-encoded header bytes. -> (trace on ``device``,
        publics[89], digest).

        publics come back as Python ints; wrap with gl.to_fp for prove()."""
        length = len(msg)
        assert 65 <= length <= 128 * self.num_blocks - 4, length
        clen = compact_len(msg[32])
        assert length >= 64 + clen + 1, "header too short for state root"

        device = default_device(device)
        trace_v, pub_v, digest = super().make_trace(msg, device)

        publics = list(pub_v)                                     # 9
        for w in range(4):                                        # parent
            word = int.from_bytes(msg[8 * w:8 * w + 8], "little")
            publics += [word & 0xFFFFFFFF, word >> 32]
        publics.append(clen)
        publics += list(msg[32:37])                               # bn window
        sr = msg[32 + clen:64 + clen]
        dr = msg[length - 32:length]
        publics += list(sr)
        publics += list(dr)
        g1, g2 = derive_gammas(publics, device)
        publics += [g1, g2]

        n = self.n_rows
        buf = np.frombuffer(msg + b"\x00" * (128 * self.num_blocks - length),
                            dtype=np.uint8).astype(np.uint64)
        extra = np.zeros((H_NUM_COLS - V_NUM_COLS, n), dtype=np.uint64)
        X = V_NUM_COLS  # local offset helper
        extra[MB - X] = buf
        for k in range(8):
            extra[MBB - X + k] = (buf >> k) & 1
        # word accumulator
        wacc = np.zeros(n, dtype=np.uint64)
        for ph in range(4):
            idx = np.arange(ph, n, 4)
            wacc[idx] = buf[idx] << (8 * ph)
            if ph:
                wacc[idx] += wacc[idx - 1]
        extra[WACC - X] = wacc
        # step markers: S_r = [r >= pos]
        cidx = np.arange(n, dtype=np.int64)
        extra[S1S - X] = (cidx >= 32 + clen).astype(np.uint64)
        extra[S2S - X] = (cidx >= 64 + clen).astype(np.uint64)
        extra[S1D - X] = (cidx >= length - 32).astype(np.uint64)
        extra[S2D - X] = (cidx >= length).astype(np.uint64)
        # γ-RLC accumulators (python ints mod p; windows are 32 rows)
        # fill: 0 before the window, running value inside, frozen after
        for (start, g, row) in ((32 + clen, g1, SRA1 - X),
                                (32 + clen, g2, SRA2 - X),
                                (length - 32, g1, DRA1 - X),
                                (length - 32, g2, DRA2 - X)):
            acc = 0
            vals = np.zeros(n, dtype=np.uint64)
            for j in range(32):
                acc = (acc * g + int(buf[start + j])) % P
                vals[start + j] = acc
            vals[start + 32:] = acc
            extra[row] = vals

        trace = torch.cat([trace_v,
                           torch.from_numpy(extra.view(np.int64)).to(device)])
        return trace, publics, digest


def header_publics_fields(publics: List[int], check_gamma: bool = True,
                          device=None) -> dict:
    """Verifier-side interpretation + consistency checks of a HeaderAir
    public vector. Raises AssertionError on malformed claims. Returns
    parent_hash/digest bytes, block_number, state_root, data_root.

    ``check_gamma=False`` skips the γ-derivation check for subclasses that
    bind additional claim data into the challenges (air_rotate). The γ
    transcript runs on ``device``."""
    length = int(publics[P_LEN])
    clen = int(publics[P_CLEN])
    bn_bytes = bytes(int(publics[P_BN + k]) for k in range(5))
    sr = bytes(int(publics[P_SR + j]) for j in range(32))
    dr = bytes(int(publics[P_DR + j]) for j in range(32))
    from ..circuits import scale
    assert all(0 <= int(publics[P_BN + k]) < 256 for k in range(5))
    assert all(0 <= b < 256 for b in sr + dr)
    block_number, _, clen_dec = scale.decode_compact_u32(bn_bytes)
    assert clen_dec == clen, "claimed clen mismatch"
    assert bn_bytes == (scale.encode_compact_u32(block_number) + sr)[:5], \
        "window bytes beyond compact-int must match state root"
    assert length >= 64 + clen + 1
    if check_gamma:
        g1, g2 = derive_gammas([int(p) for p in publics[:P_G1]], device)
        assert int(publics[P_G1]) == g1 and int(publics[P_G2]) == g2, \
            "γ challenges not derived from the claim"
    parent = b"".join(
        (int(publics[P_PARENT + 2 * w]) |
         (int(publics[P_PARENT + 2 * w + 1]) << 32)).to_bytes(8, "little")
        for w in range(4))
    digest = b"".join(
        (int(publics[P_DIGEST + 2 * w]) |
         (int(publics[P_DIGEST + 2 * w + 1]) << 32)).to_bytes(8, "little")
        for w in range(4))
    return dict(length=length, parent_hash=parent, digest=digest,
                block_number=block_number, state_root=sr, data_root=dr)
