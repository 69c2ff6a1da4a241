"""SHA-512 challenge AIR — the EdDSA challenge h = SHA-512(R‖A‖M) mod L
proven in-STARK.

This AIR proves, for every signature lane (a, r, s, h) — the SAME lane
tuples Ed25519VerifyAir carries — that

    digest = SHA-512( r ‖ a ‖ M )          (two 1024-bit blocks), and
    LE-integer(digest) = q·L + h           over ZZ (witnessed q),

so h ≡ digest (mod L). No canonicity of h is needed: for prime-order A,
[h]A == [h+L]A, so any representative < 2^B·16 verifies the same
equation the ladder proves.

Layout per 256-row lane block (all schedules are constant columns):

  rows 0..79     block-1 rounds (one SHA-512 round per row)
  row  80        block-1 final state; feed-forward into H on 80→81
  row  81        block-2 reload (working state := H) + first round rows
  rows 81..160   block-2 rounds
  row  161       block-2 final state; feed-forward into H on 161→162
  rows 162..194  33 reduction rows: base-2^16 coefficient k per row —
                 running-carry chain  s_k + t_{k-1} = 2^16·t_k  with
                 s_k = Σ_i q16_i·L16_{k-i} + h16_k − d16_k; digest bytes
                 (2/row) Horner-bind to the H words; q/T limbs LogUp
                 range-checked (scaled copies pin bytes to 8 bits)
  rows 195..255  idle

Representation follows air_sha256.py lifted to 64-bit words: working
variables a,b,c,e,f,g as 64 bit-columns each (Σ/σ/ch/maj are degree≤3
grouped identities; rotations roll the group axis); d,h and the 16-word
schedule window as (lo, hi) 32-bit value pairs; all 64-bit additions
constrain 32-bit half-sums with small boolean/3-bit carries (sound in
Goldilocks: half-sums < 2^35 << p).

Publics (9): [n_sigs] + 8×32-bit words of SHA-256 over
(lane tuples ‖ message) — the claim binding; the verifier reconstructs
the AIR (hence the VK) from the same bundle data.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

from ..circuits.ed25519 import L_ORDER
from ..field import goldilocks as gl
from .air_sha256 import Sha256CompressAir as _GroupedBase
from ..hashes.sha512 import _K as K512, _H0 as H0_512

P = gl.MODULUS
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1

ROWS_PER_LANE = 256
R_B2 = 81            # first block-2 round row
R_FF1 = 80           # block-1 final state row
R_FF2 = 161          # block-2 final state row
R_RED = 162          # first reduction row
N_RED = 33           # base-2^16 coefficients of the 512-bit identity
NQ = 17              # q limbs (base 2^16): q < D/L < 2^261 ≤ 2^272

# --- committed column layout ------------------------------------------------
A, B_, C_, E_, F_, G_ = 0, 64, 128, 192, 256, 320
D_LO, D_HI, H_LO, H_HI = 384, 385, 386, 387
W_LO, W_HI = 388, 404           # 16 + 16 window value columns
W1B, W14B = 420, 484            # 64-bit tap families
BS0_LO, BS0_HI, BS1_LO, BS1_HI = 548, 549, 550, 551
CH_LO, CH_HI, MJ_LO, MJ_HI = 552, 553, 554, 555
SG0_LO, SG0_HI, SG1_LO, SG1_HI = 556, 557, 558, 559
CA = 560                        # 3+3 carry bits (a-update lo/hi)
CE = 566                        # 3+3 (e-update)
CW = 572                        # 2+2 (schedule)
HREG = 576                      # 8 words x (lo, hi): chained state
FFC = 592                       # 8+8 feed-forward carry bits (lo, hi)
QB = 608                        # 34 q bytes (2 per 16-bit limb)
QBS = 642                       # 34 scaled copies (q byte · 2^(B-8))
DB = 676                        # 2 digest bytes this row
DBS = 678                       # 2 scaled copies
ACC = 680                       # Horner accumulator (digest-byte binding)
TU = 681                        # 3 carry-chain limbs (offset carry)
TUS = 684                       # scaled copy of top carry limb
NUM_COLS = 685

T_LIMBS = 3
T_OFS_BITS = 22                 # |t| < 2^21; u = t + 2^22 < 2^23
T_U_BITS = T_OFS_BITS + 1

# --- constant column layout -------------------------------------------------
CK_LO, CK_HI = 0, 1             # round constant halves
C_ROUND, C_SCHED = 2, 3
C_BSTART, C_BINIT, C_FF, C_RELOAD, C_HCOPY, C_WCOPY = 4, 5, 6, 7, 8, 9
C_WI_LO, C_WI_HI = 10, 26      # window init values (rows 0 / 81)
C_RED, C_REDB = 42, 43         # reduction row; reduction row with bytes
C_RED_START, C_RED_END = 44, 45
C_ACCNEW, C_CMP_HI, C_CMP_LO = 46, 47, 48
C_HLIMB = 49                    # h16_k this row
C_LH = 50                       # 17 cols: L16_{k-i} for i = 0..16
C_HSEL = 67                     # 8 one-hot: word compared on this row
NUM_CONSTS = 75

_L16 = [(L_ORDER >> (16 * i)) & 0xFFFF for i in range(16)]


def _rotr64(x: int, r: int) -> int:
    return ((x >> r) | (x << (64 - r))) & M64


def _pad_blocks(msg: bytes) -> List[List[int]]:
    """SHA-512 padding -> list of 16-word (int) blocks."""
    ln = len(msg)
    buf = msg + b"\x80"
    while (len(buf) + 16) % 128:
        buf += b"\x00"
    buf += (8 * ln).to_bytes(16, "big")
    out = []
    for b0 in range(0, len(buf), 128):
        out.append([int.from_bytes(buf[b0 + 8 * i:b0 + 8 * i + 8], "big")
                    for i in range(16)])
    return out


def _dummy_lane(message: bytes):
    """Padding lane: the all-zero R/A with its true digest-derived h —
    satisfies the hash relation trivially (mirrors Ed25519VerifyAir's
    dummy lanes, which verify [0]B relations)."""
    a = bytes(32)
    r = bytes(32)
    dg = hashlib.sha512(r + a + message).digest()
    h = int.from_bytes(dg, "little") % L_ORDER
    return (a, r, 0, h)


class Sha512ChallengeAir(_GroupedBase):
    """lanes: (a_bytes, r_bytes, s, h) tuples — Ed25519VerifyAir.sigs;
    message: the signed bytes M (same for every lane); B = log2(n_rows)
    (8 → one lane, 13 → 32 lanes), also the LogUp limb width."""

    num_cols = NUM_COLS
    num_publics = 9
    max_constraint_degree = 3

    def __init__(self, lanes: Sequence[Tuple[bytes, bytes, int, int]],
                 message: bytes, B: int = 8):
        assert B >= 8
        self.B = B
        self.n_rows = 1 << B
        n_lanes = self.n_rows // ROWS_PER_LANE
        assert len(lanes) <= n_lanes
        # two-block layout: 128 < 64 + len(M) + 17 <= 256
        assert 47 < len(message) <= 175, \
            "message length must give exactly two SHA-512 blocks"
        self.message = bytes(message)
        self.n_sigs = len(lanes)
        # Ed25519 shard padding uses air_ed25519.dummy_sig() whose h = 0
        # is NOT the digest residue — no hash binding is needed for those
        # lanes (the bundle check pins unsigned lanes to the exact dummy
        # tuple), so map them DETERMINISTICALLY to this AIR's own
        # hash-consistent dummy; the verifier's reconstruction applies the
        # same rule to the same bundle data.
        from .air_ed25519 import dummy_sig
        ed_dummy = dummy_sig()
        lanes = [tuple(l) if tuple(l) != ed_dummy
                 else _dummy_lane(self.message) for l in lanes]
        self.lanes = list(lanes) + [_dummy_lane(self.message)
                                    ] * (n_lanes - len(lanes))
        self.n_lanes = n_lanes
        for a, r, s, h in self.lanes:
            assert len(a) == 32 and len(r) == 32
            assert 0 <= h < (1 << (16 * 16))

    # -- range-checked columns -------------------------------------------
    def lookup_range_columns(self) -> List[int]:
        return ([QB + i for i in range(34)] + [QBS + i for i in range(34)]
                + [DB, DB + 1, DBS, DBS + 1]
                + [TU + i for i in range(T_LIMBS)] + [TUS])

    # -- constants --------------------------------------------------------
    def _lane_blocks(self, lane) -> List[List[int]]:
        a, r, s, h = lane
        blocks = _pad_blocks(r + a + self.message)
        assert len(blocks) == 2
        return blocks

    def constant_columns(self, n_rows: int):
        out = np.zeros((NUM_CONSTS, n_rows), dtype=np.uint64)
        if n_rows != self.n_rows:
            return out
        for li in range(self.n_lanes):
            r0 = li * ROWS_PER_LANE
            blocks = self._lane_blocks(self.lanes[li])
            h = self.lanes[li][3]
            for blk, base in ((0, 0), (1, R_B2)):
                for rr in range(80):
                    row = r0 + base + rr
                    out[CK_LO, row] = K512[rr] & M32
                    out[CK_HI, row] = K512[rr] >> 32
                    out[C_ROUND, row] = 1
                    if rr < 64:
                        out[C_SCHED, row] = 1
            out[C_BSTART, r0] = 1
            out[C_BINIT, r0] = 1
            out[C_BINIT, r0 + R_B2] = 1
            out[C_FF, r0 + R_FF1] = 1
            out[C_FF, r0 + R_FF2] = 1
            out[C_RELOAD, r0 + R_B2] = 1
            for j in range(16):
                out[C_WI_LO + j, r0] = blocks[0][j] & M32
                out[C_WI_HI + j, r0] = blocks[0][j] >> 32
                out[C_WI_LO + j, r0 + R_B2] = blocks[1][j] & M32
                out[C_WI_HI + j, r0 + R_B2] = blocks[1][j] >> 32
            # H register copies everywhere inside the lane except the two
            # FF rows and the final lane row (cross-lane boundary)
            for rr in range(ROWS_PER_LANE - 1):
                if rr not in (R_FF1, R_FF2):
                    out[C_HCOPY, r0 + rr] = 1
            # (no window copies needed: the shift covers rounds, BINIT
            # pins block starts, and the post-161 window is unused)
            # reduction schedule
            for k in range(N_RED):
                row = r0 + R_RED + k
                out[C_RED, row] = 1
                if k < 32:
                    out[C_REDB, row] = 1
                    if k % 2 == 0:
                        out[C_ACCNEW, row] = 1
                    if k % 4 == 1:
                        out[C_CMP_HI, row] = 1
                    if k % 4 == 3:
                        out[C_CMP_LO, row] = 1
                    out[C_HSEL + (k // 4), row] = 1
                out[C_HLIMB, row] = (h >> (16 * k)) & 0xFFFF if k < 16 else 0
                for i in range(NQ):
                    j = k - i
                    if 0 <= j < 16:
                        out[C_LH + i, row] = _L16[j]
            out[C_RED_START, r0 + R_RED] = 1
            out[C_RED_END, r0 + R_RED + N_RED - 1] = 1
        return out

    # -- publics ----------------------------------------------------------
    def publics_list(self) -> List[int]:
        """[n_sigs] + 8×32-bit words of SHA-256 over (lane data ‖ M)."""
        hsh = hashlib.sha256()
        for a, r, s, h in self.lanes:
            hsh.update(a + r + int(s).to_bytes(32, "little")
                       + int(h).to_bytes(32, "little"))
        hsh.update(self.message)
        d = hsh.digest()
        return [self.n_sigs] + [int.from_bytes(d[4 * i:4 * i + 4], "big")
                                for i in range(8)]

    # -- constraint helpers ------------------------------------------------
    def _pw2_64(self, alg):
        return self._stack([alg.constant((1 << i) % P) for i in range(64)])

    def _halves_g(self, alg, bits_g):
        """64-bit grouped bit family -> (lo_val, hi_val) 32-bit sums."""
        pw = self._stack([alg.constant(1 << (i % 32)) for i in range(64)])
        prod = alg.mul(bits_g, pw)
        lo = self._sum0(self._mask0(prod, [i < 32 for i in range(64)]))
        hi = self._sum0(self._mask0(prod, [i >= 32 for i in range(64)]))
        return lo, hi

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        cs = []
        one = alg.one()
        St = self._stack
        R = self._roll
        two32 = alg.constant(1 << 32)
        two16 = alg.constant(1 << 16)

        def bits_g(base, row=local, n=64):
            return St([row[base + i] for i in range(n)])

        a, b, c = bits_g(A), bits_g(B_), bits_g(C_)
        e, f, g = bits_g(E_), bits_g(F_), bits_g(G_)
        w1b, w14b = bits_g(W1B), bits_g(W14B)
        carr = St([local[CA + i] for i in range(6)]
                  + [local[CE + i] for i in range(6)]
                  + [local[CW + i] for i in range(4)]
                  + [local[FFC + i] for i in range(16)])

        for fam in (a, b, c, e, f, g, w1b, w14b, carr):
            cs.append(alg.sub(alg.mul(fam, fam), fam))

        # tap consistency: W1B == W[1], W14B == W[14] (half sums)
        for fam, wl, wh in ((w1b, W_LO + 1, W_HI + 1),
                            (w14b, W_LO + 14, W_HI + 14)):
            lo, hi = self._halves_g(alg, fam)
            cs.append(alg.sub(lo, local[wl]))
            cs.append(alg.sub(hi, local[wh]))

        # Σ/σ/ch/maj definitional halves
        def put_halves(expr_g, col_lo, col_hi):
            lo, hi = self._halves_g(alg, expr_g)
            cs.append(alg.sub(local[col_lo], lo))
            cs.append(alg.sub(local[col_hi], hi))

        put_halves(self._xor3_g(alg, R(e, -14), R(e, -18), R(e, -41)),
                   BS1_LO, BS1_HI)
        put_halves(self._xor3_g(alg, R(a, -28), R(a, -34), R(a, -39)),
                   BS0_LO, BS0_HI)
        put_halves(alg.add(alg.mul(e, f), alg.mul(alg.sub(one, e), g)),
                   CH_LO, CH_HI)
        maj = alg.sub(alg.add(alg.add(alg.mul(a, b), alg.mul(a, c)),
                              alg.mul(b, c)),
                      alg.mul(alg.constant(2), alg.mul(alg.mul(a, b), c)))
        put_halves(maj, MJ_LO, MJ_HI)
        shr7 = self._mask0(R(w1b, -7), [i <= 56 for i in range(64)])
        put_halves(self._xor3_g(alg, R(w1b, -1), R(w1b, -8), shr7),
                   SG0_LO, SG0_HI)
        shr6 = self._mask0(R(w14b, -6), [i <= 57 for i in range(64)])
        put_halves(self._xor3_g(alg, R(w14b, -19), R(w14b, -61), shr6),
                   SG1_LO, SG1_HI)

        is_round = consts[C_ROUND]
        is_sched = consts[C_SCHED]

        # t1 = h + Σ1 + ch + K + w0 ; t2 = Σ0 + maj  (32-bit halves)
        t1_lo = alg.add(alg.add(local[H_LO], local[BS1_LO]),
                        alg.add(alg.add(local[CH_LO], consts[CK_LO]),
                                local[W_LO + 0]))
        t1_hi = alg.add(alg.add(local[H_HI], local[BS1_HI]),
                        alg.add(alg.add(local[CH_HI], consts[CK_HI]),
                                local[W_HI + 0]))
        t2_lo = alg.add(local[BS0_LO], local[MJ_LO])
        t2_hi = alg.add(local[BS0_HI], local[MJ_HI])

        na_lo, na_hi = self._halves_g(alg, bits_g(A, next_row))
        ne_lo, ne_hi = self._halves_g(alg, bits_g(E_, next_row))
        ca_lo = self._val3(alg, [local[CA + i] for i in range(3)])
        ca_hi = self._val3(alg, [local[CA + 3 + i] for i in range(3)])
        ce_lo = self._val3(alg, [local[CE + i] for i in range(3)])
        ce_hi = self._val3(alg, [local[CE + 3 + i] for i in range(3)])

        cs.append(alg.mul(is_round, alg.sub(
            alg.add(na_lo, alg.mul(ca_lo, two32)), alg.add(t1_lo, t2_lo))))
        cs.append(alg.mul(is_round, alg.sub(
            alg.add(na_hi, alg.mul(ca_hi, two32)),
            alg.add(alg.add(t1_hi, t2_hi), ca_lo))))
        cs.append(alg.mul(is_round, alg.sub(
            alg.add(ne_lo, alg.mul(ce_lo, two32)),
            alg.add(local[D_LO], t1_lo))))
        cs.append(alg.mul(is_round, alg.sub(
            alg.add(ne_hi, alg.mul(ce_hi, two32)),
            alg.add(alg.add(local[D_HI], t1_hi), ce_lo))))

        # family rotation on round rows: b'=a, c'=b, f'=e, g'=f
        for dst, src in ((B_, a), (C_, b), (F_, e), (G_, f)):
            nd = bits_g(dst, next_row)
            cs.append(alg.mul(is_round, alg.sub(nd, src)))
        # d' = c value, h' = g value on round rows
        c_lo, c_hi = self._halves_g(alg, c)
        g_lo, g_hi = self._halves_g(alg, g)
        cs.append(alg.mul(is_round, alg.sub(next_row[D_LO], c_lo)))
        cs.append(alg.mul(is_round, alg.sub(next_row[D_HI], c_hi)))
        cs.append(alg.mul(is_round, alg.sub(next_row[H_LO], g_lo)))
        cs.append(alg.mul(is_round, alg.sub(next_row[H_HI], g_hi)))

        # window shift + schedule on round rows
        for half, base in ((W_LO, W_LO), (W_HI, W_HI)):
            w_hi_g = St([local[base + j + 1] for j in range(15)])
            nw_lo_g = St([next_row[base + j] for j in range(15)])
            cs.append(alg.mul(is_round, alg.sub(nw_lo_g, w_hi_g)))
        cw_lo = self._val3(alg, [local[CW], local[CW + 1]])
        cw_hi = self._val3(alg, [local[CW + 2], local[CW + 3]])
        ss_lo = alg.add(alg.add(local[W_LO + 0], local[SG0_LO]),
                        alg.add(local[W_LO + 9], local[SG1_LO]))
        ss_hi = alg.add(alg.add(local[W_HI + 0], local[SG0_HI]),
                        alg.add(local[W_HI + 9], local[SG1_HI]))
        cs.append(alg.mul(is_sched, alg.sub(
            alg.add(next_row[W_LO + 15], alg.mul(cw_lo, two32)), ss_lo)))
        cs.append(alg.mul(is_sched, alg.sub(
            alg.add(next_row[W_HI + 15], alg.mul(cw_hi, two32)),
            alg.add(ss_hi, cw_lo))))
        # window init rows: W == lane constants
        binit_n = consts_next[C_BINIT]
        for base, cbase in ((W_LO, C_WI_LO), (W_HI, C_WI_HI)):
            nwg = St([next_row[base + j] for j in range(16)])
            cwg = St([consts_next[cbase + j] for j in range(16)])
            cs.append(alg.mul(binit_n, alg.sub(nwg, cwg)))

        # H register: copy / feed-forward
        hcopy = consts[C_HCOPY]
        is_ff = consts[C_FF]
        work = [  # (lo, hi) ring values of working registers a..h this row
            self._halves_g(alg, a), self._halves_g(alg, b),
            self._halves_g(alg, c), (local[D_LO], local[D_HI]),
            self._halves_g(alg, e), self._halves_g(alg, f),
            self._halves_g(alg, g), (local[H_LO], local[H_HI])]
        for j in range(8):
            hl, hh = local[HREG + 2 * j], local[HREG + 2 * j + 1]
            nhl, nhh = next_row[HREG + 2 * j], next_row[HREG + 2 * j + 1]
            cs.append(alg.mul(hcopy, alg.sub(nhl, hl)))
            cs.append(alg.mul(hcopy, alg.sub(nhh, hh)))
            wl, wh = work[j]
            cs.append(alg.mul(is_ff, alg.sub(
                alg.add(nhl, alg.mul(local[FFC + j], two32)),
                alg.add(hl, wl))))
            cs.append(alg.mul(is_ff, alg.sub(
                alg.add(nhh, alg.mul(local[FFC + 8 + j], two32)),
                alg.add(alg.add(hh, wh), local[FFC + j]))))

        # block-2 reload: working state := H (on the reload row)
        reload_n = consts_next[C_RELOAD]
        nwork = [
            self._halves_g(alg, bits_g(A, next_row)),
            self._halves_g(alg, bits_g(B_, next_row)),
            self._halves_g(alg, bits_g(C_, next_row)),
            (next_row[D_LO], next_row[D_HI]),
            self._halves_g(alg, bits_g(E_, next_row)),
            self._halves_g(alg, bits_g(F_, next_row)),
            self._halves_g(alg, bits_g(G_, next_row)),
            (next_row[H_LO], next_row[H_HI])]
        for j in range(8):
            cs.append(alg.mul(reload_n, alg.sub(
                nwork[j][0], next_row[HREG + 2 * j])))
            cs.append(alg.mul(reload_n, alg.sub(
                nwork[j][1], next_row[HREG + 2 * j + 1])))

        # ---- reduction rows --------------------------------------------
        is_red_n = consts_next[C_RED]
        is_redb = consts[C_REDB]
        sc = alg.constant(1 << (self.B - 8))
        # scaled byte copies (8-bit pin against the B-bit ramp)
        qb_g = St([local[QB + i] for i in range(34)])
        qbs_g = St([local[QBS + i] for i in range(34)])
        cs.append(alg.sub(qbs_g, alg.mul(qb_g, sc)))
        db_g = St([local[DB], local[DB + 1]])
        dbs_g = St([local[DBS], local[DBS + 1]])
        cs.append(alg.sub(dbs_g, alg.mul(db_g, sc)))
        # q limbs frozen across the lane's reduction rows
        cs.append(alg.mul(alg.mul(consts[C_RED], is_red_n),
                          alg.sub(St([next_row[QB + i] for i in range(34)]),
                                  qb_g)))

        # carry chain: s_k(next) + t(local) == 2^16 · t(next), with
        # t = T_U − 2^22 (T_U from range-checked limbs)
        def t_u(row):
            acc = row[TU]
            acc = alg.add(acc, alg.mul(row[TU + 1],
                                       alg.constant(1 << self.B)))
            # top limb arrives pre-scaled: TU2·2^(B-top) committed in TUS
            acc = alg.add(acc, alg.mul(row[TU + 2],
                                       alg.constant(1 << (2 * self.B))))
            return acc

        ofs = alg.constant(1 << T_OFS_BITS)
        conv = alg.zero()
        for i in range(NQ):
            q16 = alg.add(next_row[QB + 2 * i],
                          alg.mul(alg.constant(256), next_row[QB + 2 * i + 1]))
            conv = alg.add(conv, alg.mul(q16, consts_next[C_LH + i]))
        d16 = alg.add(next_row[DB], alg.mul(alg.constant(256),
                                            next_row[DB + 1]))
        s_k = alg.sub(alg.add(conv, consts_next[C_HLIMB]), d16)
        t_loc = alg.sub(t_u(local), ofs)
        t_nxt = alg.sub(t_u(next_row), ofs)
        # at the first reduction row the incoming carry is zero
        t_in = alg.mul(alg.sub(one, consts_next[C_RED_START]), t_loc)
        cs.append(alg.mul(is_red_n, alg.sub(
            alg.add(s_k, t_in), alg.mul(two16, t_nxt))))
        # top carry limb bound: TU2 < 2^(u-2B); committed scaled copy
        top_bits = T_U_BITS - 2 * self.B
        if top_bits > 0:
            cs.append(alg.sub(local[TUS],
                              alg.mul(local[TU + 2],
                                      alg.constant(1 << (self.B - top_bits)))))
        else:
            cs.append(local[TU + 2])
            cs.append(local[TUS])
        # final carry zero
        cs.append(alg.mul(consts[C_RED_END], alg.sub(t_u(local), ofs)))

        # digest bytes on reduction rows: d16 uses bytes LE; Horner binds
        # the SAME bytes big-endian to the H (digest) words
        pair_be = alg.add(alg.mul(alg.constant(256), local[DB]),
                          local[DB + 1])
        accnew = consts[C_ACCNEW]
        cs.append(alg.mul(accnew, alg.sub(local[ACC], pair_be)))
        # continuing rows: ACC == prev·2^16 + pair — needs prev ACC: use
        # transition form gated on next row being a continuing byte row
        cont_n = alg.sub(consts_next[C_REDB], consts_next[C_ACCNEW])
        pair_be_n = alg.add(alg.mul(alg.constant(256), next_row[DB]),
                            next_row[DB + 1])
        cs.append(alg.mul(cont_n, alg.sub(
            next_row[ACC], alg.add(alg.mul(local[ACC], two16), pair_be_n))))
        # comparisons against the selected digest word
        hsel_lo = alg.zero()
        hsel_hi = alg.zero()
        for j in range(8):
            hs = consts[C_HSEL + j]
            hsel_lo = alg.add(hsel_lo, alg.mul(hs, local[HREG + 2 * j]))
            hsel_hi = alg.add(hsel_hi, alg.mul(hs, local[HREG + 2 * j + 1]))
        cs.append(alg.mul(consts[C_CMP_HI], alg.sub(local[ACC], hsel_hi)))
        cs.append(alg.mul(consts[C_CMP_LO], alg.sub(local[ACC], hsel_lo)))

        # block/lane start: working state = IV, H = IV (row 0 of each lane)
        bstart_n = consts_next[C_BSTART]
        for j in range(8):
            iv_lo = alg.constant(H0_512[j] & M32)
            iv_hi = alg.constant(H0_512[j] >> 32)
            cs.append(alg.mul(bstart_n, alg.sub(nwork[j][0], iv_lo)))
            cs.append(alg.mul(bstart_n, alg.sub(nwork[j][1], iv_hi)))
            cs.append(alg.mul(bstart_n,
                              alg.sub(next_row[HREG + 2 * j], iv_lo)))
            cs.append(alg.mul(bstart_n,
                              alg.sub(next_row[HREG + 2 * j + 1], iv_hi)))
        return cs

    def first_row(self, alg, local, publics, consts=()):
        # row 0 is a lane start: same pins as the bstart transition
        cs = []
        St = self._stack

        def bits_g(base, n=64):
            return St([local[base + i] for i in range(n)])

        work = [
            self._halves_g(alg, bits_g(A)), self._halves_g(alg, bits_g(B_)),
            self._halves_g(alg, bits_g(C_)), (local[D_LO], local[D_HI]),
            self._halves_g(alg, bits_g(E_)), self._halves_g(alg, bits_g(F_)),
            self._halves_g(alg, bits_g(G_)), (local[H_LO], local[H_HI])]
        for j in range(8):
            iv_lo = alg.constant(H0_512[j] & M32)
            iv_hi = alg.constant(H0_512[j] >> 32)
            cs.append(alg.sub(work[j][0], iv_lo))
            cs.append(alg.sub(work[j][1], iv_hi))
            cs.append(alg.sub(local[HREG + 2 * j], iv_lo))
            cs.append(alg.sub(local[HREG + 2 * j + 1], iv_hi))
        for j in range(16):
            cs.append(alg.sub(local[W_LO + j], consts[C_WI_LO + j]))
            cs.append(alg.sub(local[W_HI + j], consts[C_WI_HI + j]))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        return []

    # ------------------------------------------------------------------
    # Witness
    # ------------------------------------------------------------------
    def make_trace(self, device=None):
        """-> ((NUM_COLS, n_rows) trace on ``device``, publics[9])."""
        n = self.n_rows
        cols = np.zeros((NUM_COLS, n), dtype=np.object_)
        for li, lane in enumerate(self.lanes):
            self._fill_lane(cols, li * ROWS_PER_LANE, lane)
        trace = gl.to_fp(cols, device)
        return trace, self.publics_list()

    def _fill_lane(self, cols, r0: int, lane):
        a_b, r_b, s, h = lane
        blocks = self._lane_blocks(lane)
        digest = hashlib.sha512(r_b + a_b + self.message).digest()
        D = int.from_bytes(digest, "little")
        q, rem = divmod(D - h, L_ORDER)
        assert rem == 0 and q >= 0 and q < 1 << (16 * NQ), \
            "lane h does not reduce from its digest"

        state = [int(x) for x in H0_512]
        row_state = {}
        for blk in (0, 1):
            base = 0 if blk == 0 else R_B2
            w = list(blocks[blk])
            for t in range(16, 80):
                s0 = (_rotr64(w[t - 15], 1) ^ _rotr64(w[t - 15], 8)
                      ^ (w[t - 15] >> 7))
                s1 = (_rotr64(w[t - 2], 19) ^ _rotr64(w[t - 2], 61)
                      ^ (w[t - 2] >> 6))
                w.append((w[t - 16] + s0 + w[t - 7] + s1) & M64)
            w_ext = w + [0] * 16
            av, bv, cv, dv, ev, fv, gv, hv = state
            hreg = list(state)
            for rr in range(81):
                row = r0 + base + rr
                is_round = rr < 80
                window = w_ext[rr:rr + 16] if rr < 80 else \
                    (w_ext[80:80 + 15] + [0])
                self._fill_round_row(cols, row, (av, bv, cv, dv, ev, fv,
                                                 gv, hv), window, hreg,
                                     rr if is_round else None)
                if is_round:
                    k = K512[rr]
                    bsig1 = (_rotr64(ev, 14) ^ _rotr64(ev, 18)
                             ^ _rotr64(ev, 41))
                    ch = (ev & fv) ^ ((~ev & M64) & gv)
                    t1 = hv + bsig1 + ch + k + window[0]
                    bsig0 = (_rotr64(av, 28) ^ _rotr64(av, 34)
                             ^ _rotr64(av, 39))
                    maj = (av & bv) ^ (av & cv) ^ (bv & cv)
                    t2 = bsig0 + maj
                    na, ne = (t1 + t2), (dv + t1)
                    # carries
                    t1_lo = ((hv & M32) + (bsig1 & M32) + (ch & M32)
                             + (k & M32) + (window[0] & M32))
                    t2_lo = (bsig0 & M32) + (maj & M32)
                    sa_lo = t1_lo + t2_lo
                    ca_l = sa_lo >> 32
                    sa_hi = ((hv >> 32) + (bsig1 >> 32) + (ch >> 32)
                             + (k >> 32) + (window[0] >> 32)
                             + (bsig0 >> 32) + (maj >> 32) + ca_l)
                    ca_h = sa_hi >> 32
                    se_lo = (dv & M32) + t1_lo
                    ce_l = se_lo >> 32
                    se_hi = (dv >> 32) + ((hv >> 32) + (bsig1 >> 32)
                                          + (ch >> 32) + (k >> 32)
                                          + (window[0] >> 32)) + ce_l
                    ce_h = se_hi >> 32
                    for i in range(3):
                        cols[CA + i, row] = (ca_l >> i) & 1
                        cols[CA + 3 + i, row] = (ca_h >> i) & 1
                        cols[CE + i, row] = (ce_l >> i) & 1
                        cols[CE + 3 + i, row] = (ce_h >> i) & 1
                    if rr < 64:
                        ss_lo = ((window[0] & M32)
                                 + ((_rotr64(window[1], 1)
                                     ^ _rotr64(window[1], 8)
                                     ^ (window[1] >> 7)) & M32)
                                 + (window[9] & M32)
                                 + ((_rotr64(window[14], 19)
                                     ^ _rotr64(window[14], 61)
                                     ^ (window[14] >> 6)) & M32))
                        cw_l = ss_lo >> 32
                        ss_hi = (((window[0] >> 32)
                                  + ((_rotr64(window[1], 1)
                                      ^ _rotr64(window[1], 8)
                                      ^ (window[1] >> 7)) >> 32)
                                  + (window[9] >> 32)
                                  + ((_rotr64(window[14], 19)
                                      ^ _rotr64(window[14], 61)
                                      ^ (window[14] >> 6)) >> 32)) + cw_l)
                        cw_h = ss_hi >> 32
                        for i in range(2):
                            cols[CW + i, row] = (cw_l >> i) & 1
                            cols[CW + 2 + i, row] = (cw_h >> i) & 1
                    hv, gv, fv, ev = gv, fv, ev, ne & M64
                    dv, cv, bv, av = cv, bv, av, na & M64
            # feed-forward at the block's final-state row
            fin = [av, bv, cv, dv, ev, fv, gv, hv]
            ff_row = r0 + base + 80
            new_state = []
            for j in range(8):
                lo_sum = (state[j] & M32) + (fin[j] & M32)
                cl = lo_sum >> 32
                hi_sum = (state[j] >> 32) + (fin[j] >> 32) + cl
                ch_ = hi_sum >> 32
                cols[FFC + j, ff_row] = cl
                cols[FFC + 8 + j, ff_row] = ch_
                new_state.append(((hi_sum & M32) << 32) | (lo_sum & M32))
            state = new_state
        # digest sanity
        want = [int.from_bytes(digest[8 * j:8 * j + 8], "big")
                for j in range(8)]
        assert state == want

        # rows R_FF2+1 .. end: H frozen at digest; reduction witness
        for rr in range(R_FF2 + 1, ROWS_PER_LANE):
            row = r0 + rr
            for j in range(8):
                cols[HREG + 2 * j, row] = state[j] & M32
                cols[HREG + 2 * j + 1, row] = state[j] >> 32
        sc = 1 << (self.B - 8)
        qbytes = [(q >> (8 * i)) & 0xFF for i in range(2 * NQ)]
        t = 0
        acc = 0
        dbytes = list(digest)
        for k in range(N_RED):
            row = r0 + R_RED + k
            for i in range(2 * NQ):
                cols[QB + i, row] = qbytes[i]
                cols[QBS + i, row] = qbytes[i] * sc
            if k < 32:
                b0, b1 = dbytes[2 * k], dbytes[2 * k + 1]
                cols[DB, row] = b0
                cols[DB + 1, row] = b1
                cols[DBS, row] = b0 * sc
                cols[DBS + 1, row] = b1 * sc
                d16 = b0 + 256 * b1
                pair_be = 256 * b0 + b1
                acc = pair_be if k % 2 == 0 else (acc << 16) + pair_be
                cols[ACC, row] = acc
            else:
                d16 = 0
            conv = sum(((q >> (16 * i)) & 0xFFFF) * (_L16[k - i]
                                                     if 0 <= k - i < 16
                                                     else 0)
                       for i in range(NQ))
            h16 = (h >> (16 * k)) & 0xFFFF if k < 16 else 0
            s_k = conv + h16 - d16
            tot = s_k + t
            assert tot % (1 << 16) == 0, (k, tot)
            t = tot >> 16
            u = t + (1 << T_OFS_BITS)
            assert 0 <= u < (1 << T_U_BITS), (k, t)
            mask = (1 << self.B) - 1
            cols[TU, row] = u & mask
            cols[TU + 1, row] = (u >> self.B) & mask
            top = u >> (2 * self.B)
            top_bits = T_U_BITS - 2 * self.B
            if top_bits > 0:
                cols[TU + 2, row] = top
                cols[TUS, row] = top << (self.B - top_bits)
        assert t == 0, t

    def _fill_round_row(self, cols, row, work, window, hreg, rr):
        av, bv, cv, dv, ev, fv, gv, hv = work
        for i in range(64):
            cols[A + i, row] = (av >> i) & 1
            cols[B_ + i, row] = (bv >> i) & 1
            cols[C_ + i, row] = (cv >> i) & 1
            cols[E_ + i, row] = (ev >> i) & 1
            cols[F_ + i, row] = (fv >> i) & 1
            cols[G_ + i, row] = (gv >> i) & 1
            cols[W1B + i, row] = (window[1] >> i) & 1
            cols[W14B + i, row] = (window[14] >> i) & 1
        cols[D_LO, row] = dv & M32
        cols[D_HI, row] = dv >> 32
        cols[H_LO, row] = hv & M32
        cols[H_HI, row] = hv >> 32
        for j in range(16):
            cols[W_LO + j, row] = window[j] & M32
            cols[W_HI + j, row] = window[j] >> 32
        for j in range(8):
            cols[HREG + 2 * j, row] = hreg[j] & M32
            cols[HREG + 2 * j + 1, row] = hreg[j] >> 32
        bsig1 = _rotr64(ev, 14) ^ _rotr64(ev, 18) ^ _rotr64(ev, 41)
        bsig0 = _rotr64(av, 28) ^ _rotr64(av, 34) ^ _rotr64(av, 39)
        ch = (ev & fv) ^ ((~ev & M64) & gv)
        maj = (av & bv) ^ (av & cv) ^ (bv & cv)
        sg0 = (_rotr64(window[1], 1) ^ _rotr64(window[1], 8)
               ^ (window[1] >> 7))
        sg1 = (_rotr64(window[14], 19) ^ _rotr64(window[14], 61)
               ^ (window[14] >> 6))
        for col, v in ((BS0_LO, bsig0 & M32), (BS0_HI, bsig0 >> 32),
                       (BS1_LO, bsig1 & M32), (BS1_HI, bsig1 >> 32),
                       (CH_LO, ch & M32), (CH_HI, ch >> 32),
                       (MJ_LO, maj & M32), (MJ_HI, maj >> 32),
                       (SG0_LO, sg0 & M32), (SG0_HI, sg0 >> 32),
                       (SG1_LO, sg1 & M32), (SG1_HI, sg1 >> 32)):
            cols[col, row] = v
