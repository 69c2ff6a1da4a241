"""SHA-256 compression AIR — proving the commitment hash in-circuit.

Proves ``out_state = sha256_compress(in_state, msg_block)`` — the primitive
behind every public commitment the chain checks (authority-set hash chain,
simple-Merkle range roots). One 64-round compression occupies rows
0..63 of a 128-row trace (rows 64..127 carry the copied final state so the
feed-forward lands on the last row).

Representation: working variables a,b,c,e,f,g live as 32 bit-columns each
(bitwise Σ/σ/ch/maj become degree<=3 polynomial identities); d and h are
value columns (they are only ever added); the 16-word message-schedule
window rides along as value columns with two bit-decomposed taps (w[1],
w[14]) for the σ functions. Round constants K_r and the round/schedule
selectors are PUBLIC CONSTANT columns (Air.constant_columns) — known to
the verifier, committed once into the verifying key.

Publics (32): in_state[8] | msg[16] | out_state[8].
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from .air import Air

# --- column layout ----------------------------------------------------------
A, B, C, E, F, G = 0, 32, 64, 96, 128, 160
D_VAL, H_VAL = 192, 193
W = 194                  # 16 window value columns
W1B, W14B = 210, 242     # 32 bit columns each
SIG0, SIG1, BSIG0, BSIG1, CH, MAJ = 274, 275, 276, 277, 278, 279
CA, CE, CW, FF = 280, 283, 286, 288
NUM_COLS = 296

N_ROWS = 128

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_IV_LIKE_ORDER = "abcdefgh"  # state order used in publics


class Sha256CompressAir(Air):
    num_cols = NUM_COLS
    num_publics = 32
    max_constraint_degree = 3

    # consts: [K_VAL, IS_ROUND, IS_SCHED]
    def constant_columns(self, n_rows: int):
        out = np.zeros((3, n_rows), dtype=np.uint64)
        for r in range(min(64, n_rows)):
            out[0, r] = _K[r]
            out[1, r] = 1
        for r in range(min(48, n_rows)):
            out[2, r] = 1
        return out

    # -- grouped tensor constraints ----------------------------------------
    # Bit families are stacked along a leading GROUP axis (32, ...): one
    # tensor expression = 32 constraints, each with its own α (see
    # prover._combine). Rotations become rolls of the group axis.

    @staticmethod
    def _stack(elems):
        from .air import stack_group
        return stack_group(elems)

    @staticmethod
    def _roll(e, k):
        from .air import roll_group
        return roll_group(e, k)

    @staticmethod
    def _mask0(e, keep):
        """Zero group rows where keep[i] is False."""
        from .air import _map

        def f(x):
            m = torch.tensor(keep, device=x.device).reshape(
                (len(keep),) + (1,) * (x.dim() - 1))
            return torch.where(m, x, torch.zeros_like(x))
        return _map(f, e)

    @staticmethod
    def _sum0(e, alg=None):
        from .air import sum_group
        return sum_group(e, alg)

    def _pw2(self, alg):
        return self._stack([alg.constant(1 << i) for i in range(32)])

    def _val_g(self, alg, bits_g):
        """Σ 2^i bits_i over the group axis."""
        return self._sum0(alg.mul(bits_g, self._pw2(alg)), alg)

    @staticmethod
    def _xor2_g(alg, x, y):
        return alg.sub(alg.add(x, y), alg.mul(alg.constant(2), alg.mul(x, y)))

    @staticmethod
    def _xor3_g(alg, x, y, z):
        sm = alg.add(alg.add(x, y), z)
        p = alg.add(alg.add(alg.mul(x, y), alg.mul(y, z)), alg.mul(z, x))
        out = alg.sub(sm, alg.mul(alg.constant(2), p))
        return alg.add(out, alg.mul(alg.constant(4), alg.mul(alg.mul(x, y), z)))

    def transition(self, alg, local, next_row, publics, consts=(), consts_next=()):
        k_val, is_round, is_sched = consts
        cs = []
        one = alg.one()
        not_round = alg.sub(one, is_round)
        St = self._stack

        def bits_g(base, row=local):
            return St([row[base + i] for i in range(32)])

        a, b, c = bits_g(A), bits_g(B), bits_g(C)
        e, f, g = bits_g(E), bits_g(F), bits_g(G)
        w1b, w14b = bits_g(W1B), bits_g(W14B)
        carries = St([local[CA], local[CA + 1], local[CA + 2],
                      local[CE], local[CE + 1], local[CE + 2],
                      local[CW], local[CW + 1]]
                     + [local[FF + i] for i in range(8)])

        # booleanity (one grouped constraint per family)
        for fam in (a, b, c, e, f, g, w1b, w14b, carries):
            cs.append(alg.sub(alg.mul(fam, fam), fam))

        # tap consistency
        cs.append(alg.sub(self._val_g(alg, w1b), local[W + 1]))
        cs.append(alg.sub(self._val_g(alg, w14b), local[W + 14]))

        # definitional value columns
        R = self._roll
        bsig1 = self._xor3_g(alg, R(e, -6), R(e, -11), R(e, -25))
        cs.append(alg.sub(local[BSIG1], self._val_g(alg, bsig1)))
        bsig0 = self._xor3_g(alg, R(a, -2), R(a, -13), R(a, -22))
        cs.append(alg.sub(local[BSIG0], self._val_g(alg, bsig0)))
        ch = alg.add(alg.mul(e, f), alg.mul(alg.sub(one, e), g))
        cs.append(alg.sub(local[CH], self._val_g(alg, ch)))
        maj = alg.sub(alg.add(alg.add(alg.mul(a, b), alg.mul(a, c)),
                              alg.mul(b, c)),
                      alg.mul(alg.constant(2), alg.mul(alg.mul(a, b), c)))
        cs.append(alg.sub(local[MAJ], self._val_g(alg, maj)))

        # σ0(w1): rotr7 ^ rotr18 ^ shr3  (shr masked: bit i valid for i<=28)
        shr3 = self._mask0(R(w1b, -3), [i <= 28 for i in range(32)])
        sig0 = self._xor3_g(alg, R(w1b, -7), R(w1b, -18), shr3)
        cs.append(alg.sub(local[SIG0], self._val_g(alg, sig0)))
        shr10 = self._mask0(R(w14b, -10), [i <= 21 for i in range(32)])
        sig1 = self._xor3_g(alg, R(w14b, -17), R(w14b, -19), shr10)
        cs.append(alg.sub(local[SIG1], self._val_g(alg, sig1)))

        # t1 / t2
        t1 = alg.add(alg.add(alg.add(local[H_VAL], local[BSIG1]),
                             alg.add(local[CH], k_val)), local[W + 0])
        t2 = alg.add(local[BSIG0], local[MAJ])
        two32 = alg.constant(1 << 32)
        carry_a = self._val3(alg, [local[CA + i] for i in range(3)])
        carry_e = self._val3(alg, [local[CE + i] for i in range(3)])

        next_a_val = self._val_g(alg, bits_g(A, next_row))
        next_e_val = self._val_g(alg, bits_g(E, next_row))
        cs.append(alg.mul(is_round, alg.sub(
            alg.add(next_a_val, alg.mul(carry_a, two32)), alg.add(t1, t2))))
        cs.append(alg.mul(is_round, alg.sub(
            alg.add(next_e_val, alg.mul(carry_e, two32)),
            alg.add(local[D_VAL], t1))))

        # a/e copy on pad rows (grouped)
        na, ne = bits_g(A, next_row), bits_g(E, next_row)
        cs.append(alg.mul(not_round, alg.sub(na, a)))
        cs.append(alg.mul(not_round, alg.sub(ne, e)))

        # b,c,f,g rotate/copy (grouped)
        for dst, rot_src, cp_src in ((B, a, b), (C, b, c), (F, e, f), (G, f, g)):
            nd = bits_g(dst, next_row)
            cs.append(alg.sub(nd, alg.add(alg.mul(is_round, rot_src),
                                          alg.mul(not_round, cp_src))))

        # d, h value updates
        cs.append(alg.sub(next_row[D_VAL],
                          alg.add(alg.mul(is_round, self._val_g(alg, c)),
                                  alg.mul(not_round, local[D_VAL]))))
        cs.append(alg.sub(next_row[H_VAL],
                          alg.add(alg.mul(is_round, self._val_g(alg, g)),
                                  alg.mul(not_round, local[H_VAL]))))

        # window shift (grouped over 15 positions)
        w_hi = St([local[W + j + 1] for j in range(15)])
        nw_lo = St([next_row[W + j] for j in range(15)])
        cs.append(alg.mul(is_round, alg.sub(nw_lo, w_hi)))

        # message schedule
        carry_w = self._val3(alg, [local[CW], local[CW + 1]])
        sched_sum = alg.add(alg.add(local[W + 0], local[SIG0]),
                            alg.add(local[W + 9], local[SIG1]))
        cs.append(alg.mul(is_sched, alg.sub(
            alg.add(next_row[W + 15], alg.mul(carry_w, two32)), sched_sum)))

        return cs

    @staticmethod
    def _val3(alg, bits):
        acc = alg.zero()
        for i, bb in enumerate(bits):
            acc = alg.add(acc, alg.mul(alg.constant(1 << i), bb))
        return acc

    def first_row(self, alg, local, publics, consts=()):
        cs = []
        St = self._stack
        for base, j in ((A, 0), (B, 1), (C, 2), (E, 4), (F, 5), (G, 6)):
            bits = St([local[base + i] for i in range(32)])
            cs.append(alg.sub(self._val_g(alg, bits), alg.lift(publics[j])))
        cs.append(alg.sub(local[D_VAL], alg.lift(publics[3])))
        cs.append(alg.sub(local[H_VAL], alg.lift(publics[7])))
        w_g = St([local[W + j] for j in range(16)])
        msg_g = St([alg.lift(publics[8 + j]) for j in range(16)])
        cs.append(alg.sub(w_g, msg_g))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        """Feed-forward digest: out_j = (in_j + state_j) mod 2^32."""
        cs = []
        two32 = alg.constant(1 << 32)
        St = self._stack
        vals = [
            self._val_g(alg, St([local[A + i] for i in range(32)])),
            self._val_g(alg, St([local[B + i] for i in range(32)])),
            self._val_g(alg, St([local[C + i] for i in range(32)])),
            local[D_VAL],
            self._val_g(alg, St([local[E + i] for i in range(32)])),
            self._val_g(alg, St([local[F + i] for i in range(32)])),
            self._val_g(alg, St([local[G + i] for i in range(32)])),
            local[H_VAL],
        ]
        for j in range(8):
            lhs = alg.add(vals[j], alg.lift(publics[j]))
            rhs = alg.add(alg.lift(publics[24 + j]),
                          alg.mul(local[FF + j], two32))
            cs.append(alg.sub(lhs, rhs))
        return cs

    # ------------------------------------------------------------------
    # Witness generation (exact ints)
    # ------------------------------------------------------------------

    @staticmethod
    def make_trace(state_in: List[int], msg_words: List[int], device=None):
        """-> ((NUM_COLS, 128) trace on ``device``, publics[32],
        state_out[8])."""
        assert len(state_in) == 8 and len(msg_words) == 16
        cols = np.zeros((NUM_COLS, N_ROWS), dtype=np.uint64)
        out, _ = fill_block(cols, 0, state_in, msg_words)
        trace = gl.to_fp(cols, device)
        publics = list(state_in) + list(msg_words) + out
        return trace, publics, out


def fill_block(cols, r0: int, state_in: List[int], msg_words: List[int]):
    """Fill one 128-row compression block's base columns at rows r0..r0+127.

    Returns (digest_words, final_working_state); writes the feed-forward
    carry bits at row r0+127 (the block-boundary row). All values fit in
    uint64 (bits, u32 values, <=2-bit carries).
    """
    M = (1 << 32) - 1

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M

    # schedule
    w = list(msg_words)
    for i in range(16, 64):
        s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M)
    w_ext = w + [0] * 16  # window tail beyond round 63 (unconstrained)

    a, b, c, d, e, f, g, h = state_in
    for rr in range(N_ROWS):
        r = r0 + rr
        is_round = rr < 64
        for i in range(32):
            cols[A + i, r] = (a >> i) & 1
            cols[B + i, r] = (b >> i) & 1
            cols[C + i, r] = (c >> i) & 1
            cols[E + i, r] = (e >> i) & 1
            cols[F + i, r] = (f >> i) & 1
            cols[G + i, r] = (g >> i) & 1
        cols[D_VAL, r] = d
        cols[H_VAL, r] = h

        if is_round:
            window = w_ext[rr:rr + 16]
        elif rr == 64:
            window = w_ext[64:64 + 15] + [0]
        else:
            window = [0] * 16
        for j in range(16):
            cols[W + j, r] = window[j]
        for i in range(32):
            cols[W1B + i, r] = (window[1] >> i) & 1
            cols[W14B + i, r] = (window[14] >> i) & 1

        bsig1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        bsig0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        ch = (e & f) ^ ((~e & M) & g)
        maj = (a & b) ^ (a & c) ^ (b & c)
        sig0 = rotr(window[1], 7) ^ rotr(window[1], 18) ^ (window[1] >> 3)
        sig1 = rotr(window[14], 17) ^ rotr(window[14], 19) ^ (window[14] >> 10)
        cols[BSIG1, r] = bsig1
        cols[BSIG0, r] = bsig0
        cols[CH, r] = ch
        cols[MAJ, r] = maj
        cols[SIG0, r] = sig0
        cols[SIG1, r] = sig1

        if is_round:
            k = _K[rr]
            t1 = h + bsig1 + ch + k + window[0]
            t2 = bsig0 + maj
            new_a_full = t1 + t2
            new_e_full = d + t1
            ca = new_a_full >> 32
            ce = new_e_full >> 32
            for i in range(3):
                cols[CA + i, r] = (ca >> i) & 1
                cols[CE + i, r] = (ce >> i) & 1
            if rr < 48:
                ssum = window[0] + sig0 + window[9] + sig1
                cw = ssum >> 32
                for i in range(2):
                    cols[CW + i, r] = (cw >> i) & 1
            h, g, f, e = g, f, e, (new_e_full & M)
            d, c, b, a = c, b, a, (new_a_full & M)

    # feed-forward carries at the block-boundary row
    out = []
    finals = [a, b, c, d, e, f, g, h]
    for j in range(8):
        s = finals[j] + state_in[j]
        out.append(s & M)
        cols[FF + j, r0 + N_ROWS - 1] = s >> 32
    return out, finals
