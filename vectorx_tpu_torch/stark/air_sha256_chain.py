"""Chained SHA-256 AIR — the authority-set commitment, proven in-STARK.

Proves ``out = chained_sha256(pubkeys, num_active)`` with the exact
semantics of VectorX's `compute_authority_set_commitment` and the
host/device mirrors in circuits/commitments.py: h_0 = sha256(pk_0);
h_i = sha256(h_{i-1}||pk_i); only the first `num_active` steps update the
chain (select-masking).

The pubkeys are PRIVATE witnesses; publics are only [num_active, out_digest_words[8]] — the statement is
"I know 300 pubkeys whose masked chained hash is the trusted commitment".

Trace layout: ``num_blocks`` 128-row compression blocks laid end to end.
Block schedule (static per MAX_AUTHORITIES = n_max config):

  block 0                : hash 0  = sha256(pk_0)            (1 block, final)
  blocks 2i-1, 2i (i>=1) : hash i  = sha256(chain || pk_i)   (2 blocks)
  remaining blocks       : noop pad (IV-start, never final)

Columns = the single-block compression layout (air_sha256.py) plus:
  IS[8]   input state of the current block (held constant within a block)
  CHN[8]  chain register: masked h_{i-1} (updates at hash-final boundaries)
  ACT     per-hash active flag (boolean, non-increasing across hash starts)
  CNT     running count of active hashes (last row == num_active public)

All block wiring lives at boundary rows (r % 128 == 127) as transition
constraints gated by PUBLIC CONSTANT selector columns — the verifier
evaluates the (static) block schedule itself; nothing dynamic is committed
except ACT/CNT, whose consistency with `num_active` is enforced by
boolean/monotone/count constraints. Max constraint degree 3.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..field import goldilocks as gl
from .air_sha256 import (
    Sha256CompressAir, fill_block, NUM_COLS as BASE_COLS, N_ROWS, _K,
    A, B, C, E, F, G, D_VAL, H_VAL, W, FF)

IS = BASE_COLS            # 8 input-state value columns
CHN = BASE_COLS + 8       # 8 chain-register value columns
ACT = BASE_COLS + 16
CNT = BASE_COLS + 17
NUM_COLS = BASE_COLS + 18

IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

# padding block of a 64-byte message (second block of each chained hash)
PAD64 = [0x80000000] + [0] * 14 + [512]
# padding words 8..15 of a 32-byte message (hash 0 / noop blocks)
PAD32_TAIL = [0x80000000] + [0] * 6 + [256]


def num_blocks_for(n_max: int) -> int:
    """Real blocks = 2*n_max - 1; +1 noop so the final chain value lands on
    a row; round up to a power of two (the trace must be pow2-sized)."""
    need = 2 * n_max  # (2*n_max - 1) real + >=1 noop
    p = 1
    while p < need:
        p <<= 1
    return p


class Sha256MultiBlockBase(Sha256CompressAir):
    """Shared compression constraints for multi-block SHA-256 AIRs.

    Subclasses lay out extra registers and the block wiring; the
    per-round compression logic (masked at block boundaries) is common.
    `_compression_constraints` returns (constraints, ffwd, next_svals):
    ffwd[j] = feed-forward digest word expressions at boundary rows,
    next_svals[j] = next-row working-variable value expressions.
    """

    def _compression_constraints(self, alg, local, next_row, k_val,
                                 is_round, is_sched, not_last, copy_sel,
                                 extra_bool_cols=()):
        cs = []
        one = alg.one()
        St = self._stack
        from .air_sha256 import W1B, W14B, CA, CE, CW, SIG0, SIG1, BSIG0, \
            BSIG1, CH, MAJ

        def bits_g(base, row=local):
            return St([row[base + i] for i in range(32)])

        a, b, c = bits_g(A), bits_g(B), bits_g(C)
        e, f, g = bits_g(E), bits_g(F), bits_g(G)
        w1b, w14b = bits_g(W1B), bits_g(W14B)
        carries = St([local[CA], local[CA + 1], local[CA + 2],
                      local[CE], local[CE + 1], local[CE + 2],
                      local[CW], local[CW + 1]]
                     + [local[FF + i] for i in range(8)]
                     + [local[i] for i in extra_bool_cols])

        for fam in (a, b, c, e, f, g, w1b, w14b, carries):
            cs.append(alg.sub(alg.mul(fam, fam), fam))

        cs.append(alg.sub(self._val_g(alg, w1b), local[W + 1]))
        cs.append(alg.sub(self._val_g(alg, w14b), local[W + 14]))

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
        shr3 = self._mask0(R(w1b, -3), [i <= 28 for i in range(32)])
        sig0 = self._xor3_g(alg, R(w1b, -7), R(w1b, -18), shr3)
        cs.append(alg.sub(local[SIG0], self._val_g(alg, sig0)))
        shr10 = self._mask0(R(w14b, -10), [i <= 21 for i in range(32)])
        sig1 = self._xor3_g(alg, R(w14b, -17), R(w14b, -19), shr10)
        cs.append(alg.sub(local[SIG1], self._val_g(alg, sig1)))

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

        na, ne = bits_g(A, next_row), bits_g(E, next_row)
        cs.append(alg.mul(copy_sel, alg.sub(na, a)))
        cs.append(alg.mul(copy_sel, alg.sub(ne, e)))

        for dst, rot_src, cp_src in ((B, a, b), (C, b, c), (F, e, f),
                                     (G, f, g)):
            nd = bits_g(dst, next_row)
            cs.append(alg.sub(alg.mul(not_last, nd),
                              alg.add(alg.mul(is_round, rot_src),
                                      alg.mul(copy_sel, cp_src))))

        cs.append(alg.sub(alg.mul(not_last, next_row[D_VAL]),
                          alg.add(alg.mul(is_round, self._val_g(alg, c)),
                                  alg.mul(copy_sel, local[D_VAL]))))
        cs.append(alg.sub(alg.mul(not_last, next_row[H_VAL]),
                          alg.add(alg.mul(is_round, self._val_g(alg, g)),
                                  alg.mul(copy_sel, local[H_VAL]))))

        w_hi = St([local[W + j + 1] for j in range(15)])
        nw_lo = St([next_row[W + j] for j in range(15)])
        cs.append(alg.mul(is_round, alg.sub(nw_lo, w_hi)))
        carry_w = self._val3(alg, [local[CW], local[CW + 1]])
        sched_sum = alg.add(alg.add(local[W + 0], local[SIG0]),
                            alg.add(local[W + 9], local[SIG1]))
        cs.append(alg.mul(is_sched, alg.sub(
            alg.add(next_row[W + 15], alg.mul(carry_w, two32)), sched_sum)))

        svals = [self._val_g(alg, a), self._val_g(alg, b),
                 self._val_g(alg, c), local[D_VAL],
                 self._val_g(alg, e), self._val_g(alg, f),
                 self._val_g(alg, g), local[H_VAL]]
        next_svals = [self._val_g(alg, bits_g(A, next_row)),
                      self._val_g(alg, bits_g(B, next_row)),
                      self._val_g(alg, bits_g(C, next_row)),
                      next_row[D_VAL],
                      self._val_g(alg, bits_g(E, next_row)),
                      self._val_g(alg, bits_g(F, next_row)),
                      self._val_g(alg, bits_g(G, next_row)),
                      next_row[H_VAL]]
        return cs, svals, next_svals


class ChainedSha256Air(Sha256MultiBlockBase):
    """publics: [num_active, out_0..out_7] (9 scalars)."""

    max_constraint_degree = 3
    num_publics = 9

    def __init__(self, n_max: int):
        self.n_max = n_max
        self.num_blocks = num_blocks_for(n_max)
        self.n_rows = self.num_blocks * N_ROWS

    num_cols = NUM_COLS

    # consts: [K_VAL, IS_ROUND, IS_SCHED, B_LAST, B_CONT, B_CHAIN, B_START,
    #          B_FINAL, NOT_LAST, COPY_SEL]
    def constant_columns(self, n_rows: int):
        if n_rows != self.n_rows:     # shape-only probe (Air.num_constraints)
            return np.zeros((10, n_rows), dtype=np.uint64)
        nb = self.num_blocks
        out = np.zeros((10, n_rows), dtype=np.uint64)
        last_real = 2 * (self.n_max - 1)          # index of last real block
        for b in range(nb):
            r0 = b * N_ROWS
            for r in range(64):
                out[0, r0 + r] = _K[r]
                out[1, r0 + r] = 1
            for r in range(48):
                out[2, r0 + r] = 1
            rb = r0 + N_ROWS - 1                  # boundary row
            out[3, rb] = 1                        # B_LAST
            nxt = b + 1
            if nxt < nb:
                if nxt <= last_real and nxt % 2 == 1:
                    out[5, rb] = 1                # B_CHAIN: next starts hash i>=1
                    out[6, rb] = 1                # B_START
                elif nxt <= last_real:
                    out[4, rb] = 1                # B_CONT: next is pad block
                else:
                    out[6, rb] = 1                # B_START: noop start
            # B_FINAL: this block ends a real hash
            if b == 0 or (b <= last_real and b % 2 == 0):
                out[7, rb] = 1
        out[8] = 1 - out[3]                       # NOT_LAST
        # COPY_SEL = not_round & not_last
        out[9] = (1 - out[1]) * out[8]
        return out

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        (k_val, is_round, is_sched, b_last, b_cont, b_chain, b_start,
         b_final, not_last, copy_sel) = consts
        one = alg.one()
        St = self._stack
        two32 = alg.constant(1 << 32)

        cs, svals, next_svals = self._compression_constraints(
            alg, local, next_row, k_val, is_round, is_sched, not_last,
            copy_sel, extra_bool_cols=(ACT,))

        # ------------------------------------------------------------------
        # block wiring (boundary rows)
        # ------------------------------------------------------------------
        # feed-forward digest words at the boundary: d_j = IS_j + s_j - FF_j*2^32
        ffwd = [alg.sub(alg.add(local[IS + j], svals[j]),
                        alg.mul(local[FF + j], two32)) for j in range(8)]

        # next block's working vars start at next block's input state
        cs.append(alg.mul(b_last, St([alg.sub(next_svals[j],
                                              next_row[IS + j])
                                      for j in range(8)])))

        # next input state: continuation -> feed-forward; new hash -> IV;
        # within a block -> copy
        cs.append(St([alg.sub(next_row[IS + j],
                              alg.add(alg.add(alg.mul(b_cont, ffwd[j]),
                                              alg.mul(b_start,
                                                      alg.constant(IV[j]))),
                                      alg.mul(not_last, local[IS + j])))
                      for j in range(8)]))

        # message binding of the next block
        cs.append(alg.mul(b_cont, St([alg.sub(next_row[W + j],
                                              alg.constant(PAD64[j]))
                                      for j in range(16)])))
        cs.append(alg.mul(b_chain, St([alg.sub(next_row[W + j],
                                               next_row[CHN + j])
                                       for j in range(8)])))

        # chain register: update at hash-final boundaries, else copy
        act = local[ACT]
        cs.append(St([alg.sub(alg.sub(next_row[CHN + j], local[CHN + j]),
                              alg.mul(b_final,
                                      alg.mul(act, alg.sub(ffwd[j],
                                                           local[CHN + j]))))
                      for j in range(8)]))

        # ACT: constant within a hash; non-increasing at hash starts
        nact = next_row[ACT]
        cs.append(alg.mul(not_last, alg.sub(nact, act)))
        cs.append(alg.mul(b_cont, alg.sub(nact, act)))
        cs.append(alg.mul(b_start, alg.mul(nact, alg.sub(one, act))))

        # CNT: count the ACT flag of each newly started hash
        cs.append(alg.sub(alg.sub(next_row[CNT], local[CNT]),
                          alg.mul(b_start, nact)))

        return cs

    def first_row(self, alg, local, publics, consts=()):
        cs = []
        St = self._stack
        for j, base in enumerate((A, B, C, None, E, F, G, None)):
            if base is None:
                col = D_VAL if j == 3 else H_VAL
                cs.append(alg.sub(local[col], alg.constant(IV[j])))
            else:
                bits = St([local[base + i] for i in range(32)])
                cs.append(alg.sub(self._val_g(alg, bits),
                                  alg.constant(IV[j])))
        cs.append(St([alg.sub(local[IS + j], alg.constant(IV[j]))
                      for j in range(8)]))
        # hash 0 message: pk_0 (words 0..7 free) || 32-byte padding tail
        cs.append(St([alg.sub(local[W + 8 + j], alg.constant(PAD32_TAIL[j]))
                      for j in range(8)]))
        cs.append(St([local[CHN + j] for j in range(8)]))
        cs.append(alg.sub(local[CNT], local[ACT]))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        cs = [alg.sub(local[CNT], alg.lift(publics[0]))]
        cs.append(self._stack([alg.sub(local[CHN + j],
                                       alg.lift(publics[1 + j]))
                               for j in range(8)]))
        return cs

    # ------------------------------------------------------------------
    # Witness generation (host side, exact ints in uint64)
    # ------------------------------------------------------------------

    def make_trace(self, pubkey_words: Sequence[Sequence[int]],
                   num_active: int, device=None):
        """pubkey_words: (n_max, 8) u32 BE words per key (zero-padded).
        -> ((NUM_COLS, n_rows) trace on ``device``, publics[9],
        out_words[8])."""
        n_max, nb = self.n_max, self.num_blocks
        assert len(pubkey_words) == n_max and 0 <= num_active <= n_max
        cols = np.zeros((NUM_COLS, self.n_rows), dtype=np.uint64)

        chain = [0] * 8
        blk = 0

        def put_meta(b, is_words, act, cnt, chn):
            r0, r1 = b * N_ROWS, (b + 1) * N_ROWS
            for j in range(8):
                cols[IS + j, r0:r1] = is_words[j]
                cols[CHN + j, r0:r1] = chn[j]
            cols[ACT, r0:r1] = act
            cols[CNT, r0:r1] = cnt

        cnt = 0
        # hash 0: sha256(pk_0) — one block
        act0 = 1 if 0 < num_active else 0
        cnt += act0
        msg = list(pubkey_words[0]) + PAD32_TAIL
        put_meta(0, IV, act0, cnt, chain)
        d, _ = fill_block(cols, 0, IV, msg)
        if act0:
            chain = d
        blk = 1

        for i in range(1, n_max):
            acti = 1 if i < num_active else 0
            cnt += acti
            msg = list(chain) + list(pubkey_words[i])
            put_meta(blk, IV, acti, cnt, chain)
            mid, _ = fill_block(cols, blk * N_ROWS, IV, msg)
            blk += 1
            put_meta(blk, mid, acti, cnt, chain)
            d, _ = fill_block(cols, blk * N_ROWS, mid, PAD64)
            blk += 1
            if acti:
                chain = d

        # noop pad blocks: sha256 of a zero 32-byte message from IV
        noop_msg = [0] * 8 + PAD32_TAIL
        while blk < nb:
            put_meta(blk, IV, 0, cnt, chain)
            fill_block(cols, blk * N_ROWS, IV, noop_msg)
            blk += 1

        out = chain if num_active > 0 else [0] * 8
        trace = gl.to_fp(cols, device)
        publics = [num_active] + list(out)
        return trace, publics, out

    @staticmethod
    def pubkeys_to_words(pubkeys: Sequence[bytes], n_max: int):
        """32-byte keys -> (n_max, 8) BE words, zero-padded."""
        rows = []
        for pk in list(pubkeys)[:n_max]:
            assert len(pk) == 32
            rows.append([int.from_bytes(pk[4 * i:4 * i + 4], "big")
                         for i in range(8)])
        while len(rows) < n_max:
            rows.append([0] * 8)
        return rows
