"""Poseidon permutation AIR — proving hash chains inside our STARK.

The first cryptographic statement proven by the framework's own proof
system: ``out = Poseidon^k(in)`` (an iterated permutation chain). This is
the in-circuit hash that Merkle-path and Fiat-Shamir transcript
verification inside a proof build on.

Layout (68 columns, 32 rows per permutation — 30 rounds + 2 copy rows so
periods are a power of two):

  s[0..12)      state before the row's round
  x3[0..12)     (s_i + rc_i)^3        — S-box degree splitter
  x7[0..12)     x3_i^2 * (s_i + rc_i) — the full x^7
  ph[0..32)     one-hot phase register selecting the round (and its
                constants); rows 30/31 are copy rounds

All constraints have degree <= 3:
  - phase booleanity, rotation (ph'_i = ph_{i-1}), and sum-to-one
  - x3/x7 definitional constraints
  - state transition: next = copy ? s : MDS(sbox_blend(s + rc))
    where sbox_blend applies x^7 to all lanes in full rounds and to lane 0
    in partial rounds (selector flags are linear in the phase register)
  - boundaries: first row pins s = pub_in and ph = e_0; last row pins
    s = pub_out (the trailing copy rows make the final state a trace row)

Round constants / MDS come from hashes/poseidon.py — the SAME hash the
out-of-circuit Merkle commitments use, so a proven chain here is exactly a
statement about the framework's real digests.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..field import goldilocks as gl
from ..hashes import poseidon as ps
from .air import Air

WIDTH = ps.WIDTH          # 12
PERIOD = 32               # 30 rounds + 2 copy rows
NUM_COLS = 3 * WIDTH + PERIOD

_FULL = set(range(ps.FULL_ROUNDS // 2)) | set(
    range(ps.FULL_ROUNDS // 2 + ps.PARTIAL_ROUNDS, ps.N_ROUNDS))
_PARTIAL = set(range(ps.FULL_ROUNDS // 2,
                     ps.FULL_ROUNDS // 2 + ps.PARTIAL_ROUNDS))


def _col_s(i):
    return i


def _col_x3(i):
    return WIDTH + i


def _col_x7(i):
    return 2 * WIDTH + i


def _col_ph(r):
    return 3 * WIDTH + r


class PoseidonChainAir(Air):
    """publics: [in_0..in_11, out_0..out_11] (24 scalars)."""

    num_cols = NUM_COLS
    num_publics = 2 * WIDTH
    max_constraint_degree = 3

    def transition(self, alg, local, next_row, publics, consts=(), consts_next=()):
        rc = ps.round_constants()
        mds = ps.mds_matrix()
        cs = []

        ph = [local[_col_ph(r)] for r in range(PERIOD)]

        # phase register: boolean, rotating, sums to one
        for r in range(PERIOD):
            cs.append(alg.sub(alg.mul(ph[r], ph[r]), ph[r]))
        for r in range(PERIOD):
            cs.append(alg.sub(next_row[_col_ph(r)], ph[(r - 1) % PERIOD]))
        total = ph[0]
        for r in range(1, PERIOD):
            total = alg.add(total, ph[r])
        cs.append(alg.sub(total, alg.one()))

        # per-lane round constant as a linear blend of the phase register
        def rc_lane(i):
            acc = alg.zero()
            for r in range(ps.N_ROUNDS):
                acc = alg.add(acc, alg.mul(ph[r], alg.constant(rc[r][i])))
            return acc

        flag_full = alg.zero()
        for r in _FULL:
            flag_full = alg.add(flag_full, ph[r])
        flag_partial = alg.zero()
        for r in _PARTIAL:
            flag_partial = alg.add(flag_partial, ph[r])
        flag_copy = alg.add(ph[30], ph[31])

        t = [alg.add(local[_col_s(i)], rc_lane(i)) for i in range(WIDTH)]

        # S-box splitters
        for i in range(WIDTH):
            t2 = alg.mul(t[i], t[i])
            cs.append(alg.sub(local[_col_x3(i)], alg.mul(t2, t[i])))
            x3 = local[_col_x3(i)]
            cs.append(alg.sub(local[_col_x7(i)],
                              alg.mul(alg.mul(x3, x3), t[i])))

        # blended S-box output per lane (degree 2)
        sb = []
        for i in range(WIDTH):
            full_part = alg.mul(flag_full, local[_col_x7(i)])
            if i == 0:
                part_part = alg.mul(flag_partial, local[_col_x7(0)])
            else:
                part_part = alg.mul(flag_partial, t[i])
            sb.append(alg.add(full_part, part_part))

        # state transition: next = copy ? s : MDS(sb)  (degree <= 3)
        one = alg.one()
        not_copy = alg.sub(one, flag_copy)
        for i in range(WIDTH):
            mds_out = alg.zero()
            for j in range(WIDTH):
                mds_out = alg.add(mds_out, alg.mul(alg.constant(mds[i][j]), sb[j]))
            expect = alg.add(alg.mul(flag_copy, local[_col_s(i)]),
                             alg.mul(not_copy, mds_out))
            cs.append(alg.sub(next_row[_col_s(i)], expect))

        return cs

    def first_row(self, alg, local, publics, consts=()):
        cs = []
        for i in range(WIDTH):
            cs.append(alg.sub(local[_col_s(i)], alg.lift(publics[i])))
        cs.append(alg.sub(local[_col_ph(0)], alg.one()))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        return [alg.sub(local[_col_s(i)], alg.lift(publics[WIDTH + i]))
                for i in range(WIDTH)]

    # ------------------------------------------------------------------
    # Witness generation (host side, exact ints)
    # ------------------------------------------------------------------

    @staticmethod
    def make_trace(input_state: List[int], num_perms: int, device=None):
        """-> ((NUM_COLS, 32*num_perms) trace on ``device``, publics[24],
        final_state)."""
        P = gl.MODULUS
        rc = ps.round_constants()
        mds = ps.mds_matrix()
        n_rows = PERIOD * num_perms
        cols = np.zeros((NUM_COLS, n_rows), dtype=np.object_)

        s = [x % P for x in input_state]
        assert len(s) == WIDTH
        row = 0
        for _ in range(num_perms):
            for r in range(PERIOD):
                for i in range(WIDTH):
                    cols[_col_s(i), row] = s[i]
                cols[_col_ph(r), row] = 1
                if r < ps.N_ROUNDS:
                    t = [(s[i] + rc[r][i]) % P for i in range(WIDTH)]
                    x3 = [pow(ti, 3, P) for ti in t]
                    x7 = [(x3[i] * x3[i] % P) * t[i] % P for i in range(WIDTH)]
                    for i in range(WIDTH):
                        cols[_col_x3(i), row] = x3[i]
                        cols[_col_x7(i), row] = x7[i]
                    if r in _FULL:
                        sb = x7
                    else:
                        sb = [x7[0]] + t[1:]
                    s = [sum(mds[i][j] * sb[j] for j in range(WIDTH)) % P
                         for i in range(WIDTH)]
                else:
                    # copy rows: x3/x7 witnesses for t = s (rc = 0)
                    for i in range(WIDTH):
                        cols[_col_x3(i), row] = pow(s[i], 3, P)
                        cols[_col_x7(i), row] = pow(s[i], 7, P)
                row += 1

        trace = gl.to_fp(cols, device)
        publics = [x % P for x in input_state] + list(s)
        return trace, publics, s
