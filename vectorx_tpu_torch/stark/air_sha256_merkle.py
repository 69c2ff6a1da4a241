"""Simple-Merkle SHA-256 AIR — proving the range commitments in-STARK.

Proves ``root = simple_merkle_root(leaves)`` with the exact semantics of
VectorX's range commitments: unhashed 32-byte leaves zero-padded to a
power of two, SHA-256 internal nodes (the in-circuit
`get_root_from_hashed_leaves`; host/device mirrors in
circuits/commitments.py).

Every internal node is one sha256 of a 64-byte message (left||right) =
two 128-row compression blocks, laid out in DFS POST-ORDER so the tree
wiring is a register file of log2(n_leaves) stack slots: completing a
node's hash pushes its digest into a statically-scheduled slot; a parent
hash's message binds to the two slots holding its children. All wiring
selectors are PUBLIC CONSTANT columns (the traversal is static for a
given tree size); leaf words ride in instance-dependent constant columns
(the leaves are public inputs — the verifier rebuilds those columns from
the same instance).

Publics: leaf words (n_leaves*8) | root words (8).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..field import goldilocks as gl
from .air_sha256 import (NUM_COLS as BASE_COLS, N_ROWS, _K,
                         W, FF, fill_block)
from .air_sha256_chain import Sha256MultiBlockBase, IV, PAD64

IS = BASE_COLS           # 8 input-state value columns


def _post_order(n_leaves: int):
    """Static DFS post-order schedule.

    Returns a list of hash jobs: ("bot", leaf_pair_index, push_slot) or
    ("int", left_slot, right_slot, push_slot)."""
    jobs = []
    stack = []  # (level,) — slot s holds stack[s]
    for i in range(n_leaves // 2):
        jobs.append(("bot", i, len(stack)))
        stack.append(1)
        while len(stack) >= 2 and stack[-1] == stack[-2]:
            lvl = stack[-1]
            jobs.append(("int", len(stack) - 2, len(stack) - 1,
                         len(stack) - 2))
            stack.pop()
            stack.pop()
            stack.append(lvl + 1)
    assert len(stack) == 1
    return jobs


class MerkleSha256Air(Sha256MultiBlockBase):
    """publics: leaves (n_leaves*8 words) | root (8 words)."""

    max_constraint_degree = 3

    def __init__(self, leaves_words: Sequence[Sequence[int]]):
        """leaves_words: (n_leaves, 8) u32 BE words; n_leaves a power of 2,
        >= 2 (zero-pad upstream per range_commitments semantics)."""
        n = len(leaves_words)
        assert n >= 2 and n & (n - 1) == 0
        self.n_leaves = n
        self.k = n.bit_length() - 1       # tree depth; stack slots
        self.leaves = [[int(w) & 0xFFFFFFFF for w in row]
                       for row in leaves_words]
        self.jobs = _post_order(n)
        real_blocks = 2 * len(self.jobs)
        nb = 1
        while nb < real_blocks + 1:
            nb <<= 1
        self.num_blocks = nb
        self.n_rows = nb * N_ROWS
        self.num_cols = IS + 8 + 8 * self.k   # base + IS + stack slots
        self.num_publics = 8 * n + 8

    def _stk(self, s):
        return IS + 8 + 8 * s

    # consts layout:
    # 0 K, 1 IS_ROUND, 2 IS_SCHED, 3 B_LAST, 4 B_CONT, 5 B_START,
    # 6 NOT_LAST, 7 COPY_SEL, 8..8+16 MSGC (leaf-pair message words),
    # then WSEL[k], LSEL[k], RSEL[k]
    def constant_columns(self, n_rows: int):
        k = self.k
        base = 8
        n_consts = base + 16 + 3 * k
        out = np.zeros((n_consts, n_rows), dtype=np.uint64)
        if n_rows != self.n_rows:     # shape-only probe (Air.num_constraints)
            return out
        nb = self.num_blocks
        jobs = self.jobs
        for blk in range(nb):
            r0 = blk * N_ROWS
            for r in range(64):
                out[0, r0 + r] = _K[r]
                out[1, r0 + r] = 1
            for r in range(48):
                out[2, r0 + r] = 1
            rb = r0 + N_ROWS - 1
            out[3, rb] = 1                          # B_LAST
            nxt = blk + 1
            if nxt < nb:
                if nxt < 2 * len(jobs) and nxt % 2 == 1:
                    out[4, rb] = 1                  # B_CONT (pad block next)
                else:
                    out[5, rb] = 1                  # B_START
            # hash h ends at block 2h+1; wire push + next message binding
            if blk % 2 == 1 and blk // 2 < len(jobs):
                h = blk // 2
                push = jobs[h][2] if jobs[h][0] == "bot" else jobs[h][3]
                out[base + 16 + push, rb] = 1       # WSEL[push]
                if h + 1 < len(jobs):
                    nxt_job = jobs[h + 1]
                    if nxt_job[0] == "bot":
                        pair = self.leaves[2 * nxt_job[1]] + \
                            self.leaves[2 * nxt_job[1] + 1]
                        for j in range(16):
                            out[base + j, rb] = pair[j]
                    else:
                        out[base + 16 + k + nxt_job[1], rb] = 1   # LSEL
                        out[base + 16 + 2 * k + nxt_job[2], rb] = 1  # RSEL
        # first block's message (first bottom hash) binds at row 0
        pair0 = self.leaves[0] + self.leaves[1]
        for j in range(16):
            out[base + j, 0] = pair0[j]
        out[6] = 1 - out[3]                         # NOT_LAST
        out[7] = (1 - out[1]) * out[6]              # COPY_SEL
        return out

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        k = self.k
        (k_val, is_round, is_sched, b_last, b_cont, b_start,
         not_last, copy_sel) = consts[:8]
        msgc = consts[8:24]
        wsel = consts[24:24 + k]
        lsel = consts[24 + k:24 + 2 * k]
        rsel = consts[24 + 2 * k:24 + 3 * k]
        one = alg.one()
        St = self._stack
        two32 = alg.constant(1 << 32)

        cs, svals, next_svals = self._compression_constraints(
            alg, local, next_row, k_val, is_round, is_sched, not_last,
            copy_sel)

        ffwd = [alg.sub(alg.add(local[IS + j], svals[j]),
                        alg.mul(local[FF + j], two32)) for j in range(8)]

        # next block working vars = next input state
        cs.append(alg.mul(b_last, St([alg.sub(next_svals[j],
                                              next_row[IS + j])
                                      for j in range(8)])))
        # IS: continuation -> feed-forward; new hash -> IV; else copy
        cs.append(St([alg.sub(next_row[IS + j],
                              alg.add(alg.add(alg.mul(b_cont, ffwd[j]),
                                              alg.mul(b_start,
                                                      alg.constant(IV[j]))),
                                      alg.mul(not_last, local[IS + j])))
                      for j in range(8)]))
        # pad-block message
        cs.append(alg.mul(b_cont, St([alg.sub(next_row[W + j],
                                              alg.constant(PAD64[j]))
                                      for j in range(16)])))

        # stack pushes: next_STK[s] = WSEL_s ? ffwd : STK[s]
        stk_cs = []
        for s in range(k):
            for j in range(8):
                stk_cs.append(alg.sub(
                    next_row[self._stk(s) + j],
                    alg.add(alg.mul(wsel[s], ffwd[j]),
                            alg.mul(alg.sub(one, wsel[s]),
                                    local[self._stk(s) + j]))))
        cs.append(St(stk_cs))

        # message binding of the next hash's first block:
        #  internal hashes (LSEL/RSEL nonzero): children from the
        #  post-push stack slots;
        #  bottom hashes and noop blocks: leaf words from MSGC (zeros
        #  for noops)
        b_int = alg.zero()
        for s in range(k):
            b_int = alg.add(b_int, lsel[s])
        b_bot = alg.sub(b_start, b_int)
        msg_int, msg_bot = [], []
        for j in range(16):
            sels = lsel if j < 8 else rsel
            sel_read = alg.zero()
            for s in range(k):
                sel_read = alg.add(sel_read,
                                   alg.mul(sels[s],
                                           next_row[self._stk(s) + (j % 8)]))
            msg_int.append(alg.sub(alg.mul(b_int, next_row[W + j]),
                                   sel_read))
            msg_bot.append(alg.mul(b_bot, alg.sub(next_row[W + j],
                                                  msgc[j])))
        cs.append(St(msg_int))
        cs.append(St(msg_bot))
        return cs

    def first_row(self, alg, local, publics, consts=()):
        from .air_sha256 import A, B, C, E, F, G, D_VAL, H_VAL
        msgc = consts[8:24]
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
        cs.append(St([alg.sub(local[W + j], msgc[j]) for j in range(16)]))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        n8 = 8 * self.n_leaves
        return [self._stack([alg.sub(local[self._stk(0) + j],
                                     alg.lift(publics[n8 + j]))
                             for j in range(8)])]

    # ------------------------------------------------------------------
    # Witness generation
    # ------------------------------------------------------------------

    def make_trace(self, device=None):
        """-> ((num_cols, n_rows) trace on ``device``, publics, root[8])."""
        cols = np.zeros((self.num_cols, self.n_rows), dtype=np.uint64)
        stack_vals = [[0] * 8 for _ in range(self.k)]
        blk = 0

        def put_meta(b, is_words):
            r0, r1 = b * N_ROWS, (b + 1) * N_ROWS
            for j in range(8):
                cols[IS + j, r0:r1] = is_words[j]
            for s in range(self.k):
                for j in range(8):
                    cols[self._stk(s) + j, r0:r1] = stack_vals[s][j]

        for job in self.jobs:
            if job[0] == "bot":
                left = self.leaves[2 * job[1]]
                right = self.leaves[2 * job[1] + 1]
                push = job[2]
            else:
                left = stack_vals[job[1]]
                right = stack_vals[job[2]]
                push = job[3]
            msg = list(left) + list(right)
            put_meta(blk, IV)
            mid, _ = fill_block(cols, blk * N_ROWS, IV, msg)
            blk += 1
            put_meta(blk, mid)
            d, _ = fill_block(cols, blk * N_ROWS, mid, PAD64)
            blk += 1
            # the push lands at the boundary INTO the next block: put_meta
            # above wrote the pre-push values for the two blocks just filled
            stack_vals[push] = d

        noop_msg = [0] * 16
        while blk < self.num_blocks:
            put_meta(blk, IV)
            fill_block(cols, blk * N_ROWS, IV, noop_msg)
            blk += 1

        root = stack_vals[0]
        publics = [w for row in self.leaves for w in row] + list(root)
        return gl.to_fp(cols, device), publics, root
