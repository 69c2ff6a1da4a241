"""Ed25519 EdDSA verification AIR — batched signatures proven in-STARK.

Statement proven per signature lane, all public data in verifier-evaluated
CONSTANT columns (never committed):

    given compressed A, compressed R, scalar s, challenge h:
        A and R decompress validly (on-curve, canonical x, sign bit), and
        [s]B − [h]A == R        (⟺ [s]B == R + [h]A, cofactorless)

h = SHA-512(R‖A‖M) mod L is public; its binding to the digest is proven by
the SHA-512 challenge AIR (stark/air_sha512.py) over the same lane tuples.

Trace layout: one signature per 256-row block over a 2^B-row trace
(B = limb bits = log2(n_rows), so the LogUp row-ramp table gives exactly
B-bit limb range checks; B=8 → 1 sig/trace, B=13 → 32 sigs).

  row 0        SETUP: decompress A; A' = −A; T3 = B + A' (affine-normalized
               via witnessed inverse); init acc ← identity
  rows 1..253  LADDER: one Strauss–Shamir step per row, MSB-first:
               acc ← 2·acc + table[bit_s, bit_h],
               table = {O, B, A', B+A'} (a=-1 twisted Edwards extended
               coordinates; dbl-2008-hwcd / add-2008-hwcd-3)
  row 254      FINAL: decompress R; projective equality acc == R with a
               witnessed-nonzero acc.Z
  row 255      idle (block separator; all selectors 0)

All field muls of a row live in ONE grouped MulBank family (gadget_vec),
so the whole AIR is ~30 grouped tensor constraints. The unified Edwards
formulas are complete on the odd-order subgroup; pubkeys with low-order
components may be unprovable — such keys can only forge their own lane's
vote, which their owner controls regardless.

The host helpers (point (de)compression on Python ints, the disabled-lane
filler) are shared with the SHA-512 challenge AIR.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

from ..circuits.ed25519 import D_CONST, L_ORDER, _BX, _BY, _recover_x
from ..field import goldilocks as gl
from .air import Air
from .gadget_vec import (AllocV, CanonBank, LinZeroBank, MulBank, P25519,
                         ints_to_limb_mat, lin, lin_limbs_int, limbs_top,
                         t_gather, t_stack, vconst)

P = P25519
BX, BY = _BX, _BY
BT = BX * BY % P
TWO_D = 2 * D_CONST % P

# constant-column indices
SEL_SETUP, SEL_LADDER, SEL_FINAL, SEL_DEC, SEL_CARRY = 0, 1, 2, 3, 4
C00, C01, C10, C11, SIGN = 5, 6, 7, 8, 9
CC_Y = 10                       # bank of L columns

ROWS_PER_SIG = 256
N_LADDER = 253


def decompress_host(comp: bytes) -> Tuple[int, int, int]:
    """Compressed 32B -> (x, y, sign); asserts validity (honest witness)."""
    v = int.from_bytes(comp, "little")
    y = v & ((1 << 255) - 1)
    sign = v >> 255
    assert y < P, "non-canonical y"
    x = _recover_x(y, sign)
    assert not (x == 0 and sign == 1)
    return x, y, sign


def compress_host(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def dummy_sig() -> Tuple[bytes, bytes, int, int]:
    """Disabled-lane filler satisfying the signature check unconditionally:
    [0]B == O + [0]B (VectorX pads with dummy keys/sigs the same way)."""
    a = compress_host(BX, BY)
    r = compress_host(0, 1)     # identity
    return (a, r, 0, 0)


def _cols_to_fp(cols: np.ndarray, device):
    """The non-negative int64 witness matrix -> trace on ``device``."""
    assert cols.min() >= 0, "negative witness cell"
    return gl.to_fp(cols.view(np.uint64), device)


class Ed25519VerifyAir(Air):
    """sigs: per-lane (a_bytes, r_bytes, s, h); padded to 2^(B-8) lanes."""

    max_constraint_degree = 3
    num_publics = 9

    def __init__(self, sigs: Sequence[Tuple[bytes, bytes, int, int]],
                 B: int = 8):
        assert B >= 8
        self.B = B
        self.L = -(-255 // B)
        self.n_rows = 1 << B
        self.n_sigs = 1 << (B - 8)
        assert len(sigs) <= self.n_sigs
        self.sigs = list(sigs) + [dummy_sig()] * (self.n_sigs - len(sigs))
        for a, r, s, h in self.sigs:
            assert 0 <= s < L_ORDER and 0 <= h < L_ORDER

        L, lim = self.L, (1 << B) - 1
        alloc = AllocV()
        self.xpt = alloc.take_np((L,))          # x being decompressed
        self.h0 = alloc.take_np((1,))           # parity half-limb
        self.xap = alloc.take_np((L,))          # carried: x(A'), t(A'), B+A'
        self.tap = alloc.take_np((L,))
        self.xt3 = alloc.take_np((L,))
        self.yt3 = alloc.take_np((L,))
        self.tt3 = alloc.take_np((L,))
        self.zi = alloc.take_np((L,))           # inverse witness
        self.xs = alloc.take_np((L,), looked=False)   # selected table point
        self.ys = alloc.take_np((L,), looked=False)
        self.ts = alloc.take_np((L,), looked=False)
        self.acc = alloc.take_np((4, L), looked=False)  # X, Y, Z, T
        self.vm = MulBank(alloc, B, 15, a_limb_max=1 << (B + 4),
                          b_limb_max=1 << (B + 4))
        self.cm = MulBank(alloc, B, 4, a_limb_max=1 << (B + 3),
                          b_limb_max=lim)
        self.lz = LinZeroBank(alloc, B, 5, s_limb_max=1 << (B + 3),
                              nk_bits=3, ofs=4)
        self.cb = CanonBank(alloc, B, 1)
        self.num_cols = alloc.n
        self._lookups = alloc.lookups
        self._lim = lim

    def lookup_range_columns(self):
        return self._lookups

    # -- public constant columns --------------------------------------------

    def constant_columns(self, n_rows: int):
        L, B = self.L, self.B
        out = np.zeros((CC_Y + L, n_rows), dtype=np.uint64)
        if n_rows != self.n_rows:      # shape-only probe (Air.num_constraints)
            return out
        for si, (a_bytes, r_bytes, s, h) in enumerate(self.sigs):
            b0 = si * ROWS_PER_SIG
            _, ya, sign_a = decompress_host(a_bytes)
            _, yr, sign_r = decompress_host(r_bytes)
            out[SEL_SETUP, b0] = 1
            out[SEL_DEC, b0] = 1
            out[SIGN, b0] = sign_a
            out[SEL_FINAL, b0 + 254] = 1
            out[SEL_DEC, b0 + 254] = 1
            out[SIGN, b0 + 254] = sign_r
            out[SEL_CARRY, b0:b0 + 253] = 1
            ya_l = [(ya >> (B * i)) & self._lim for i in range(L)]
            yr_l = [(yr >> (B * i)) & self._lim for i in range(L)]
            for i in range(L):
                out[CC_Y + i, b0:b0 + 254] = ya_l[i]
                out[CC_Y + i, b0 + 254] = yr_l[i]
            for j in range(1, N_LADDER + 1):
                bit = N_LADDER - j
                bs, bh = (s >> bit) & 1, (h >> bit) & 1
                r = b0 + j
                out[SEL_LADDER, r] = 1
                out[C00, r] = (1 - bs) * (1 - bh)
                out[C01, r] = bs * (1 - bh)
                out[C10, r] = (1 - bs) * bh
                out[C11, r] = bs * bh
        return out

    def phase_cache_key(self):
        """All lane data flows through constant_columns/make_trace; the
        constraint program depends only on B, so shards of one B share
        whatever a caller caches under this key."""
        return (type(self).__name__, self.B)

    def publics_list(self) -> List[int]:
        """[n_sigs] + 8×32-bit words of SHA-256 over the lane data (binds
        the per-lane statement into the Fiat–Shamir transcript)."""
        hsh = hashlib.sha256()
        for a, r, s, h in self.sigs:
            hsh.update(a + r + int(s).to_bytes(32, "little")
                       + int(h).to_bytes(32, "little"))
        d = hsh.digest()
        return [self.n_sigs] + [int.from_bytes(d[4 * i:4 * i + 4], "big")
                                for i in range(8)]

    # -- constraints ----------------------------------------------------------

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        B, L, lim = self.B, self.L, self._lim
        sel_setup, sel_ladder = consts[SEL_SETUP], consts[SEL_LADDER]
        sel_final, sel_dec = consts[SEL_FINAL], consts[SEL_DEC]
        sel_carry = consts[SEL_CARRY]
        ccy = t_stack([consts[CC_Y + i] for i in range(L)])   # (L, ...)
        # stack the trace once; every gather below is one tensor index
        st = t_stack(local)
        stn = t_stack(next_row)
        xpt = t_gather(st, self.xpt)
        xap = t_gather(st, self.xap)
        zi = t_gather(st, self.zi)
        xs = t_gather(st, self.xs)
        ys = t_gather(st, self.ys)
        ts = t_gather(st, self.ts)
        ax = t_gather(st, self.acc[0])
        ay = t_gather(st, self.acc[1])
        az = t_gather(st, self.acc[2])

        def cl(m):
            return self.vm.c_lin(st, m)

        def cv(m):
            return self.vm.c_inst(st, m)

        def cmv(m):
            return self.cm.c_inst(st, m)

        def pl(e):
            return lin([(1, e)], limb_max=lim)

        cs = []

        # ---- decompression suite (setup AND final rows, SEL_DEC) ----------
        cs += self.vm.constraints(
            alg, st,
            [pl(xpt), lin([(1, ccy)], limb_max=lim), cl(0)],
            b_lins=[pl(xpt), lin([(1, ccy)], limb_max=lim), cl(1)],
            sel=sel_dec, insts=[0, 1, 2])
        cs += self.cm.constraints(alg, st, [cl(2)], b_consts=[D_CONST],
                                  sel=sel_dec, insts=[0])
        # on-curve: yy − xx − d·x²y² − 1 ≡ 0  (a = −1 twisted Edwards)
        cs += self.lz.constraints(
            alg, st,
            [lin([(1, cv(1)), (-1, cv(0)), (-1, cmv(0))], const=P - 1,
                 limb_max=4 << B)],
            sel=sel_dec, insts=[0])
        cs += self.cb.constraints(alg, st, [xpt], sel=sel_dec)
        # parity: xpt[0] = 2·h0 + sign
        two = alg.constant(2)
        par = alg.sub(local[self.xpt[0]],
                      alg.add(alg.mul(two, local[self.h0[0]]), consts[SIGN]))
        cs.append(alg.mul(sel_dec, par))

        # ---- setup row: A' = −A, T3 = B + A' (normalized), acc ← O --------
        cs += self.lz.constraints(
            alg, st, [lin([(1, xap), (1, xpt)], limb_max=2 * lim)],
            sel=sel_setup, insts=[1])
        tap = t_gather(st, self.tap)
        xt3 = t_gather(st, self.xt3)
        yt3 = t_gather(st, self.yt3)
        tt3 = t_gather(st, self.tt3)
        # t' = x(A')·y ; affine add with constant B (z1 = z2 = 1 ⇒ D = 2)
        cs += self.cm.constraints(
            alg, st,
            [lin([(1, ccy), (-1, xap)], const=2 * P, limb_max=5 << B),
             lin([(1, ccy), (1, xap)], limb_max=2 * lim),
             pl(cv(3))],
            b_consts=[(BY - BX) % P, (BY + BX) % P, TWO_D * BT % P],
            sel=sel_setup, insts=[1, 2, 3])
        e_s = lin([(1, cmv(2)), (-1, cmv(1))], const=2 * P, limb_max=5 << B)
        h_s = lin([(1, cmv(2)), (1, cmv(1))], limb_max=2 * lim)
        f_s = lin([(-1, cmv(3))], const=2 * P + 2, limb_max=4 << B)
        g_s = lin([(1, cmv(3))], const=2, limb_max=(1 << B) + 2)
        cs += self.vm.constraints(
            alg, st,
            [lin([(1, xap)], limb_max=lim),          # t' = x(A')·y
             e_s, g_s, f_s, e_s,                     # X3, Y3, Z3, T3
             pl(cv(6)),                              # Z3·zi ≡ 1
             pl(cv(4)), pl(cv(5)),                   # X3·zi, Y3·zi
             pl(cv(9))],                             # xT3·yT3
            b_lins=[lin([(1, ccy)], limb_max=lim),
                    f_s, h_s, g_s, h_s,
                    pl(zi), pl(zi), pl(zi),
                    pl(cv(10))],
            sel=sel_setup, insts=[3, 4, 5, 6, 7, 8, 9, 10, 11])
        cs += self.lz.constraints(
            alg, st, [lin([(1, cv(8))], const=P - 1, limb_max=2 << B)],
            sel=sel_setup, insts=[2])
        # bind carried banks to the setup-row computation
        bind = t_stack([tap, xt3, yt3, tt3])
        vals = t_stack([cv(3), cv(9), cv(10), cv(11)])
        cs.append(alg.mul(sel_setup, alg.sub(bind, vals)))
        # acc(next) ← identity
        accn = t_gather(stn, self.acc)          # (4, L, ...)
        idm = np.zeros((4, L), dtype=np.object_)
        idm[1, 0] = 1
        idm[2, 0] = 1
        cs.append(alg.mul(sel_setup, alg.sub(accn, vconst(idm, accn))))

        # ---- carried-bank copy (rows 0..252 of each block) -----------------
        carry_idx = np.stack([self.xap, self.tap, self.xt3, self.yt3,
                              self.tt3])
        cs.append(alg.mul(sel_carry, alg.sub(t_gather(stn, carry_idx),
                                             t_gather(st, carry_idx))))

        # ---- table select (ungated; zero on non-ladder rows) ---------------
        def sel_pt(dst, base_limbs, ap_elem, t3_elem, with_id: bool):
            rhs = alg.mul(consts[C01], vconst(np.asarray(
                base_limbs, dtype=np.object_), dst))
            rhs = alg.add(rhs, alg.mul(consts[C10], ap_elem))
            rhs = alg.add(rhs, alg.mul(consts[C11], t3_elem))
            if with_id:
                one_l = np.zeros((L,), dtype=np.object_)
                one_l[0] = 1
                rhs = alg.add(rhs, alg.mul(consts[C00], vconst(one_l, dst)))
            return alg.sub(dst, rhs)

        cs.append(sel_pt(xs, limbs_top(BX, L, B), xap, xt3, False))
        cs.append(sel_pt(ys, limbs_top(BY, L, B), ccy, yt3, True))
        cs.append(sel_pt(ts, limbs_top(BT, L, B), tap, tt3, False))

        # ---- ladder row: acc ← 2·acc + sel ---------------------------------
        e_d = lin([(1, cv(3)), (-1, cv(0)), (-1, cv(1))], const=4 * P,
                  limb_max=7 << B)
        g_d = lin([(1, cv(1)), (-1, cv(0))], const=2 * P, limb_max=4 << B)
        f_d = lin([(1, cv(1)), (-1, cv(0)), (-2, cv(2))], const=6 * P,
                  limb_max=11 << B)
        h_d = lin([(-1, cv(0)), (-1, cv(1))], const=6 * P, limb_max=9 << B)
        e_a = lin([(1, cv(9)), (-1, cv(8))], const=2 * P, limb_max=4 << B)
        h_a = lin([(1, cv(9)), (1, cv(8))], limb_max=2 * lim)
        f_a = lin([(2, cv(6)), (-1, cmv(0))], const=2 * P, limb_max=5 << B)
        g_a = lin([(2, cv(6)), (1, cmv(0))], limb_max=3 << B)
        xy = lin([(1, ax), (1, ay)], limb_max=2 * lim)
        cs += self.vm.constraints(
            alg, st,
            [pl(ax), pl(ay), pl(az), xy,                       # xx yy zz s2
             e_d, g_d, f_d, e_d,                               # X2 Y2 Z2 T2
             lin([(1, cv(5)), (-1, cv(4))], const=2 * P, limb_max=4 << B),
             lin([(1, cv(5)), (1, cv(4))], limb_max=2 * lim),
             pl(cv(7)),                                        # m_t = T2·ts
             e_a, g_a, f_a, e_a],                              # X3 Y3 Z3 T3
            b_lins=[pl(ax), pl(ay), pl(az), xy,
                    f_d, h_d, g_d, h_d,
                    lin([(1, ys), (-1, xs)], const=2 * P, limb_max=4 << B),
                    lin([(1, ys), (1, xs)], limb_max=2 * lim),
                    pl(ts),
                    f_a, h_a, g_a, h_a],
            sel=sel_ladder)
        cs += self.cm.constraints(alg, st, [pl(cv(10))], b_consts=[TWO_D],
                                  sel=sel_ladder, insts=[0])
        addr = t_stack([cv(11), cv(12), cv(13), cv(14)])
        cs.append(alg.mul(sel_ladder,
                          alg.sub(t_gather(stn, self.acc), addr)))

        # ---- final row: acc == R (projective), acc.Z ≠ 0 --------------------
        cs += self.vm.constraints(
            alg, st,
            [pl(xpt), lin([(1, ccy)], limb_max=lim), pl(az)],
            b_lins=[pl(az), pl(az), pl(zi)],
            sel=sel_final, insts=[3, 4, 5])
        cs += self.lz.constraints(
            alg, st,
            [lin([(1, cv(5))], const=P - 1, limb_max=2 << B),
             lin([(1, ax), (-1, cv(3))], limb_max=2 * lim),
             lin([(1, ay), (-1, cv(4))], limb_max=2 * lim)],
            sel=sel_final, insts=[2, 3, 4])
        return cs

    # -- witness --------------------------------------------------------------

    def _limbs(self, v: int) -> List[int]:
        return [(v >> (self.B * i)) & self._lim for i in range(self.L)]

    def _fill_decomp(self, cols, r, x, y):
        """SEL_DEC suite at row r for point (x, y)."""
        lm = self._limbs
        for i, v in enumerate(lm(x)):
            cols[self.xpt[i], r] = v
        cols[self.h0[0], r] = (lm(x)[0]) >> 1
        self.cb.fill(cols, r, 0, x)
        xx = self.vm.fill(cols, r, 0, lm(x), lm(x))
        yy = self.vm.fill(cols, r, 1, lm(y), lm(y))
        w = self.vm.fill(cols, r, 2, lm(xx), lm(yy))
        dw = self.cm.fill(cols, r, 0, lm(w), b_const=D_CONST)
        self.lz.fill(cols, r, 0, lin_limbs_int(
            [(1, lm(yy)), (-1, lm(xx)), (-1, lm(dw))], P - 1,
            self.L, self.B))

    def make_trace(self, device=None):
        """Row-by-row witness on Python ints. -> ((num_cols, n_rows) trace
        on ``device``, publics[9])."""
        B, L, lm = self.B, self.L, self._limbs
        n = self.n_rows
        cols = np.zeros((self.num_cols, n), dtype=np.int64)
        for si, (a_bytes, r_bytes, s, h) in enumerate(self.sigs):
            b0 = si * ROWS_PER_SIG
            xa, ya, _ = decompress_host(a_bytes)
            xr, yr, _ = decompress_host(r_bytes)

            # -- setup row
            r = b0
            self._fill_decomp(cols, r, xa, ya)
            xap = (P - xa) % P
            self.lz.fill(cols, r, 1,
                         lin_limbs_int([(1, lm(xap)), (1, lm(xa))], 0, L, B))
            tap = self.vm.fill(cols, r, 3, lm(xap), lm(ya))
            m_a = self.cm.fill(cols, r, 1, lin_limbs_int(
                [(1, lm(ya)), (-1, lm(xap))], 2 * P, L, B),
                b_const=(BY - BX) % P)
            m_b = self.cm.fill(cols, r, 2, lin_limbs_int(
                [(1, lm(ya)), (1, lm(xap))], 0, L, B), b_const=(BY + BX) % P)
            m_t = self.cm.fill(cols, r, 3, lm(tap), b_const=TWO_D * BT % P)
            e_s = lin_limbs_int([(1, lm(m_b)), (-1, lm(m_a))], 2 * P, L, B)
            h_s = lin_limbs_int([(1, lm(m_b)), (1, lm(m_a))], 0, L, B)
            f_s = lin_limbs_int([(-1, lm(m_t))], 2 * P + 2, L, B)
            g_s = lin_limbs_int([(1, lm(m_t))], 2, L, B)
            x3 = self.vm.fill(cols, r, 4, e_s, f_s)
            y3 = self.vm.fill(cols, r, 5, g_s, h_s)
            z3 = self.vm.fill(cols, r, 6, f_s, g_s)
            self.vm.fill(cols, r, 7, e_s, h_s)
            zi = pow(z3, P - 2, P)
            for i, v in enumerate(lm(zi)):
                cols[self.zi[i], r] = v
            zc = self.vm.fill(cols, r, 8, lm(z3), lm(zi))
            assert zc == 1
            self.lz.fill(cols, r, 2,
                         lin_limbs_int([(1, lm(zc))], P - 1, L, B))
            xt3 = self.vm.fill(cols, r, 9, lm(x3), lm(zi))
            yt3 = self.vm.fill(cols, r, 10, lm(y3), lm(zi))
            tt3 = self.vm.fill(cols, r, 11, lm(xt3), lm(yt3))

            # carried banks on rows 0..253
            for rr in range(b0, b0 + 254):
                for bank, val in ((self.xap, xap), (self.tap, tap),
                                  (self.xt3, xt3), (self.yt3, yt3),
                                  (self.tt3, tt3)):
                    for i, v in enumerate(lm(val)):
                        cols[bank[i], rr] = v

            # -- ladder rows
            table = {(0, 0): (0, 1, 0), (1, 0): (BX, BY, BT),
                     (0, 1): (xap, ya, tap), (1, 1): (xt3, yt3, tt3)}
            X, Y, Z, T = 0, 1, 1, 0
            for j in range(1, N_LADDER + 1):
                r = b0 + j
                for bank, val in zip(self.acc, (X, Y, Z, T)):
                    for i, v in enumerate(lm(val)):
                        cols[bank[i], r] = v
                xx = self.vm.fill(cols, r, 0, lm(X), lm(X))
                yy = self.vm.fill(cols, r, 1, lm(Y), lm(Y))
                zz = self.vm.fill(cols, r, 2, lm(Z), lm(Z))
                xy = lin_limbs_int([(1, lm(X)), (1, lm(Y))], 0, L, B)
                s2 = self.vm.fill(cols, r, 3, xy, xy)
                e_d = lin_limbs_int([(1, lm(s2)), (-1, lm(xx)),
                                     (-1, lm(yy))], 4 * P, L, B)
                g_d = lin_limbs_int([(1, lm(yy)), (-1, lm(xx))], 2 * P, L, B)
                f_d = lin_limbs_int([(1, lm(yy)), (-1, lm(xx)),
                                     (-2, lm(zz))], 6 * P, L, B)
                h_d = lin_limbs_int([(-1, lm(xx)), (-1, lm(yy))], 6 * P,
                                    L, B)
                x2 = self.vm.fill(cols, r, 4, e_d, f_d)
                y2 = self.vm.fill(cols, r, 5, g_d, h_d)
                z2 = self.vm.fill(cols, r, 6, f_d, g_d)
                t2 = self.vm.fill(cols, r, 7, e_d, h_d)
                bit = N_LADDER - j
                xs_v, ys_v, ts_v = table[((s >> bit) & 1, (h >> bit) & 1)]
                for bank, val in ((self.xs, xs_v), (self.ys, ys_v),
                                  (self.ts, ts_v)):
                    for i, v in enumerate(lm(val)):
                        cols[bank[i], r] = v
                m_a = self.vm.fill(
                    cols, r, 8,
                    lin_limbs_int([(1, lm(y2)), (-1, lm(x2))], 2 * P, L, B),
                    lin_limbs_int([(1, lm(ys_v)), (-1, lm(xs_v))], 2 * P,
                                  L, B))
                m_b = self.vm.fill(
                    cols, r, 9,
                    lin_limbs_int([(1, lm(y2)), (1, lm(x2))], 0, L, B),
                    lin_limbs_int([(1, lm(ys_v)), (1, lm(xs_v))], 0, L, B))
                m_t2 = self.vm.fill(cols, r, 10, lm(t2), lm(ts_v))
                m_c = self.cm.fill(cols, r, 0, lm(m_t2), b_const=TWO_D)
                e_a = lin_limbs_int([(1, lm(m_b)), (-1, lm(m_a))], 2 * P,
                                    L, B)
                h_a = lin_limbs_int([(1, lm(m_b)), (1, lm(m_a))], 0, L, B)
                f_a = lin_limbs_int([(2, lm(z2)), (-1, lm(m_c))], 2 * P,
                                    L, B)
                g_a = lin_limbs_int([(2, lm(z2)), (1, lm(m_c))], 0, L, B)
                X = self.vm.fill(cols, r, 11, e_a, f_a)
                Y = self.vm.fill(cols, r, 12, g_a, h_a)
                Z = self.vm.fill(cols, r, 13, f_a, g_a)
                T = self.vm.fill(cols, r, 14, e_a, h_a)

            # -- final row
            r = b0 + 254
            for bank, val in zip(self.acc, (X, Y, Z, T)):
                for i, v in enumerate(lm(val)):
                    cols[bank[i], r] = v
            self._fill_decomp(cols, r, xr, yr)
            zinv = pow(Z, P - 2, P)
            for i, v in enumerate(lm(zinv)):
                cols[self.zi[i], r] = v
            g3 = self.vm.fill(cols, r, 5, lm(Z), lm(zinv))
            assert g3 == 1, "acc.Z not invertible"
            self.lz.fill(cols, r, 2, lin_limbs_int([(1, lm(g3))], P - 1,
                                                   L, B))
            g1 = self.vm.fill(cols, r, 3, lm(xr), lm(Z))
            g2 = self.vm.fill(cols, r, 4, lm(yr), lm(Z))
            assert g1 == X % P and g2 == Y % P, \
                "signature equation does not hold"
            self.lz.fill(cols, r, 3,
                         lin_limbs_int([(1, lm(X)), (-1, lm(g1))], 0, L, B))
            self.lz.fill(cols, r, 4,
                         lin_limbs_int([(1, lm(Y)), (-1, lm(g2))], 0, L, B))

        return _cols_to_fp(cols, device), self.publics_list()

    # -- row-batched witness (production path; identical trace) ---------------

    def make_trace_vec(self, device=None):
        """Same trace as make_trace, built in two passes: an exact-int value
        pass (Python bigints, cheap) then vectorized limb/carry fills over
        all rows of each row type at once (numpy int64) — the batching that
        makes 2^13-row shards fill in seconds. -> (trace on ``device``,
        publics[9])."""
        B, L = self.B, self.L
        n = self.n_rows
        ns = self.n_sigs
        cols = np.zeros((self.num_cols, n), dtype=np.int64)

        def mat(vals):
            return ints_to_limb_mat(vals, L, B)

        def put(bank, rows, vals):
            m = mat(vals)
            for i in range(L):
                cols[bank[i], rows] = m[:, i]

        # ---------- pass 1: exact values ----------
        V = {k: [] for k in
             ("xa", "ya", "xr", "yr", "xap", "tap", "tma", "tmb", "tmt",
              "x3", "y3", "z3", "t3e", "zi", "zchk", "xt3", "yt3", "tt3",
              "fz", "fzi", "fg1", "fg2", "fg3", "fX", "fY")}
        lad = {k: [] for k in
               ("X", "Y", "Z", "T", "xx", "yy", "zz", "s2", "x2", "y2",
                "z2", "t2", "xs", "ys", "ts", "ma", "mb", "mt", "mc",
                "X3", "Y3", "Z3", "T3")}
        for si, (a_bytes, r_bytes, s, h) in enumerate(self.sigs):
            xa, ya, _ = decompress_host(a_bytes)
            xr, yr, _ = decompress_host(r_bytes)
            xap = (P - xa) % P
            tap = xap * ya % P
            tma = (ya + 2 * P - xap) * ((BY - BX) % P) % P
            tmb = (ya + xap) * ((BY + BX) % P) % P
            tmt = tap * (TWO_D * BT % P) % P
            e_s, h_s = tmb + 2 * P - tma, tmb + tma
            f_s, g_s = 2 * P + 2 - tmt, 2 + tmt
            x3, y3 = e_s * f_s % P, g_s * h_s % P
            z3, t3e = f_s * g_s % P, e_s * h_s % P
            zi = pow(z3, P - 2, P)
            xt3, yt3 = x3 * zi % P, y3 * zi % P
            tt3 = xt3 * yt3 % P
            for k, v in (("xa", xa), ("ya", ya), ("xr", xr), ("yr", yr),
                         ("xap", xap), ("tap", tap), ("tma", tma),
                         ("tmb", tmb), ("tmt", tmt), ("x3", x3), ("y3", y3),
                         ("z3", z3), ("t3e", t3e), ("zi", zi),
                         ("zchk", z3 * zi % P), ("xt3", xt3), ("yt3", yt3),
                         ("tt3", tt3)):
                V[k].append(v)
            table = {(0, 0): (0, 1, 0), (1, 0): (BX, BY, BT),
                     (0, 1): (xap, ya, tap), (1, 1): (xt3, yt3, tt3)}
            X, Y, Z, T = 0, 1, 1, 0
            for j in range(1, N_LADDER + 1):
                xx, yy, zz = X * X % P, Y * Y % P, Z * Z % P
                s2 = (X + Y) * (X + Y) % P
                e_d = s2 + 4 * P - xx - yy
                g_d = yy + 2 * P - xx
                f_d = yy + 6 * P - xx - 2 * zz
                h_d = 6 * P - xx - yy
                x2, y2 = e_d * f_d % P, g_d * h_d % P
                z2, t2 = f_d * g_d % P, e_d * h_d % P
                bit = N_LADDER - j
                xs, ys, ts = table[((s >> bit) & 1, (h >> bit) & 1)]
                ma = (y2 + 2 * P - x2) * (ys + 2 * P - xs) % P
                mb = (y2 + x2) * (ys + xs) % P
                mt = t2 * ts % P
                mc = mt * TWO_D % P
                e_a, h_a = mb + 2 * P - ma, mb + ma
                f_a, g_a = 2 * z2 + 2 * P - mc, 2 * z2 + mc
                X3, Y3 = e_a * f_a % P, g_a * h_a % P
                Z3, T3 = f_a * g_a % P, e_a * h_a % P
                for k, v in (("X", X), ("Y", Y), ("Z", Z), ("T", T),
                             ("xx", xx), ("yy", yy), ("zz", zz), ("s2", s2),
                             ("x2", x2), ("y2", y2), ("z2", z2), ("t2", t2),
                             ("xs", xs), ("ys", ys), ("ts", ts), ("ma", ma),
                             ("mb", mb), ("mt", mt), ("mc", mc), ("X3", X3),
                             ("Y3", Y3), ("Z3", Z3), ("T3", T3)):
                    lad[k].append(v)
                X, Y, Z, T = X3, Y3, Z3, T3
            fzi = pow(Z, P - 2, P)
            g1, g2 = xr * Z % P, yr * Z % P
            assert Z * fzi % P == 1 and g1 == X % P and g2 == Y % P, \
                "signature equation does not hold"
            for k, v in (("fz", Z), ("fzi", fzi), ("fg1", g1), ("fg2", g2),
                         ("fg3", Z * fzi % P), ("fX", X), ("fY", Y)):
                V[k].append(v)

        # ---------- pass 2: vectorized fills ----------
        r_set = np.arange(ns) * ROWS_PER_SIG          # setup rows
        r_fin = r_set + 254                            # final rows
        r_lad = (r_set[:, None]
                 + np.arange(1, N_LADDER + 1)[None, :]).ravel()
        r_car = (r_set[:, None] + np.arange(254)[None, :]).ravel()

        c4p = np.asarray(limbs_top(4 * P, L, B), dtype=np.int64)
        c2p = np.asarray(limbs_top(2 * P, L, B), dtype=np.int64)
        c6p = np.asarray(limbs_top(6 * P, L, B), dtype=np.int64)
        cp1 = np.asarray(limbs_top(P - 1, L, B), dtype=np.int64)

        def decomp_rows(rows, xs_v, ys_v):
            xm, ym = mat(xs_v), mat(ys_v)
            put(self.xpt, rows, xs_v)
            cols[self.h0[0], rows] = xm[:, 0] >> 1
            self.cb.fill_vec(cols, rows, 0, xs_v)
            xxv = self.vm.fill_vec(cols, rows, 0, xm, xs_v, xm, xs_v)
            yyv = self.vm.fill_vec(cols, rows, 1, ym, ys_v, ym, ys_v)
            wv = self.vm.fill_vec(cols, rows, 2, mat(xxv), xxv,
                                  mat(yyv), yyv)
            dwv = self.cm.fill_vec(cols, rows, 0, mat(wv), wv,
                                   b_const=D_CONST)
            sm = mat(yyv) - mat(xxv) - mat(dwv) + cp1
            self.lz.fill_vec(cols, rows, 0, sm,
                             [a + P - 1 - b - c for a, b, c in
                              zip(yyv, xxv, dwv)])

        # setup rows
        decomp_rows(r_set, V["xa"], V["ya"])
        xam, yam, xapm = mat(V["xa"]), mat(V["ya"]), mat(V["xap"])
        self.lz.fill_vec(cols, r_set, 1, xapm + xam,
                         [a + b for a, b in zip(V["xap"], V["xa"])])
        self.vm.fill_vec(cols, r_set, 3, xapm, V["xap"], yam, V["ya"])
        self.cm.fill_vec(cols, r_set, 1, yam - xapm + c2p,
                         [y + 2 * P - x for y, x in zip(V["ya"], V["xap"])],
                         b_const=(BY - BX) % P)
        self.cm.fill_vec(cols, r_set, 2, yam + xapm,
                         [y + x for y, x in zip(V["ya"], V["xap"])],
                         b_const=(BY + BX) % P)
        self.cm.fill_vec(cols, r_set, 3, mat(V["tap"]), V["tap"],
                         b_const=TWO_D * BT % P)
        mam, mbm, mtm = mat(V["tma"]), mat(V["tmb"]), mat(V["tmt"])
        e_m, e_v = mbm - mam + c2p, [b + 2 * P - a for a, b in
                                     zip(V["tma"], V["tmb"])]
        h_m, h_v = mbm + mam, [a + b for a, b in zip(V["tma"], V["tmb"])]
        f_m = -mtm + c2p
        f_m[:, 0] += 2
        f_v = [2 * P + 2 - t for t in V["tmt"]]
        g_m = mtm.copy()
        g_m[:, 0] += 2
        g_v = [2 + t for t in V["tmt"]]
        self.vm.fill_vec(cols, r_set, 4, e_m, e_v, f_m, f_v)
        self.vm.fill_vec(cols, r_set, 5, g_m, g_v, h_m, h_v)
        self.vm.fill_vec(cols, r_set, 6, f_m, f_v, g_m, g_v)
        self.vm.fill_vec(cols, r_set, 7, e_m, e_v, h_m, h_v)
        put(self.zi, r_set, V["zi"])
        self.vm.fill_vec(cols, r_set, 8, mat(V["z3"]), V["z3"],
                         mat(V["zi"]), V["zi"])
        self.lz.fill_vec(cols, r_set, 2, mat(V["zchk"]) + cp1,
                         [z + P - 1 for z in V["zchk"]])
        self.vm.fill_vec(cols, r_set, 9, mat(V["x3"]), V["x3"],
                         mat(V["zi"]), V["zi"])
        self.vm.fill_vec(cols, r_set, 10, mat(V["y3"]), V["y3"],
                         mat(V["zi"]), V["zi"])
        self.vm.fill_vec(cols, r_set, 11, mat(V["xt3"]), V["xt3"],
                         mat(V["yt3"]), V["yt3"])

        # carried banks (each value repeated over rows 0..253 of its block)
        for bank, key in ((self.xap, "xap"), (self.tap, "tap"),
                          (self.xt3, "xt3"), (self.yt3, "yt3"),
                          (self.tt3, "tt3")):
            mm = np.repeat(mat(V[key]), 254, axis=0)
            for i in range(L):
                cols[bank[i], r_car] = mm[:, i]

        # ladder rows
        lv = {k: np.asarray(lad[k], dtype=np.object_) for k in lad}
        lm_ = {k: mat(lad[k]) for k in lad}
        for bank, key in ((self.acc[0], "X"), (self.acc[1], "Y"),
                          (self.acc[2], "Z"), (self.acc[3], "T"),
                          (self.xs, "xs"), (self.ys, "ys"),
                          (self.ts, "ts")):
            for i in range(L):
                cols[bank[i], r_lad] = lm_[key][:, i]
        fv = self.vm.fill_vec
        fv(cols, r_lad, 0, lm_["X"], lad["X"], lm_["X"], lad["X"])
        fv(cols, r_lad, 1, lm_["Y"], lad["Y"], lm_["Y"], lad["Y"])
        fv(cols, r_lad, 2, lm_["Z"], lad["Z"], lm_["Z"], lad["Z"])
        xym = lm_["X"] + lm_["Y"]
        xyv = list(lv["X"] + lv["Y"])
        fv(cols, r_lad, 3, xym, xyv, xym, xyv)
        e_dm = lm_["s2"] - lm_["xx"] - lm_["yy"] + c4p
        e_dv = list(lv["s2"] + 4 * P - lv["xx"] - lv["yy"])
        g_dm = lm_["yy"] - lm_["xx"] + c2p
        g_dv = list(lv["yy"] + 2 * P - lv["xx"])
        f_dm = lm_["yy"] - lm_["xx"] - 2 * lm_["zz"] + c6p
        f_dv = list(lv["yy"] + 6 * P - lv["xx"] - 2 * lv["zz"])
        h_dm = -lm_["xx"] - lm_["yy"] + c6p
        h_dv = list(6 * P - lv["xx"] - lv["yy"])
        fv(cols, r_lad, 4, e_dm, e_dv, f_dm, f_dv)
        fv(cols, r_lad, 5, g_dm, g_dv, h_dm, h_dv)
        fv(cols, r_lad, 6, f_dm, f_dv, g_dm, g_dv)
        fv(cols, r_lad, 7, e_dm, e_dv, h_dm, h_dv)
        fv(cols, r_lad, 8, lm_["y2"] - lm_["x2"] + c2p,
           list(lv["y2"] + 2 * P - lv["x2"]),
           lm_["ys"] - lm_["xs"] + c2p, list(lv["ys"] + 2 * P - lv["xs"]))
        fv(cols, r_lad, 9, lm_["y2"] + lm_["x2"], list(lv["y2"] + lv["x2"]),
           lm_["ys"] + lm_["xs"], list(lv["ys"] + lv["xs"]))
        fv(cols, r_lad, 10, lm_["t2"], lad["t2"], lm_["ts"], lad["ts"])
        self.cm.fill_vec(cols, r_lad, 0, lm_["mt"], lad["mt"],
                         b_const=TWO_D)
        e_am = lm_["mb"] - lm_["ma"] + c2p
        e_av = list(lv["mb"] + 2 * P - lv["ma"])
        h_am = lm_["mb"] + lm_["ma"]
        h_av = list(lv["mb"] + lv["ma"])
        f_am = 2 * lm_["z2"] - lm_["mc"] + c2p
        f_av = list(2 * lv["z2"] + 2 * P - lv["mc"])
        g_am = 2 * lm_["z2"] + lm_["mc"]
        g_av = list(2 * lv["z2"] + lv["mc"])
        fv(cols, r_lad, 11, e_am, e_av, f_am, f_av)
        fv(cols, r_lad, 12, g_am, g_av, h_am, h_av)
        fv(cols, r_lad, 13, f_am, f_av, g_am, g_av)
        fv(cols, r_lad, 14, e_am, e_av, h_am, h_av)

        # final rows
        for bank, key in ((self.acc[0], "fX"), (self.acc[1], "fY"),
                          (self.acc[2], "fz")):
            put(bank, r_fin, V[key])
        tfin = [lad["T3"][si * N_LADDER + N_LADDER - 1] for si in range(ns)]
        put(self.acc[3], r_fin, tfin)
        decomp_rows(r_fin, V["xr"], V["yr"])
        put(self.zi, r_fin, V["fzi"])
        self.vm.fill_vec(cols, r_fin, 5, mat(V["fz"]), V["fz"],
                         mat(V["fzi"]), V["fzi"])
        self.lz.fill_vec(cols, r_fin, 2, mat(V["fg3"]) + cp1,
                         [z + P - 1 for z in V["fg3"]])
        self.vm.fill_vec(cols, r_fin, 3, mat(V["xr"]), V["xr"],
                         mat(V["fz"]), V["fz"])
        self.vm.fill_vec(cols, r_fin, 4, mat(V["yr"]), V["yr"],
                         mat(V["fz"]), V["fz"])
        self.lz.fill_vec(cols, r_fin, 3, mat(V["fX"]) - mat(V["fg1"]),
                         [a - b for a, b in zip(V["fX"], V["fg1"])])
        self.lz.fill_vec(cols, r_fin, 4, mat(V["fY"]) - mat(V["fg2"]),
                         [a - b for a, b in zip(V["fY"], V["fg2"])])

        return _cols_to_fp(cols, device), self.publics_list()
