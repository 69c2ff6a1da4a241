"""Blake2b-256 AIR — proving the Avail header hash in-STARK.

``Blake2bAir`` proves ``digest = blake2b256(msg, length)`` for a
single-chunk message (<= 128 bytes); ``Blake2bVarAir`` chains up to
``max_chunks`` chunks (variable length). Constraint text follows the JAX
package's module line for line.

Trace: one G function per row — 12 rounds x 8 G = 96 G rows, then the
finalization rows (one digest word each), padded to 128.

Representation: the sixteen 64-bit state words v[p] live as (lo, hi)
32-bit value columns; every xor/rotation routes through 64-wide bit-column
families. Which quad (a,b,c,d) a row's G touches and which message words
feed it are public constant selector columns (the schedule is static), so
reads are selector-blended sums and writes are selector-gated updates.
Additions constrain 32-bit half-sums with boolean carries (sound in
Goldilocks: half-sums < 2^34 << p; a full 64-bit sum identity mod p would
not be sound since 2^64 > p).

Per-row pipeline (standard Blake2b G):
  a1 = a + b + x            BA1 bits   carries ca1
  d1 = rotr64(d ^ a1, 32)   expression over BD/BA1
  c1 = c + d1               BC1 bits   carries cc1
  b1 = rotr64(b ^ c1, 24)   expression over BB/BC1
  a2 = a1 + b1 + y          BA2 bits   carries ca2
  d2 = rotr64(d1 ^ a2, 16)  BD2 bits (committed: keeps writes at degree 2)
  c2 = c1 + d2              BC2 bits   carries cc2
  b2 = rotr64(b1 ^ c2, 63)  BB2 bits (committed)

Finalization row j (96+j): digest word j = h_init[j] ^ v[j] ^ v[j+8].

Publics (41): msg halves[32] | byte_length | digest halves[8].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import default_device
from ..field import goldilocks as gl
from .air import Air
from .air_sha256 import Sha256CompressAir as _GroupedAirBase

# Blake2b IV and message schedule
_IV = np.array([
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179], dtype=np.uint64)

_SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0]], dtype=np.int32)


# --- column layout ----------------------------------------------------------
V = 0          # 32: v[p] lo at V+2p, hi at V+2p+1
MW = 32        # 32: message words, same packing
T = 64         # 32: bit columns of the byte length
OUT = 96       # 8: digest word j lo at OUT+2j, hi at OUT+2j+1
BD = 104       # 64-bit families
BB = 168
BA1 = 232
BC1 = 296
BA2 = 360
BC2 = 424
BD2 = 488
BB2 = 552
CR = 616       # 12 carry bits: ca1(2+2) cc1(1+1) ca2(2+2) cc2(1+1)
NUM_COLS = 628

N_ROWS = 128
N_G_ROWS = 96

# constant-column bases (within the consts list)
C_SELA, C_SELB, C_SELC, C_SELD = 0, 16, 32, 48
C_FSEL1, C_FSEL2 = 64, 80
C_SELX, C_SELY = 96, 112
C_FINW = 128   # 4
NUM_CONSTS = 132

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1

PARAM0 = 0x01010020  # digest_length=32, fanout=1, depth=1
H_INIT = [int(_IV[j]) ^ (PARAM0 if j == 0 else 0) for j in range(8)]


def _quad(g: int):
    if g < 4:
        return (g, 4 + g, 8 + g, 12 + g)
    gg = g - 4
    return (gg, 4 + (gg + 1) % 4, 8 + (gg + 2) % 4, 12 + (gg + 3) % 4)


def _rotr64(x: int, r: int) -> int:
    return ((x >> r) | (x << (64 - r))) & M64


class Blake2bAir(_GroupedAirBase):
    """Single-chunk Blake2b-256. publics: msg[32] | length | digest[8]."""

    num_cols = NUM_COLS
    num_publics = 41
    max_constraint_degree = 3

    def constant_columns(self, n_rows: int):
        assert n_rows == N_ROWS
        out = np.zeros((NUM_CONSTS, n_rows), dtype=np.uint64)
        for r in range(N_G_ROWS):
            rnd, g = r // 8, r % 8
            qa, qb, qc, qd = _quad(g)
            out[C_SELA + qa, r] = 1
            out[C_SELB + qb, r] = 1
            out[C_SELC + qc, r] = 1
            out[C_SELD + qd, r] = 1
            s = _SIGMA[rnd % 10]
            out[C_SELX + int(s[2 * g]), r] = 1
            out[C_SELY + int(s[2 * g + 1]), r] = 1
        for j in range(4):
            r = N_G_ROWS + j
            out[C_FSEL1 + j, r] = 1
            out[C_FSEL2 + 8 + j, r] = 1
            out[C_FINW + j, r] = 1
        return out

    # -- helpers over 64-wide grouped bit tensors ---------------------------

    def _val_slice(self, alg, g64, lohi: int):
        """Value of bits [32*lohi, 32*lohi+32) of a 64-group."""
        from .air import slice_group
        sl = slice_group(g64, 32 * lohi, 32 * lohi + 32)
        return self._sum0(alg.mul(sl, self._pw2(alg)), alg)

    @staticmethod
    def _xor_g(alg, x, y):
        return alg.sub(alg.add(x, y),
                       alg.mul(alg.constant(2), alg.mul(x, y)))

    def _blend(self, alg, local, sels, base):
        """Selector-blended read: (lo, hi) of sum_p sel[p] * v[p]."""
        lo = alg.zero()
        hi = alg.zero()
        for p in range(16):
            lo = alg.add(lo, alg.mul(sels[p], local[base + 2 * p]))
            hi = alg.add(hi, alg.mul(sels[p], local[base + 2 * p + 1]))
        return lo, hi

    def _carry(self, alg, local, k, nbits):
        acc = alg.zero()
        for i in range(nbits):
            acc = alg.add(acc, alg.mul(alg.constant(1 << i), local[CR + k + i]))
        return acc

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        cs = []
        St = self._stack
        one = alg.one()
        two32 = alg.constant(1 << 32)

        sel_a = consts[C_SELA:C_SELA + 16]
        sel_b = consts[C_SELB:C_SELB + 16]
        sel_c = consts[C_SELC:C_SELC + 16]
        sel_d = consts[C_SELD:C_SELD + 16]
        fsel1 = consts[C_FSEL1:C_FSEL1 + 16]
        fsel2 = consts[C_FSEL2:C_FSEL2 + 16]
        sel_x = consts[C_SELX:C_SELX + 16]
        sel_y = consts[C_SELY:C_SELY + 16]
        finw = consts[C_FINW:C_FINW + 4]

        def fam(base, row=local, n=64):
            return St([row[base + i] for i in range(n)])

        bd, bb = fam(BD), fam(BB)
        ba1, bc1, ba2, bc2 = fam(BA1), fam(BC1), fam(BA2), fam(BC2)
        bd2, bb2 = fam(BD2), fam(BB2)
        tbits = fam(T, n=32)
        crs = St([local[CR + i] for i in range(12)])

        # booleanity
        for f in (bd, bb, ba1, bc1, ba2, bc2, bd2, bb2, tbits, crs):
            cs.append(alg.sub(alg.mul(f, f), f))

        # taps: BD/BB must decompose the selected reads (G rows via SEL_D/
        # SEL_B, finalization rows via FSEL1/FSEL2; zero elsewhere)
        dsel = [alg.add(sel_d[p], fsel1[p]) for p in range(16)]
        bsel = [alg.add(sel_b[p], fsel2[p]) for p in range(16)]
        d_lo, d_hi = self._blend(alg, local, dsel, V)
        b_lo, b_hi = self._blend(alg, local, bsel, V)
        cs.append(alg.sub(self._val_slice(alg, bd, 0), d_lo))
        cs.append(alg.sub(self._val_slice(alg, bd, 1), d_hi))
        cs.append(alg.sub(self._val_slice(alg, bb, 0), b_lo))
        cs.append(alg.sub(self._val_slice(alg, bb, 1), b_hi))

        a_lo, a_hi = self._blend(alg, local, sel_a, V)
        c_lo, c_hi = self._blend(alg, local, sel_c, V)
        x_lo, x_hi = self._blend(alg, local, sel_x, MW)
        y_lo, y_hi = self._blend(alg, local, sel_y, MW)

        def add3(lo_terms, hi_terms, out_fam, ck, cbits):
            """Constrain out = sum(terms) mod 2^64 via 32-bit half sums."""
            clo = self._carry(alg, local, ck, cbits)
            chi = self._carry(alg, local, ck + cbits, cbits)
            slo = lo_terms[0]
            for t in lo_terms[1:]:
                slo = alg.add(slo, t)
            shi = hi_terms[0]
            for t in hi_terms[1:]:
                shi = alg.add(shi, t)
            shi = alg.add(shi, clo)
            cs.append(alg.sub(alg.add(self._val_slice(alg, out_fam, 0),
                                      alg.mul(clo, two32)), slo))
            cs.append(alg.sub(alg.add(self._val_slice(alg, out_fam, 1),
                                      alg.mul(chi, two32)), shi))

        bb_lo = self._val_slice(alg, bb, 0)
        bb_hi = self._val_slice(alg, bb, 1)
        add3([a_lo, bb_lo, x_lo], [a_hi, bb_hi, x_hi], ba1, 0, 2)   # a1

        d1 = self._roll(self._xor_g(alg, bd, ba1), -32)             # deg 2
        d1_lo = self._val_slice(alg, d1, 0)
        d1_hi = self._val_slice(alg, d1, 1)
        add3([c_lo, d1_lo], [c_hi, d1_hi], bc1, 4, 1)               # c1

        b1 = self._roll(self._xor_g(alg, bb, bc1), -24)             # deg 2
        b1_lo = self._val_slice(alg, b1, 0)
        b1_hi = self._val_slice(alg, b1, 1)
        a1_lo = self._val_slice(alg, ba1, 0)
        a1_hi = self._val_slice(alg, ba1, 1)
        add3([a1_lo, b1_lo, y_lo], [a1_hi, b1_hi, y_hi], ba2, 6, 2)  # a2

        # d2/b2 are committed families (keeps v-writes at degree 2)
        cs.append(alg.sub(bd2, self._roll(self._xor_g(alg, d1, ba2), -16)))
        c1_lo = self._val_slice(alg, bc1, 0)
        c1_hi = self._val_slice(alg, bc1, 1)
        d2_lo = self._val_slice(alg, bd2, 0)
        d2_hi = self._val_slice(alg, bd2, 1)
        add3([c1_lo, d2_lo], [c1_hi, d2_hi], bc2, 10, 1)             # c2
        cs.append(alg.sub(bb2, self._roll(self._xor_g(alg, b1, bc2), -63)))

        # v writes: updated quad words, copy elsewhere
        a2v = (self._val_slice(alg, ba2, 0), self._val_slice(alg, ba2, 1))
        b2v = (self._val_slice(alg, bb2, 0), self._val_slice(alg, bb2, 1))
        c2v = (self._val_slice(alg, bc2, 0), self._val_slice(alg, bc2, 1))
        d2v = (self._val_slice(alg, bd2, 0), self._val_slice(alg, bd2, 1))
        wr = []
        for p in range(16):
            keep = alg.sub(one, alg.add(alg.add(sel_a[p], sel_b[p]),
                                        alg.add(sel_c[p], sel_d[p])))
            for h in range(2):
                upd = alg.add(
                    alg.add(alg.mul(sel_a[p], a2v[h]),
                            alg.mul(sel_b[p], b2v[h])),
                    alg.add(alg.mul(sel_c[p], c2v[h]),
                            alg.mul(sel_d[p], d2v[h])))
                wr.append(alg.sub(next_row[V + 2 * p + h],
                                  alg.add(upd,
                                          alg.mul(keep,
                                                  local[V + 2 * p + h]))))
        cs.append(St(wr))

        # message / length-bit copies
        cs.append(alg.sub(St([next_row[MW + i] for i in range(32)]),
                          St([local[MW + i] for i in range(32)])))
        cs.append(alg.sub(St([next_row[T + i] for i in range(32)]), tbits))

        # finalization: OUT word j set on row 96+j, copied elsewhere
        outs = []
        for j in range(4):
            hj = H_INIT[j]
            xor_vv = self._xor_g(alg, bd, bb)   # v[j] ^ v[j+8] bits (deg 2)
            for h in range(2):
                val = alg.zero()
                for i in range(32):
                    cbit = (hj >> (32 * h + i)) & 1
                    from .air import index_group
                    bit = index_group(xor_vv, 32 * h + i)
                    if cbit:
                        bit = alg.sub(one, bit)
                    val = alg.add(val, alg.mul(alg.constant(1 << i), bit))
                outs.append(alg.sub(
                    next_row[OUT + 2 * j + h],
                    alg.add(alg.mul(finw[j], val),
                            alg.mul(alg.sub(one, finw[j]),
                                    local[OUT + 2 * j + h]))))
        cs.append(St(outs))

        return cs

    def first_row(self, alg, local, publics, consts=()):
        cs = []
        St = self._stack
        one = alg.one()

        # message = publics
        cs.append(alg.sub(St([local[MW + i] for i in range(32)]),
                          St([alg.lift(publics[i]) for i in range(32)])))
        # length bits decompose the public length
        tval = self._sum0(alg.mul(St([local[T + i] for i in range(32)]),
                                  self._pw2(alg)), alg)
        cs.append(alg.sub(tval, alg.lift(publics[32])))

        # v initialisation
        def pin(p, value):
            cs.append(alg.sub(local[V + 2 * p], alg.constant(value & M32)))
            cs.append(alg.sub(local[V + 2 * p + 1],
                              alg.constant((value >> 32) & M32)))

        for j in range(8):
            pin(j, H_INIT[j])
        for j in range(4):
            pin(8 + j, int(_IV[j]))
        # v12 = IV[4] ^ t (t < 2^32)
        iv4 = int(_IV[4])
        v12lo = alg.zero()
        for i in range(32):
            cbit = (iv4 >> i) & 1
            bit = local[T + i]
            if cbit:
                bit = alg.sub(one, bit)
            v12lo = alg.add(v12lo, alg.mul(alg.constant(1 << i), bit))
        cs.append(alg.sub(local[V + 24], v12lo))
        cs.append(alg.sub(local[V + 25], alg.constant((iv4 >> 32) & M32)))
        pin(13, int(_IV[5]))
        pin(14, int(_IV[6]) ^ M64)
        pin(15, int(_IV[7]))

        cs.append(St([local[OUT + i] for i in range(8)]))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        return [self._stack([alg.sub(local[OUT + i],
                                     alg.lift(publics[33 + i]))
                             for i in range(8)])]

    # ------------------------------------------------------------------
    # Witness generation (host side, exact ints)
    # ------------------------------------------------------------------

    @staticmethod
    def make_trace(msg: bytes, device=None):
        """msg: <= 128 bytes. -> (trace on ``device``, publics[41],
        digest_bytes)."""
        assert len(msg) <= 128
        length = len(msg)
        buf = msg + b"\x00" * (128 - length)
        m = [int.from_bytes(buf[8 * i:8 * i + 8], "little")
             for i in range(16)]

        cols = np.zeros((NUM_COLS, N_ROWS), dtype=np.object_)

        v = list(H_INIT) + [int(_IV[j]) for j in range(4)]
        v.append(int(_IV[4]) ^ length)
        v.append(int(_IV[5]))
        v.append(int(_IV[6]) ^ M64)
        v.append(int(_IV[7]))
        out = [0] * 4

        for r in range(N_ROWS):
            for p in range(16):
                cols[V + 2 * p, r] = v[p] & M32
                cols[V + 2 * p + 1, r] = v[p] >> 32
                cols[MW + 2 * p, r] = m[p] & M32
                cols[MW + 2 * p + 1, r] = m[p] >> 32
            for i in range(32):
                cols[T + i, r] = (length >> i) & 1
            for j in range(4):
                cols[OUT + 2 * j, r] = out[j] & M32
                cols[OUT + 2 * j + 1, r] = out[j] >> 32

            # reads per the selector schedule
            if r < N_G_ROWS:
                rnd, g = r // 8, r % 8
                qa, qb, qc, qd = _quad(g)
                s = _SIGMA[rnd % 10]
                ra, rb_, rc, rd = v[qa], v[qb], v[qc], v[qd]
                x, y = m[int(s[2 * g])], m[int(s[2 * g + 1])]
            elif r < N_G_ROWS + 4:
                j = r - N_G_ROWS
                ra = rc = x = y = 0
                rd, rb_ = v[j], v[j + 8]
            else:
                ra = rb_ = rc = rd = x = y = 0

            def halves_add(*terms):
                slo = sum(t & M32 for t in terms)
                clo = slo >> 32
                shi = sum(t >> 32 for t in terms) + clo
                chi = shi >> 32
                return ((slo & M32) | ((shi & M32) << 32)), clo, chi

            a1, ca1lo, ca1hi = halves_add(ra, rb_, x)
            d1 = _rotr64(rd ^ a1, 32)
            c1, cc1lo, cc1hi = halves_add(rc, d1)
            b1 = _rotr64(rb_ ^ c1, 24)
            a2, ca2lo, ca2hi = halves_add(a1, b1, y)
            d2 = _rotr64(d1 ^ a2, 16)
            c2, cc2lo, cc2hi = halves_add(c1, d2)
            b2 = _rotr64(b1 ^ c2, 63)

            for i in range(64):
                cols[BD + i, r] = (rd >> i) & 1
                cols[BB + i, r] = (rb_ >> i) & 1
                cols[BA1 + i, r] = (a1 >> i) & 1
                cols[BC1 + i, r] = (c1 >> i) & 1
                cols[BA2 + i, r] = (a2 >> i) & 1
                cols[BC2 + i, r] = (c2 >> i) & 1
                cols[BD2 + i, r] = (d2 >> i) & 1
                cols[BB2 + i, r] = (b2 >> i) & 1
            carry_bits = [ca1lo & 1, ca1lo >> 1, ca1hi & 1, ca1hi >> 1,
                          cc1lo, cc1hi,
                          ca2lo & 1, ca2lo >> 1, ca2hi & 1, ca2hi >> 1,
                          cc2lo, cc2hi]
            for i, cb in enumerate(carry_bits):
                cols[CR + i, r] = cb

            if r < N_G_ROWS:
                v[qa], v[qb], v[qc], v[qd] = a2, b2, c2, d2
            elif r < N_G_ROWS + 4:
                out[j] = H_INIT[j] ^ v[j] ^ v[j + 8]

        digest = b"".join(w.to_bytes(8, "little") for w in out)
        publics = []
        for p in range(16):
            publics += [m[p] & M32, m[p] >> 32]
        publics.append(length)
        for j in range(4):
            publics += [out[j] & M32, out[j] >> 32]
        trace = gl.to_fp(cols, device)
        return trace, publics, digest


# ===========================================================================
# Variable-length multi-chunk Blake2b-256 (curta_blake2b_variable parity)
# ===========================================================================

# extra columns appended after the single-chunk layout (OUT is repurposed:
# the digest register is H; OUT columns are dropped from the layout below)
H = 616 + 12          # 16: h word j lo at H+2j, hi at H+2j+1
BH = H + 16           # 64: bits of h[j] on finalization rows
BX = BH + 64          # 64: bits of h[j] ^ v[j] ^ v[j+8]
ACT = BX + 64         # chunk-active flag
LST = ACT + 1         # chunk-is-last flag
RNG7 = LST + 1        # 7 range-check bits for (length - 128*c - 1)
V_NUM_COLS = RNG7 + 7

# constant columns: single-chunk bases, FINW widened to 8, plus wiring
VC_FINW = 128         # 8 (one per finalized h word)
VC_FSELH = 136        # 8 (H-word read selector on fin rows)
VC_BLAST = 144        # 1 at r % 128 == 127
VC_NOTLAST = 145
VC_TFULL = 146        # 128*(c+1) per chunk
VC_TPREV = 147        # 128*c per chunk
V_NUM_CONSTS = 148

N_FIN_ROWS = 8


class Blake2bVarAir(Blake2bAir):
    """Variable-length Blake2b-256 over up to `max_chunks` 128-byte chunks:
    static max_chunks buffer, public byte length (1 <= length <=
    128*max_chunks), per-chunk active/last masking, t-counter = length on
    the last block. The message is a PRIVATE witness; publics are [length,
    digest halves(8)].

    Layout: one 128-row block per chunk (96 G rows + 8 h-finalisation rows
    + pad), chunks laid end to end, padded with inactive chunks to a
    power of two. The h state is a 16-column register persisting across
    chunk boundaries; v re-initialises from (h, IV, t, last-flag) at every
    chunk start. num_rows = 128 * num_blocks(max_chunks).
    """

    num_publics = 9
    max_constraint_degree = 3
    num_cols = V_NUM_COLS

    def __init__(self, max_chunks: int):
        self.max_chunks = max_chunks
        nb = 1
        while nb < max_chunks:
            nb <<= 1
        self.num_blocks = nb
        self.n_rows = nb * N_ROWS

    def constant_columns(self, n_rows: int):
        if n_rows != self.n_rows:     # shape-only probe (Air.num_constraints)
            return np.zeros((V_NUM_CONSTS, n_rows), dtype=np.uint64)
        out = np.zeros((V_NUM_CONSTS, n_rows), dtype=np.uint64)
        for blk in range(self.num_blocks):
            r0 = blk * N_ROWS
            for r in range(N_G_ROWS):
                rnd, g = r // 8, r % 8
                qa, qb, qc, qd = _quad(g)
                out[C_SELA + qa, r0 + r] = 1
                out[C_SELB + qb, r0 + r] = 1
                out[C_SELC + qc, r0 + r] = 1
                out[C_SELD + qd, r0 + r] = 1
                s = _SIGMA[rnd % 10]
                out[C_SELX + int(s[2 * g]), r0 + r] = 1
                out[C_SELY + int(s[2 * g + 1]), r0 + r] = 1
            for j in range(N_FIN_ROWS):
                r = r0 + N_G_ROWS + j
                out[C_FSEL1 + j, r] = 1
                out[C_FSEL2 + 8 + j, r] = 1
                out[VC_FINW + j, r] = 1
                out[VC_FSELH + j, r] = 1
            out[VC_BLAST, r0 + N_ROWS - 1] = 1
            out[VC_TFULL, r0:r0 + N_ROWS] = 128 * (blk + 1)
            out[VC_TPREV, r0:r0 + N_ROWS] = 128 * blk
        out[VC_NOTLAST] = 1 - out[VC_BLAST]
        return out

    def _h_blend(self, alg, row, fselh):
        lo = alg.zero()
        hi = alg.zero()
        for j in range(8):
            lo = alg.add(lo, alg.mul(fselh[j], row[H + 2 * j]))
            hi = alg.add(hi, alg.mul(fselh[j], row[H + 2 * j + 1]))
        return lo, hi

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        return list(self.transition_iter(alg, local, next_row, publics,
                                         consts, consts_next))

    def transition_iter(self, alg, local, next_row, publics, consts=(),
                        consts_next=()):
        """Generator form of ``transition``: the same constraints in the
        same order, yielded one at a time."""
        St = self._stack
        one = alg.one()
        two32 = alg.constant(1 << 32)

        sel_a = consts[C_SELA:C_SELA + 16]
        sel_b = consts[C_SELB:C_SELB + 16]
        sel_c = consts[C_SELC:C_SELC + 16]
        sel_d = consts[C_SELD:C_SELD + 16]
        fsel1 = consts[C_FSEL1:C_FSEL1 + 16]
        fsel2 = consts[C_FSEL2:C_FSEL2 + 16]
        sel_x = consts[C_SELX:C_SELX + 16]
        sel_y = consts[C_SELY:C_SELY + 16]
        finw = consts[VC_FINW:VC_FINW + 8]
        fselh = consts[VC_FSELH:VC_FSELH + 8]
        b_last = consts[VC_BLAST]
        not_last = consts[VC_NOTLAST]
        t_full = consts[VC_TFULL]
        t_prev = consts[VC_TPREV]

        def fam(base, row=local, n=64):
            return St([row[base + i] for i in range(n)])

        bd, bb = fam(BD), fam(BB)
        ba1, bc1, ba2, bc2 = fam(BA1), fam(BC1), fam(BA2), fam(BC2)
        bd2, bb2 = fam(BD2), fam(BB2)
        bh, bx = fam(BH), fam(BX)
        tbits = fam(T, n=32)
        crs = St([local[CR + i] for i in range(12)]
                 + [local[ACT], local[LST]]
                 + [local[RNG7 + i] for i in range(7)])

        # booleanity
        for f in (bd, bb, ba1, bc1, ba2, bc2, bd2, bb2, bh, bx, tbits, crs):
            yield alg.sub(alg.mul(f, f), f)

        # taps
        dsel = [alg.add(sel_d[p], fsel1[p]) for p in range(16)]
        bsel = [alg.add(sel_b[p], fsel2[p]) for p in range(16)]
        d_lo, d_hi = self._blend(alg, local, dsel, V)
        b_lo, b_hi = self._blend(alg, local, bsel, V)
        yield alg.sub(self._val_slice(alg, bd, 0), d_lo)
        yield alg.sub(self._val_slice(alg, bd, 1), d_hi)
        yield alg.sub(self._val_slice(alg, bb, 0), b_lo)
        yield alg.sub(self._val_slice(alg, bb, 1), b_hi)
        h_lo, h_hi = self._h_blend(alg, local, fselh)
        yield alg.sub(self._val_slice(alg, bh, 0), h_lo)
        yield alg.sub(self._val_slice(alg, bh, 1), h_hi)

        a_lo, a_hi = self._blend(alg, local, sel_a, V)
        c_lo, c_hi = self._blend(alg, local, sel_c, V)
        x_lo, x_hi = self._blend(alg, local, sel_x, MW)
        y_lo, y_hi = self._blend(alg, local, sel_y, MW)

        def add3(lo_terms, hi_terms, out_fam, ck, cbits):
            clo = self._carry(alg, local, ck, cbits)
            chi = self._carry(alg, local, ck + cbits, cbits)
            slo = lo_terms[0]
            for t in lo_terms[1:]:
                slo = alg.add(slo, t)
            shi = hi_terms[0]
            for t in hi_terms[1:]:
                shi = alg.add(shi, t)
            shi = alg.add(shi, clo)
            return [alg.sub(alg.add(self._val_slice(alg, out_fam, 0),
                                    alg.mul(clo, two32)), slo),
                    alg.sub(alg.add(self._val_slice(alg, out_fam, 1),
                                    alg.mul(chi, two32)), shi)]

        bb_lo = self._val_slice(alg, bb, 0)
        bb_hi = self._val_slice(alg, bb, 1)
        yield from add3([a_lo, bb_lo, x_lo], [a_hi, bb_hi, x_hi], ba1, 0, 2)
        d1 = self._roll(self._xor_g(alg, bd, ba1), -32)
        yield from add3([c_lo, self._val_slice(alg, d1, 0)],
                        [c_hi, self._val_slice(alg, d1, 1)], bc1, 4, 1)
        b1 = self._roll(self._xor_g(alg, bb, bc1), -24)
        yield from add3([self._val_slice(alg, ba1, 0),
                         self._val_slice(alg, b1, 0), y_lo],
                        [self._val_slice(alg, ba1, 1),
                         self._val_slice(alg, b1, 1), y_hi], ba2, 6, 2)
        yield alg.sub(bd2, self._roll(self._xor_g(alg, d1, ba2), -16))
        yield from add3([self._val_slice(alg, bc1, 0),
                         self._val_slice(alg, bd2, 0)],
                        [self._val_slice(alg, bc1, 1),
                         self._val_slice(alg, bd2, 1)], bc2, 10, 1)
        yield alg.sub(bb2, self._roll(self._xor_g(alg, b1, bc2), -63))

        # finalisation xor: BX == BH ^ BD ^ BB (v[j] ^ v[j+8] ^ h[j])
        yield alg.sub(bx, self._xor_g(alg, bh,
                                      self._xor_g(alg, bd, bb)))

        # v writes within a block; v re-initialisation at chunk boundaries
        a2v = (self._val_slice(alg, ba2, 0), self._val_slice(alg, ba2, 1))
        b2v = (self._val_slice(alg, bb2, 0), self._val_slice(alg, bb2, 1))
        c2v = (self._val_slice(alg, bc2, 0), self._val_slice(alg, bc2, 1))
        d2v = (self._val_slice(alg, bd2, 0), self._val_slice(alg, bd2, 1))
        wr = []
        for p in range(16):
            keep = alg.sub(one, alg.add(alg.add(sel_a[p], sel_b[p]),
                                        alg.add(sel_c[p], sel_d[p])))
            for hh in range(2):
                upd = alg.add(
                    alg.add(alg.mul(sel_a[p], a2v[hh]),
                            alg.mul(sel_b[p], b2v[hh])),
                    alg.add(alg.mul(sel_c[p], c2v[hh]),
                            alg.mul(sel_d[p], d2v[hh])))
                wr.append(alg.sub(
                    alg.mul(not_last, next_row[V + 2 * p + hh]),
                    alg.add(alg.mul(not_last, upd),
                            alg.mul(alg.mul(not_last, keep),
                                    local[V + 2 * p + hh]))))
        yield St(wr)

        # chunk-start v init (constraints on next_row gated by b_last)
        init = []
        ntb = fam(T, row=next_row, n=32)
        for p in range(8):      # v[0..8] = h
            for hh in range(2):
                init.append(alg.sub(next_row[V + 2 * p + hh],
                                    next_row[H + 2 * p + hh]))
        for j in range(4):      # v[8..12] = IV
            iv = int(_IV[j])
            init.append(alg.sub(next_row[V + 2 * (8 + j)],
                                alg.constant(iv & M32)))
            init.append(alg.sub(next_row[V + 2 * (8 + j) + 1],
                                alg.constant((iv >> 32) & M32)))
        iv4 = int(_IV[4])
        v12lo = alg.zero()
        from .air import index_group
        for i in range(32):
            bit = index_group(ntb, i)
            if (iv4 >> i) & 1:
                bit = alg.sub(one, bit)
            v12lo = alg.add(v12lo, alg.mul(alg.constant(1 << i), bit))
        init.append(alg.sub(next_row[V + 24], v12lo))
        init.append(alg.sub(next_row[V + 25],
                            alg.constant((iv4 >> 32) & M32)))
        iv5 = int(_IV[5])
        init.append(alg.sub(next_row[V + 26], alg.constant(iv5 & M32)))
        init.append(alg.sub(next_row[V + 27],
                            alg.constant((iv5 >> 32) & M32)))
        iv6 = int(_IV[6])
        nlst = next_row[LST]
        for hh in range(2):
            v14 = alg.zero()
            for i in range(32):
                cbit = (iv6 >> (32 * hh + i)) & 1
                bit = alg.sub(one, nlst) if cbit else nlst
                v14 = alg.add(v14, alg.mul(alg.constant(1 << i), bit))
            init.append(alg.sub(next_row[V + 28 + hh], v14))
        iv7 = int(_IV[7])
        init.append(alg.sub(next_row[V + 30], alg.constant(iv7 & M32)))
        init.append(alg.sub(next_row[V + 31],
                            alg.constant((iv7 >> 32) & M32)))
        yield alg.mul(b_last, St(init))

        # h register: finalisation writes (active chunks only), else copy
        hw = []
        for j in range(8):
            for hh in range(2):
                bxv = self._val_slice(alg, bx, hh)
                upd = alg.add(alg.mul(local[ACT], bxv),
                              alg.mul(alg.sub(one, local[ACT]),
                                      local[H + 2 * j + hh]))
                hw.append(alg.sub(
                    next_row[H + 2 * j + hh],
                    alg.add(alg.mul(finw[j], upd),
                            alg.mul(alg.sub(one, finw[j]),
                                    local[H + 2 * j + hh]))))
        yield St(hw)

        # message copy within a block (free across chunk boundaries)
        mg = St([local[MW + i] for i in range(32)])
        nmg = St([next_row[MW + i] for i in range(32)])
        yield alg.mul(not_last, alg.sub(nmg, mg))
        # t bits copy within a block
        yield alg.mul(not_last, alg.sub(ntb, tbits))
        # ACT/LST copy within a block; ACT non-increasing at boundaries;
        # LST_c == ACT_c * (1 - ACT_{c+1})
        yield alg.mul(not_last, alg.sub(next_row[ACT], local[ACT]))
        yield alg.mul(not_last, alg.sub(next_row[LST], local[LST]))
        yield alg.mul(b_last, alg.mul(next_row[ACT],
                                      alg.sub(one, local[ACT])))
        yield alg.mul(b_last, alg.sub(local[LST],
                                      alg.mul(local[ACT],
                                              alg.sub(one,
                                                      next_row[ACT]))))
        # RNG7 copy within a block
        rg = St([local[RNG7 + i] for i in range(7)])
        nrg = St([next_row[RNG7 + i] for i in range(7)])
        yield alg.mul(not_last, alg.sub(nrg, rg))

        # t binding: sum(T) = LST ? length : 128*(c+1)
        tval = self._sum0(alg.mul(tbits, self._pw2(alg)), alg)
        yield alg.sub(tval,
                      alg.add(alg.mul(local[LST], alg.lift(publics[0])),
                              alg.mul(alg.sub(one, local[LST]),
                                      t_full)))
        # last-chunk range: length - 128*c - 1 in [0, 127]
        rval = alg.zero()
        for i in range(7):
            rval = alg.add(rval, alg.mul(alg.constant(1 << i),
                                         local[RNG7 + i]))
        yield alg.mul(local[LST],
                      alg.sub(alg.lift(publics[0]),
                              alg.add(t_prev,
                                      alg.add(rval, one))))

    def first_row(self, alg, local, publics, consts=()):
        cs = []
        St = self._stack
        one = alg.one()

        # h register and v[0..8] start at IV ^ param
        for j in range(8):
            hj = H_INIT[j]
            for hh in range(2):
                cs.append(alg.sub(local[H + 2 * j + hh],
                                  alg.constant((hj >> (32 * hh)) & M32)))
                cs.append(alg.sub(local[V + 2 * j + hh],
                                  alg.constant((hj >> (32 * hh)) & M32)))
        for j in range(4):
            iv = int(_IV[j])
            cs.append(alg.sub(local[V + 2 * (8 + j)],
                              alg.constant(iv & M32)))
            cs.append(alg.sub(local[V + 2 * (8 + j) + 1],
                              alg.constant((iv >> 32) & M32)))
        tb = St([local[T + i] for i in range(32)])
        iv4 = int(_IV[4])
        v12lo = alg.zero()
        for i in range(32):
            from .air import index_group
            bit = index_group(tb, i)
            if (iv4 >> i) & 1:
                bit = alg.sub(one, bit)
            v12lo = alg.add(v12lo, alg.mul(alg.constant(1 << i), bit))
        cs.append(alg.sub(local[V + 24], v12lo))
        cs.append(alg.sub(local[V + 25], alg.constant((iv4 >> 32) & M32)))
        iv5 = int(_IV[5])
        cs.append(alg.sub(local[V + 26], alg.constant(iv5 & M32)))
        cs.append(alg.sub(local[V + 27], alg.constant((iv5 >> 32) & M32)))
        iv6 = int(_IV[6])
        for hh in range(2):
            v14 = alg.zero()
            for i in range(32):
                cbit = (iv6 >> (32 * hh + i)) & 1
                bit = alg.sub(one, local[LST]) if cbit else local[LST]
                v14 = alg.add(v14, alg.mul(alg.constant(1 << i), bit))
            cs.append(alg.sub(local[V + 28 + hh], v14))
        iv7 = int(_IV[7])
        cs.append(alg.sub(local[V + 30], alg.constant(iv7 & M32)))
        cs.append(alg.sub(local[V + 31], alg.constant((iv7 >> 32) & M32)))

        cs.append(alg.sub(local[ACT], one))
        return cs

    def last_row(self, alg, local, publics, consts=()):
        cs = [self._stack([alg.sub(local[H + i], alg.lift(publics[1 + i]))
                           for i in range(8)])]
        # if the final chunk is active it must be the last block
        cs.append(alg.sub(local[LST], local[ACT]))
        return cs

    # ------------------------------------------------------------------
    # Witness generation
    # ------------------------------------------------------------------

    def make_trace(self, msg: bytes, device=None):
        """msg: 1..128*max_chunks bytes. -> (trace on ``device``,
        publics[9], digest).

        The sequential Blake2b recurrence runs on Python ints (one G per
        row); column expansion (bit families, word halves) is vectorized
        numpy uint64 over all rows at once."""
        length = len(msg)
        assert 1 <= length <= 128 * self.max_chunks
        n_chunks = max(1, (length + 127) // 128)
        buf = msg + b"\x00" * (128 * self.num_blocks - length)
        n = self.n_rows
        nb = self.num_blocks

        v_rows = np.zeros((n, 16), dtype=np.uint64)
        h_rows = np.zeros((n, 8), dtype=np.uint64)
        m_blk = np.zeros((nb, 16), dtype=np.uint64)
        t_blk = np.zeros(nb, dtype=np.uint64)
        act_blk = np.zeros(nb, dtype=np.uint64)
        lst_blk = np.zeros(nb, dtype=np.uint64)
        rdf_blk = np.zeros(nb, dtype=np.uint64)
        REGS = ("rd", "rb", "a1", "c1", "a2", "c2", "d2", "b2", "rh", "bx")
        regs = {k: [0] * n for k in REGS}
        car = [[0] * n for _ in range(12)]

        def halves_add(*terms):
            slo = sum(tt & M32 for tt in terms)
            clo = slo >> 32
            shi = sum(tt >> 32 for tt in terms) + clo
            chi = shi >> 32
            return ((slo & M32) | ((shi & M32) << 32)), clo, chi

        h = list(H_INIT)
        for blk in range(nb):
            r0 = blk * N_ROWS
            active = blk < n_chunks
            is_last = blk == n_chunks - 1
            t = length if is_last else 128 * (blk + 1)
            m = [int.from_bytes(buf[128 * blk + 8 * i:128 * blk + 8 * i + 8],
                                "little") for i in range(16)]
            v = list(h) + [int(_IV[j]) for j in range(4)]
            v.append(int(_IV[4]) ^ t)
            v.append(int(_IV[5]))
            v.append(int(_IV[6]) ^ (M64 if is_last else 0))
            v.append(int(_IV[7]))
            m_blk[blk] = m
            t_blk[blk] = t
            act_blk[blk] = 1 if active else 0
            lst_blk[blk] = 1 if is_last else 0
            rdf_blk[blk] = (length - 128 * blk - 1) if is_last else 0

            hrow = list(h)
            for rr in range(N_ROWS):
                r = r0 + rr
                v_rows[r] = v
                h_rows[r] = hrow
                if rr < N_G_ROWS:
                    rnd, g = rr // 8, rr % 8
                    qa, qb, qc, qd = _quad(g)
                    s = _SIGMA[rnd % 10]
                    ra, rb_, rc, rd = v[qa], v[qb], v[qc], v[qd]
                    x, y = m[int(s[2 * g])], m[int(s[2 * g + 1])]
                    rh = 0
                elif rr < N_G_ROWS + N_FIN_ROWS:
                    j = rr - N_G_ROWS
                    ra = rc = x = y = 0
                    rd, rb_ = v[j], v[j + 8]
                    rh = hrow[j]
                else:
                    ra = rb_ = rc = rd = x = y = rh = 0

                a1, ca1lo, ca1hi = halves_add(ra, rb_, x)
                d1 = _rotr64(rd ^ a1, 32)
                c1, cc1lo, cc1hi = halves_add(rc, d1)
                b1 = _rotr64(rb_ ^ c1, 24)
                a2, ca2lo, ca2hi = halves_add(a1, b1, y)
                d2 = _rotr64(d1 ^ a2, 16)
                c2, cc2lo, cc2hi = halves_add(c1, d2)
                b2 = _rotr64(b1 ^ c2, 63)
                bxv = rh ^ rd ^ rb_
                for k, val in zip(REGS, (rd, rb_, a1, c1, a2, c2, d2, b2,
                                         rh, bxv)):
                    regs[k][r] = val
                for i, cb in enumerate((ca1lo & 1, ca1lo >> 1, ca1hi & 1,
                                        ca1hi >> 1, cc1lo, cc1hi,
                                        ca2lo & 1, ca2lo >> 1, ca2hi & 1,
                                        ca2hi >> 1, cc2lo, cc2hi)):
                    car[i][r] = cb

                if rr < N_G_ROWS:
                    v[qa], v[qb], v[qc], v[qd] = a2, b2, c2, d2
                elif rr < N_G_ROWS + N_FIN_ROWS and active:
                    hrow[j] = bxv

            if active:
                h = hrow

        # -- vectorized column expansion ----------------------------------
        cols = np.zeros((V_NUM_COLS, n), dtype=np.uint64)
        u32 = np.uint64(32)
        mm32 = np.uint64(M32)
        one = np.uint64(1)
        idx16 = 2 * np.arange(16)
        vT = v_rows.T                                    # (16, n)
        cols[V + idx16] = vT & mm32
        cols[V + idx16 + 1] = vT >> u32
        mT = np.repeat(m_blk, N_ROWS, axis=0).T          # (16, n)
        cols[MW + idx16] = mT & mm32
        cols[MW + idx16 + 1] = mT >> u32
        t_rows = np.repeat(t_blk, N_ROWS)
        sh32 = np.arange(32, dtype=np.uint64)[:, None]
        cols[T:T + 32] = (t_rows[None, :] >> sh32) & one
        idx8 = 2 * np.arange(8)
        hT = h_rows.T                                    # (8, n)
        cols[H + idx8] = hT & mm32
        cols[H + idx8 + 1] = hT >> u32
        cols[ACT] = np.repeat(act_blk, N_ROWS)
        cols[LST] = np.repeat(lst_blk, N_ROWS)
        sh7 = np.arange(7, dtype=np.uint64)[:, None]
        cols[RNG7:RNG7 + 7] = (np.repeat(rdf_blk, N_ROWS)[None, :]
                               >> sh7) & one
        sh64 = np.arange(64, dtype=np.uint64)[:, None]
        for base, k in ((BD, "rd"), (BB, "rb"), (BA1, "a1"), (BC1, "c1"),
                        (BA2, "a2"), (BC2, "c2"), (BD2, "d2"), (BB2, "b2"),
                        (BH, "rh"), (BX, "bx")):
            arr = np.array(regs[k], dtype=np.uint64)
            cols[base:base + 64] = (arr[None, :] >> sh64) & one
        for i in range(12):
            cols[CR + i] = np.array(car[i], dtype=np.uint64)

        digest = b"".join(h[j].to_bytes(8, "little") for j in range(4))
        publics = [length]
        for j in range(4):
            publics += [h[j] & M32, h[j] >> 32]
        trace = torch.from_numpy(cols.view(np.int64)).to(
            default_device(device))
        return trace, publics, digest
