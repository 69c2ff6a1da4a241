"""GF(2^255-19) arithmetic as AIR constraint gadgets (limb + carry chains).

The scalar building blocks of an Ed25519 AIR. Field elements are B-bit
limb columns (production B=16: a 2^16-row trace's LogUp row-ramp table
gives exactly 16-bit range checks; tests use B=8 on small traces — the
same code path). The grouped banks of ``gadget_vec`` are the vectorised
form the Ed25519 AIR uses; this module is the one-instance-per-row form.

Identity scheme (one row per operation instance): for c = a*b mod p,
witness c (canonical) and quotient q with  a*b - c - q*p = 0  over ZZ,
enforced coefficient-wise in base 2^B with a carry chain:

    s_k + t_{k-1} - 2^B * t_k = 0       (t_{-1} = t_last = 0)

where s_k are the convolution coefficients and each carry t_k is witnessed
as a shifted pair u0 + 2^tb * u1s - OFF with u0 range-checked to [0, 2^B)
and u1s a pre-scaled top limb (so the same row-ramp lookup table checks
both). All constraints are degree <= 3 even when the a/b inputs are
degree-1 selector blends.

Soundness: every term of each coefficient equation is bounded << p, so
the field equation forces the integer equation; the witnessed limbs are
range-checked via LogUp, so the integer reading is faithful.

Add/sub reduce their outputs to canonical form with a {0,1} correction
bit, so chained ops always see inputs < p.

Constraint emission is ring-generic (``alg.add/sub/mul/constant`` on
whatever the prover, the verifier or the recursion machine passes); the
witness fill writes exact ints into a (num_cols, n_rows) object array.
"""

from __future__ import annotations

from typing import List, Sequence

P25519 = (1 << 255) - 19
P_GOLDILOCKS = (1 << 64) - (1 << 32) + 1


def p_limbs(B: int) -> List[int]:
    L = -(-255 // B)
    return [(P25519 >> (B * i)) & ((1 << B) - 1) for i in range(L)]


class Allocator:
    """Sequential column allocator; tracks which columns are range-looked."""

    def __init__(self, start: int = 0):
        self.n = start
        self.lookups: List[int] = []

    def take(self, k: int, looked: bool = True) -> List[int]:
        idx = list(range(self.n, self.n + k))
        self.n += k
        if looked:
            self.lookups.extend(idx)
        return idx


def _int_to_limbs(v: int, nl: int, B: int) -> List[int]:
    return [(v >> (B * i)) & ((1 << B) - 1) for i in range(nl)]


def limbs_to_int(limbs: Sequence[int], B: int) -> int:
    return sum(int(l) << (B * i) for i, l in enumerate(limbs))


class _CarryChain:
    """Witness + constraints for  sum_k s_k 2^(Bk) = 0  with |s_k| < 2^sb.

    Each carry t_k is witnessed shifted (u = t + 2^off_bits) and decomposed
    into ceil(u_bits/B) limbs; every limb column is range-looked to
    [0, 2^B) — partial top limbs are stored pre-scaled by 2^(B - top_bits)
    so the same B-bit row-ramp table checks them.
    """

    def __init__(self, alloc: Allocator, n_coeffs: int, B: int, sb: int):
        self.B = B
        self.nc = n_coeffs - 1            # carries t_0 .. t_{n-2}
        self.off_bits = sb - B + 2        # |t| < 2^(sb-B+1)
        assert self.off_bits >= 1
        self.u_bits = self.off_bits + 1   # u = t + OFF in [0, 2^u_bits)
        self.n_limbs = -(-self.u_bits // B)
        self.top_bits = self.u_bits - B * (self.n_limbs - 1)
        self.top_scale = 1 << (B - self.top_bits)
        # limb j of carry k lives at self.ul[j][k]
        self.ul = [alloc.take(self.nc) for _ in range(self.n_limbs)]

    def t_expr(self, alg, local, k):
        u = None
        for j in range(self.n_limbs):
            col = local[self.ul[j][k]]
            if j == self.n_limbs - 1 and self.top_scale > 1:
                inv_scale = pow(self.top_scale, P_GOLDILOCKS - 2,
                                P_GOLDILOCKS)
                w = (inv_scale * (1 << (self.B * j))) % P_GOLDILOCKS
                term = alg.mul(alg.constant(w), col)
            elif j == 0:
                term = col
            else:
                term = alg.mul(alg.constant(1 << (self.B * j)), col)
            u = term if u is None else alg.add(u, term)
        return alg.sub(u, alg.constant(1 << self.off_bits))

    def constraints(self, alg, local, s_exprs: List):
        """s_exprs: list of n_coeffs ring elements. Returns constraints."""
        cs = []
        two_b = alg.constant(1 << self.B)
        t_prev = None
        for k in range(self.nc):
            t_k = self.t_expr(alg, local, k)
            e = s_exprs[k]
            if t_prev is not None:
                e = alg.add(e, t_prev)
            cs.append(alg.sub(e, alg.mul(two_b, t_k)))
            t_prev = t_k
        cs.append(alg.add(s_exprs[self.nc], t_prev))
        return cs

    def fill(self, cols, row, s_ints: List[int]):
        off = 1 << self.off_bits
        t = 0
        for k in range(self.nc):
            tot = s_ints[k] + t
            assert tot % (1 << self.B) == 0, "carry chain not exact"
            t = tot >> self.B
            u = t + off
            assert 0 <= u < (1 << self.u_bits), (k, t)
            for j in range(self.n_limbs):
                limb = (u >> (self.B * j)) & ((1 << self.B) - 1)
                if j == self.n_limbs - 1 and self.top_scale > 1:
                    limb = limb * self.top_scale
                cols[self.ul[j][k], row] = limb
        assert s_ints[self.nc] + t == 0, "final carry nonzero"


class FpMul:
    """c = a*b mod p (canonical c). b may be a compile-time constant."""

    def __init__(self, alloc: Allocator, B: int, b_const: int | None = None,
                 in_bits: int | None = None):
        self.B = B
        self.L = -(-255 // B)
        in_bits = in_bits if in_bits is not None else B
        # a*b < 2^(in_bits*L + B*L); q*p covers it
        self.LQ = -(-((2 * self.L * B + 2) - 254) // B) + 1
        self.b_const = b_const
        self.bc_limbs = (_int_to_limbs(b_const, self.L, B)
                         if b_const is not None else None)
        self.c = alloc.take(self.L)
        self.q = alloc.take(self.LQ)
        n_coeffs = max(2 * self.L - 1, self.LQ + self.L - 1)
        # |s_k| <= max(L, LQ) * 2^(in_bits + B) (+ c term, negligible)
        sb = in_bits + B + (max(self.L, self.LQ) - 1).bit_length() + 1
        self.chain = _CarryChain(alloc, n_coeffs, B, sb)
        self.n_coeffs = n_coeffs

    def constraints(self, alg, local, a: List, b: List | None = None):
        """a (and b unless b_const): lists of L ring elements (limbs)."""
        pl = p_limbs(self.B)
        s = []
        for k in range(self.n_coeffs):
            e = None

            def acc(x, term):
                return term if x is None else alg.add(x, term)

            for i in range(max(0, k - self.L + 1), min(self.L, k + 1)):
                j = k - i
                if self.bc_limbs is not None:
                    if self.bc_limbs[j]:
                        e = acc(e, alg.mul(a[i],
                                           alg.constant(self.bc_limbs[j])))
                else:
                    e = acc(e, alg.mul(a[i], b[j]))
            if k < self.L:
                e = acc(e, alg.sub(alg.zero(), local[self.c[k]]))
            for i in range(max(0, k - self.L + 1), min(self.LQ, k + 1)):
                j = k - i
                if pl[j]:
                    e = acc(e, alg.sub(alg.zero(),
                                       alg.mul(local[self.q[i]],
                                               alg.constant(pl[j]))))
            s.append(e if e is not None else alg.zero())
        return self.chain.constraints(alg, local, s)

    def fill(self, cols, row, a_int: int, b_int: int | None = None) -> int:
        b_val = self.b_const if self.b_const is not None else b_int
        ab = a_int * b_val
        c = ab % P25519
        q = ab // P25519
        cl = _int_to_limbs(c, self.L, self.B)
        ql = _int_to_limbs(q, self.LQ, self.B)
        assert limbs_to_int(ql, self.B) == q, "q overflow"
        for i, v in enumerate(cl):
            cols[self.c[i], row] = v
        for i, v in enumerate(ql):
            cols[self.q[i], row] = v
        al = _int_to_limbs(a_int, self.L, self.B)
        bl = _int_to_limbs(b_val, self.L, self.B)
        pl = p_limbs(self.B)
        s = []
        for k in range(self.n_coeffs):
            v = 0
            for i in range(max(0, k - self.L + 1), min(self.L, k + 1)):
                v += al[i] * bl[k - i]
            if k < self.L:
                v -= cl[k]
            for i in range(max(0, k - self.L + 1), min(self.LQ, k + 1)):
                v -= ql[i] * pl[k - i]
            s.append(v)
        self.chain.fill(cols, row, s)
        return c

    def c_limbs(self, local) -> List:
        return [local[i] for i in self.c]


class FpAddSub:
    """d = x + sign*y mod p, canonical d, correction bit s: x+sign*y+corr."""

    def __init__(self, alloc: Allocator, B: int, sign: int):
        self.B = B
        self.L = -(-255 // B)
        self.sign = sign                 # +1 add, -1 sub
        self.d = alloc.take(self.L)
        self.s_bit = alloc.take(1, looked=False)[0]
        # coefficients |s_k| < 4 * 2^B
        self.chain = _CarryChain(alloc, self.L, B, B + 3)

    def constraints(self, alg, local, x: List, y: List):
        pl = p_limbs(self.B)
        sb = local[self.s_bit]
        cs = [alg.sub(alg.mul(sb, sb), sb)]     # boolean
        s = []
        for k in range(self.L):
            if self.sign > 0:
                e = alg.add(x[k], y[k])          # x + y - s*p - d
                e = alg.sub(e, alg.mul(sb, alg.constant(pl[k])))
            else:
                e = alg.sub(x[k], y[k])          # x - y + s*p - d
                e = alg.add(e, alg.mul(sb, alg.constant(pl[k])))
            s.append(alg.sub(e, local[self.d[k]]))
        return cs + self.chain.constraints(alg, local, s)

    def fill(self, cols, row, x_int: int, y_int: int) -> int:
        if self.sign > 0:
            tot = x_int + y_int
            s = 1 if tot >= P25519 else 0
            d = tot - s * P25519
        else:
            tot = x_int - y_int
            s = 1 if tot < 0 else 0
            d = tot + s * P25519
        assert 0 <= d < P25519
        cols[self.s_bit, row] = s
        dl = _int_to_limbs(d, self.L, self.B)
        for i, v in enumerate(dl):
            cols[self.d[i], row] = v
        xl = _int_to_limbs(x_int, self.L, self.B)
        yl = _int_to_limbs(y_int, self.L, self.B)
        pl = p_limbs(self.B)
        sv = []
        for k in range(self.L):
            if self.sign > 0:
                v = xl[k] + yl[k] - s * pl[k] - dl[k]
            else:
                v = xl[k] - yl[k] + s * pl[k] - dl[k]
            sv.append(v)
        self.chain.fill(cols, row, sv)
        return d

    def d_limbs(self, local) -> List:
        return [local[i] for i in self.d]
