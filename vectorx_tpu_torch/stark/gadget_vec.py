"""Vectorized GF(2^255-19) AIR gadgets — grouped tensor constraint form.

An Ed25519 verify row needs ~20 field-op instances; one constraint per limb
coefficient would be thousands of scalar constraints. This module batches
M structurally identical instances into ONE grouped constraint tensor
(leading instance/coefficient axes; prover._combine assigns each member its
own α), so a whole bank of field muls is a handful of tensor ops.

The scheme is starkyx-style limb arithmetic: for c = a·b mod p witness c
and quotient q with a·b − c − q·p = 0 over ZZ, enforced base-2^B
coefficient-wise with an offset-witnessed carry chain; limbs are
range-checked against the row-ramp LogUp table (B = log2(n_rows)).

- **Grouped emission**: constraints/operands carry (M, limb, domain) axes
  and work in both constraint rings (BaseVecAlgebra LDE vectors and
  ExtAlgebra ζ scalars). A base element is one int64 tensor, an extension
  element a ``(re, im)`` tuple (stark/air.py); the ``t_*`` helpers map over
  the tuple for the latter.
- **Limb-expression operands**: mul inputs may be linear combinations of
  witnessed limb columns plus constants (e.g. X+Y, or yy + 4p − xx with
  the 4p offset keeping the integer value non-negative); per-limb
  magnitude bounds are tracked in the spec and sized into the carry chain.
- **LinZero / Canon banks**: Σ signed-limb-exprs + (k − OFS)·p = 0 with a
  small witnessed k (equality mod p, on-curve checks, negation), and
  x ≤ p − 1 canonicity (witnessed complement), both grouped.

The fill side (``fill`` on Python ints, ``fill_vec`` on numpy int64 rows)
writes an int64 numpy column matrix; it is host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl

P25519 = (1 << 255) - 19
P_G = gl.MODULUS


# ---------------------------------------------------------------------------
# Ring-generic grouped-tree helpers (BaseVecAlgebra and ExtAlgebra elements)
# ---------------------------------------------------------------------------

def is_ext(e) -> bool:
    return isinstance(e, tuple)


def t_map(f, *es):
    """f over the component tensors: once for base elements, once per
    component (re, im) for extension elements."""
    if is_ext(es[0]):
        return (f(*[e[0] for e in es]), f(*[e[1] for e in es]))
    return f(*es)


def _device(e) -> torch.device:
    return (e[0] if is_ext(e) else e).device


def t_stack(elems):
    return t_map(lambda *xs: torch.stack(xs), *elems)


def t_gather(local, idx: np.ndarray):
    """Gather trace-column ring elements by a numpy index array; the index
    shape becomes the leading group axes of the result. ``local`` is either
    the per-column element list (stacked here) or an already-stacked ring
    element with columns on axis 0: then ONE tensor index with a LongTensor
    on the element's device (build it once per transition with
    t_stack(local))."""
    if not isinstance(local, list):
        ix = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(
            _device(local))
        return t_map(lambda x: x[ix], local)
    stacked = t_stack([local[int(i)] for i in idx.reshape(-1)])
    return t_map(lambda x: x.reshape(tuple(idx.shape) + x.shape[1:]), stacked)


def t_index1(e, i: int):
    """e[:, i:i+1, ...] along axis 1 (keepdim)."""
    return t_map(lambda x: x[:, i:i + 1], e)


def t_pad1(e, before: int, after: int):
    """Zero-pad along axis 1."""
    def f(x):
        return torch.nn.functional.pad(x, [0, 0] * (x.dim() - 2)
                                       + [before, after])
    return t_map(f, e)


def t_expand1(e):
    """Insert a size-1 axis at position 1."""
    return t_map(lambda x: x[:, None], e)


def gsum(e, axis: int = 0):
    """Modular sum over a group axis."""
    return t_map(lambda x: gl.sum_mod(x, axis=axis), e)


def vconst(vals, like):
    """Integer array -> ring constant broadcastable against ``like``, on
    its device.

    ``vals`` (numpy/list of Python ints, any shape) is reduced mod the
    Goldilocks prime; in the base ring one trailing domain axis is
    appended for broadcasting."""
    fp = gl.to_fp(np.asarray(vals, dtype=np.object_), _device(like))
    if is_ext(like):
        return (fp, torch.zeros_like(fp))
    return fp[..., None]


def limbs_top(v: int, L: int, B: int) -> List[int]:
    """v -> L limbs base 2^B; the TOP limb absorbs any excess (so constants
    slightly above 2^(B·L), e.g. 4p at B·L = 256, keep exact value)."""
    assert v >= 0
    out = [(v >> (B * i)) & ((1 << B) - 1) for i in range(L - 1)]
    out.append(v >> (B * (L - 1)))
    return out


def limbs_to_int(limbs: Sequence[int], B: int) -> int:
    return sum(int(v) << (B * i) for i, v in enumerate(limbs))


def p_limbs(B: int, L: int) -> List[int]:
    return limbs_top(P25519, L, B)


# ---------------------------------------------------------------------------
# Symbolic limb expressions (constraint side) + exact int mirror (fill side)
# ---------------------------------------------------------------------------

@dataclass
class Lin:
    """Linear combination of limb banks:  Σ coef_t · limbs_t  + const.

    ``terms``: list of (int coef, grouped (M, L, ...) ring element).
    ``const``: non-negative integer added (spread with limbs_top).
    ``limb_max``: caller-asserted max |per-limb integer value| — sized
    into the consuming gadget's carry chain."""
    terms: List[Tuple[int, Any]]
    const: int
    limb_max: int

    def eval(self, alg, L: int, B: int):
        """-> (L, ...) ring element (per-instance; bank stacks instances).
        A negative coefficient enters as coef mod p."""
        acc = None
        for coef, e in self.terms:
            t = e if coef == 1 else alg.mul(alg.constant(coef % P_G), e)
            acc = t if acc is None else alg.add(acc, t)
        if self.const:
            cl = vconst(np.asarray(limbs_top(self.const, L, B),
                                   dtype=np.object_), acc)
            acc = alg.add(acc, cl)
        return acc


def lin(terms, const: int = 0, limb_max: int | None = None) -> Lin:
    if limb_max is None:
        limb_max = 1 << 20  # generous default; spec asserts headroom
    return Lin(list(terms), const, limb_max)


def lin_limbs_int(terms_limbs: List[Tuple[int, Sequence[int]]], const: int,
                  L: int, B: int) -> List[int]:
    """Fill-side mirror of Lin.eval: exact signed per-limb integers."""
    out = limbs_top(const, L, B) if const else [0] * L
    for coef, limbs in terms_limbs:
        for i in range(L):
            out[i] += coef * int(limbs[i])
    return out


# ---------------------------------------------------------------------------
# Column allocator
# ---------------------------------------------------------------------------

class AllocV:
    def __init__(self, start: int = 0):
        self.n = start
        self.lookups: List[int] = []

    def take_np(self, shape, looked: bool = True) -> np.ndarray:
        k = int(np.prod(shape))
        idx = np.arange(self.n, self.n + k).reshape(shape)
        self.n += k
        if looked:
            self.lookups.extend(range(self.n - k, self.n))
        return idx


# ---------------------------------------------------------------------------
# Carry chain (vectorized across instances and coefficients)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainSpec:
    B: int
    n_coeffs: int
    sb: int                  # |s_k| < 2^sb

    @property
    def nc(self) -> int:
        return self.n_coeffs - 1

    @property
    def off_bits(self) -> int:
        return self.sb - self.B + 2

    @property
    def u_bits(self) -> int:
        return self.off_bits + 1

    @property
    def n_limbs(self) -> int:
        return -(-self.u_bits // self.B)

    @property
    def top_bits(self) -> int:
        return self.u_bits - self.B * (self.n_limbs - 1)

    @property
    def top_scale(self) -> int:
        return 1 << (self.B - self.top_bits)


class ChainBank:
    """Witness + grouped constraints for  Σ_k s_k 2^(Bk) = 0, per instance.

    Soundness: |s_k| < 2^sb and |carry| < 2^(sb-B+1); every term of the
    per-coefficient field equation is << p (spec asserts sb + 3 < 63), so
    the Goldilocks equations force the integer identity; carry limbs are
    LogUp range-checked (top limbs pre-scaled so one B-bit table serves)."""

    def __init__(self, alloc: AllocV, M: int, spec: ChainSpec):
        assert spec.off_bits >= 1 and spec.sb + 3 < 63, spec
        self.spec = spec
        self.M = M
        self.ul = alloc.take_np((M, spec.n_limbs, spec.nc))

    def _weights(self) -> List[int]:
        s = self.spec
        w = []
        for j in range(s.n_limbs):
            wj = 1 << (s.B * j)
            if j == s.n_limbs - 1 and s.top_scale > 1:
                wj = (pow(s.top_scale, P_G - 2, P_G) * wj) % P_G
            w.append(wj)
        return w

    def t_vals(self, alg, local, insts=None):
        """-> grouped (m, nc, ...) carry values t_k (instance subset)."""
        s = self.spec
        ul = self.ul if insts is None else self.ul[list(insts)]
        U = t_gather(local, ul)                          # (m, n_limbs, nc, ..)
        W = vconst(np.asarray(self._weights(),
                              dtype=np.object_).reshape(1, s.n_limbs, 1), U)
        T = gsum(alg.mul(W, U), axis=1)                  # (m, nc, ...)
        return alg.sub(T, alg.constant(1 << s.off_bits))

    def constraints(self, alg, local, S, sel=None, insts=None) -> List:
        """S: grouped (m, n_coeffs, ...) coefficient expressions.
        Emits ONE grouped constraint (m, n_coeffs, ...)."""
        s = self.spec
        T = self.t_vals(alg, local, insts=insts)
        T0 = t_pad1(T, 0, 1)                             # t_k,   k=0..nc
        Tm1 = t_pad1(T, 1, 0)                            # t_{k-1}
        c = alg.sub(alg.add(S, Tm1), alg.mul(alg.constant(1 << s.B), T0))
        if sel is not None:
            c = alg.mul(sel, c)
        return [c]

    def fill(self, cols: np.ndarray, row: int, m: int, s_ints: List[int]):
        s = self.spec
        off = 1 << s.off_bits
        t = 0
        for k in range(s.nc):
            tot = s_ints[k] + t
            assert tot % (1 << s.B) == 0, "carry chain not exact"
            t = tot >> s.B
            u = t + off
            assert 0 <= u < (1 << s.u_bits), (k, t, s)
            for j in range(s.n_limbs):
                limb = (u >> (s.B * j)) & ((1 << s.B) - 1)
                if j == s.n_limbs - 1 and s.top_scale > 1:
                    limb *= s.top_scale
                cols[self.ul[m, j, k], row] = limb
        assert s_ints[s.nc] + t == 0, "final carry nonzero"

    def fill_vec(self, cols: np.ndarray, rows: np.ndarray, m: int,
                 S: np.ndarray):
        """Row-batched fill: S (R, n_coeffs) int64 coefficient values."""
        s = self.spec
        off = 1 << s.off_bits
        mask = (1 << s.B) - 1
        t = np.zeros(len(rows), dtype=np.int64)
        for k in range(s.nc):
            tot = S[:, k] + t
            assert not (tot & mask).any(), "carry chain not exact"
            t = tot >> s.B
            u = t + off
            assert (u >= 0).all() and (u < (1 << s.u_bits)).all(), (k, s)
            for j in range(s.n_limbs):
                limb = (u >> (s.B * j)) & mask
                if j == s.n_limbs - 1 and s.top_scale > 1:
                    limb = limb * s.top_scale
                cols[self.ul[m, j, k], rows] = limb
        assert not (S[:, s.nc] + t).any(), "final carry nonzero"


def ints_to_limb_mat(vals: Sequence[int], L: int, B: int) -> np.ndarray:
    """Python bigints -> (R, L) int64 limb matrix."""
    arr = np.asarray(list(vals), dtype=np.object_)
    mask = (1 << B) - 1
    out = np.empty((len(arr), L), dtype=np.int64)
    for i in range(L):
        out[:, i] = ((arr >> (B * i)) & mask).astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# MulBank — M instances of c = a·b mod p, grouped
# ---------------------------------------------------------------------------

def _mul_spec(B: int, L: int, a_lm: int, b_lm: int) -> Tuple[int, int, ChainSpec]:
    """-> (LQ, n_coeffs, chain spec) for per-limb magnitudes a_lm/b_lm."""
    geo = ((1 << (B * L)) - 1) // ((1 << B) - 1)
    a_max = a_lm * geo
    b_max = b_lm * geo
    q_max = (a_max * b_max) // P25519
    LQ = max(1, -(-q_max.bit_length() // B))
    n_coeffs = max(2 * L - 1, LQ + L - 1)
    s_max = (L * a_lm * b_lm + (1 << B)
             + min(LQ, L + 1) * ((1 << B) - 1) * (1 << (B + 2)))
    sb = s_max.bit_length() + 1
    return LQ, n_coeffs, ChainSpec(B, n_coeffs, sb)


class MulBank:
    """M field-mul instances sharing one spec; per row type, bind operands
    and gate by that row's selector. Operands are Lin limb expressions (a
    plain grouped element works via lin([(1, e)], limb_max=2^B-1))."""

    def __init__(self, alloc: AllocV, B: int, M: int,
                 a_limb_max: int, b_limb_max: int):
        self.B, self.M = B, M
        self.L = -(-255 // B)
        self.a_lm, self.b_lm = a_limb_max, b_limb_max
        self.LQ, self.n_coeffs, chain_spec = _mul_spec(
            B, self.L, a_limb_max, b_limb_max)
        self.c = alloc.take_np((M, self.L))
        self.q = alloc.take_np((M, self.LQ))
        self.chain = ChainBank(alloc, M, chain_spec)
        self._pl = p_limbs(B, self.L)

    # -- constraint side ----------------------------------------------------

    def _conv(self, alg, A, Bv):
        """S[m, k] = Σ_{i+j=k} A[m,i]·B[m,j], padded to n_coeffs."""
        Lb = None
        out = None
        for i in range(self.L):
            prod = alg.mul(t_index1(A, i), Bv)
            if Lb is None:
                Lb = (prod[0] if is_ext(prod) else prod).shape[1]
            pp = t_pad1(prod, i, self.n_coeffs - Lb - i)
            out = pp if out is None else alg.add(out, pp)
        return out

    def _conv_const(self, alg, A, bl_matrix: np.ndarray, La: int):
        """S[m, k] = Σ_j A[m, k-j] · bl_matrix[m, j] (per-instance consts)."""
        out = None
        mm, Lb = bl_matrix.shape
        for j in range(Lb):
            col = bl_matrix[:, j]
            if not any(int(v) for v in col):
                continue
            cj = vconst(np.asarray(col, dtype=np.object_).reshape(mm, 1), A)
            prod = alg.mul(A, cj)
            pp = t_pad1(prod, j, self.n_coeffs - La - j)
            out = pp if out is None else alg.add(out, pp)
        return out

    def constraints(self, alg, local, a_lins: List[Lin],
                    b_lins: List[Lin] | None = None,
                    b_consts: Sequence[int] | None = None, sel=None,
                    insts: Sequence[int] | None = None) -> List:
        """Emit the grouped a·b − c − q·p carry-chain constraint family.

        ``a_lins``: one Lin per bound instance over (L, ...) elements (plain
        gathered limb columns or offset expressions); either ``b_lins`` or
        ``b_consts`` (one compile-time constant per instance) binds b.
        ``insts``: bank instance indices bound by this call (default: all) —
        lets disjoint row types bind different operands to shared banks."""
        insts = list(range(self.M)) if insts is None else list(insts)
        m = len(insts)
        assert len(a_lins) == m
        for ln in a_lins:
            assert ln.limb_max <= self.a_lm, (ln.limb_max, self.a_lm)
        Ae = t_stack([ln.eval(alg, self.L, self.B) for ln in a_lins])
        if b_consts is not None:
            blm = np.asarray([limbs_top(int(b) % P25519, self.L, self.B)
                              for b in b_consts], dtype=np.object_)
            S = self._conv_const(alg, Ae, blm, self.L)
        else:
            assert len(b_lins) == m
            for ln in b_lins:
                assert ln.limb_max <= self.b_lm, (ln.limb_max, self.b_lm)
            Be = t_stack([ln.eval(alg, self.L, self.B) for ln in b_lins])
            S = self._conv(alg, Ae, Be)
        C = t_gather(local, self.c[insts])
        S = alg.sub(S, t_pad1(C, 0, self.n_coeffs - self.L))
        Q = t_gather(local, self.q[insts])
        pl_m = np.asarray([self._pl] * m, dtype=np.object_)
        S = alg.sub(S, self._conv_const(alg, Q, pl_m, self.LQ))
        return self.chain.constraints(alg, local, S, sel=sel, insts=insts)

    def c_inst(self, local, m: int):
        """(L, ...) output limbs of instance m."""
        return t_gather(local, self.c[m])

    def c_lin(self, local, m: int) -> Lin:
        return lin([(1, self.c_inst(local, m))], limb_max=(1 << self.B) - 1)

    # -- fill side ------------------------------------------------------------

    def fill(self, cols: np.ndarray, row: int, m: int,
             a_limbs: Sequence[int], b_limbs: Sequence[int] | None = None,
             b_const: int | None = None) -> int:
        """a_limbs/b_limbs: exact signed per-limb ints of the bound
        expressions. Returns c = a·b mod p (canonical)."""
        B, L = self.B, self.L
        a_val = limbs_to_int(a_limbs, B)
        if b_const is not None:
            bl = limbs_top(int(b_const) % P25519, L, B)
        else:
            bl = list(b_limbs)
        b_val = limbs_to_int(bl, B)
        assert a_val >= 0 and b_val >= 0, "operand value must be >= 0"
        ab = a_val * b_val
        c = ab % P25519
        q = ab // P25519
        cl = [(c >> (B * i)) & ((1 << B) - 1) for i in range(L)]
        ql = [(q >> (B * i)) & ((1 << B) - 1) for i in range(self.LQ)]
        assert limbs_to_int(ql, B) == q, "q overflow"
        for i, v in enumerate(cl):
            cols[self.c[m, i], row] = v
        for i, v in enumerate(ql):
            cols[self.q[m, i], row] = v
        s = []
        for k in range(self.n_coeffs):
            v = 0
            for i in range(max(0, k - L + 1), min(L, k + 1)):
                v += int(a_limbs[i]) * int(bl[k - i])
            if k < L:
                v -= cl[k]
            for i in range(max(0, k - L + 1), min(self.LQ, k + 1)):
                j = k - i
                if j < L and self._pl[j]:
                    v -= ql[i] * self._pl[j]
            s.append(v)
        self.chain.fill(cols, row, m, s)
        return c

    def fill_vec(self, cols: np.ndarray, rows: np.ndarray, m: int,
                 a_limbs: np.ndarray, a_vals: Sequence[int],
                 b_limbs: np.ndarray | None = None,
                 b_vals: Sequence[int] | None = None,
                 b_const: int | None = None) -> List[int]:
        """Row-batched fill for instance m over trace rows ``rows``.

        a_limbs: (R, L) int64 signed per-limb expression values;
        a_vals: exact Python-int values (bigints stay host-side scalars,
        everything limb-wise is vectorized numpy int64). Returns c values."""
        B, L = self.B, self.L
        R = len(rows)
        if b_const is not None:
            bc = int(b_const) % P25519
            b_limbs = np.tile(np.asarray(limbs_top(bc, L, B),
                                         dtype=np.int64), (R, 1))
            b_vals = [bc] * R
        c_vals, q_vals = [], []
        for av, bv in zip(a_vals, b_vals):
            ab = int(av) * int(bv)
            c_vals.append(ab % P25519)
            q_vals.append(ab // P25519)
        cl = ints_to_limb_mat(c_vals, L, B)
        ql = ints_to_limb_mat(q_vals, self.LQ, B)
        assert max(q_vals).bit_length() <= B * self.LQ, "q overflow"
        for i in range(L):
            cols[self.c[m, i], rows] = cl[:, i]
        for i in range(self.LQ):
            cols[self.q[m, i], rows] = ql[:, i]
        S = np.zeros((R, self.n_coeffs), dtype=np.int64)
        for i in range(L):
            S[:, i:i + L] += a_limbs[:, i:i + 1] * b_limbs
        S[:, :L] -= cl
        plv = np.asarray(self._pl, dtype=np.int64)
        for i in range(self.LQ):
            S[:, i:i + L] -= ql[:, i:i + 1] * plv
        self.chain.fill_vec(cols, rows, m, S)
        return c_vals


# ---------------------------------------------------------------------------
# LinZeroBank — Σ v_t + (k − OFS)·p = 0 with small witnessed k
# ---------------------------------------------------------------------------

class LinZeroBank:
    """M instances proving a signed limb expression ≡ 0 mod p.

    k = Σ 2^i bits − OFS ranges over [−OFS, 2^nk − 1 − OFS]; the caller's
    expression integer value must satisfy value = (OFS − k')·p for some
    representable k'. Used for: equality mod p, on-curve checks, point
    negation."""

    def __init__(self, alloc: AllocV, B: int, M: int, s_limb_max: int,
                 nk_bits: int = 3, ofs: int = 3):
        self.B, self.M = B, M
        self.L = -(-255 // B)
        self.nk, self.ofs = nk_bits, ofs
        self.s_lm = s_limb_max
        self.bits = alloc.take_np((M, nk_bits), looked=False)
        smax = s_limb_max + ((1 << nk_bits) + ofs) * (1 << (B + 2))
        self.chain = ChainBank(alloc, M, ChainSpec(B, self.L,
                                                   smax.bit_length() + 1))
        self._pl = p_limbs(B, self.L)

    def constraints(self, alg, local, s_lins: List[Lin], sel=None,
                    insts: Sequence[int] | None = None) -> List:
        insts = list(range(self.M)) if insts is None else list(insts)
        assert len(s_lins) == len(insts)
        for ln in s_lins:
            assert ln.limb_max <= self.s_lm, (ln.limb_max, self.s_lm)
        bits = t_gather(local, self.bits[insts])         # (m, nk, ...)
        cs = []
        cbool = alg.sub(alg.mul(bits, bits), bits)
        if sel is not None:
            cbool = alg.mul(sel, cbool)
        cs.append(cbool)
        pw = vconst(np.asarray([1 << i for i in range(self.nk)],
                               dtype=np.object_).reshape(1, self.nk), bits)
        k_val = gsum(alg.mul(pw, bits), axis=1)          # (M, ...)
        k_val = alg.sub(k_val, alg.constant(self.ofs))
        kp = alg.mul(t_expand1(k_val),
                     vconst(np.asarray(self._pl,
                                       dtype=np.object_).reshape(1, self.L),
                            t_expand1(k_val)))           # (M, L, ...)
        S = t_stack([ln.eval(alg, self.L, self.B) for ln in s_lins])
        Se = alg.add(S, kp)
        cs += self.chain.constraints(alg, local, Se, sel=sel, insts=insts)
        return cs

    def fill(self, cols: np.ndarray, row: int, m: int,
             s_limbs: Sequence[int]):
        v = limbs_to_int(s_limbs, self.B)
        assert v % P25519 == 0, "LinZero expression not ≡ 0 mod p"
        k = -(v // P25519)
        kb = k + self.ofs
        assert 0 <= kb < (1 << self.nk), (k, self.ofs, self.nk)
        for i in range(self.nk):
            cols[self.bits[m, i], row] = (kb >> i) & 1
        s = [int(s_limbs[i]) + k * self._pl[i] for i in range(self.L)]
        self.chain.fill(cols, row, m, s)

    def fill_vec(self, cols: np.ndarray, rows: np.ndarray, m: int,
                 S: np.ndarray, vals: Sequence[int]):
        """S: (R, L) int64 signed limb values; vals: exact Python ints."""
        k = np.asarray([-(int(v) // P25519) for v in vals], dtype=np.int64)
        kb = k + self.ofs
        assert (kb >= 0).all() and (kb < (1 << self.nk)).all()
        for i in range(self.nk):
            cols[self.bits[m, i], rows] = (kb >> i) & 1
        S2 = S + k[:, None] * np.asarray(self._pl, dtype=np.int64)
        self.chain.fill_vec(cols, rows, m, S2)


# ---------------------------------------------------------------------------
# CanonBank — x ≤ p − 1 via witnessed complement
# ---------------------------------------------------------------------------

class CanonBank:
    """M instances of canonicity: witness diff with x + diff = p − 1 over
    ZZ (diff limbs range-checked ⇒ diff ≥ 0 ⇒ x < p). Needed wherever a
    witnessed field element's PARITY or byte encoding is constrained."""

    def __init__(self, alloc: AllocV, B: int, M: int):
        self.B, self.M = B, M
        self.L = -(-255 // B)
        self.diff = alloc.take_np((M, self.L))
        self.chain = ChainBank(alloc, M, ChainSpec(B, self.L, B + 3))
        self._pm1 = limbs_top(P25519 - 1, self.L, B)

    def constraints(self, alg, local, xs: List, sel=None) -> List:
        """xs: list of M per-instance (L, ...) witnessed limb elements."""
        X = t_stack(xs)
        D = t_gather(local, self.diff)
        pm1 = vconst(np.asarray(self._pm1,
                                dtype=np.object_).reshape(1, self.L), D)
        S = alg.sub(alg.add(X, D), pm1)
        return self.chain.constraints(alg, local, S, sel=sel)

    def fill(self, cols: np.ndarray, row: int, m: int, x_int: int):
        assert 0 <= x_int < P25519
        d = P25519 - 1 - x_int
        dl = [(d >> (self.B * i)) & ((1 << self.B) - 1) for i in range(self.L)]
        for i, v in enumerate(dl):
            cols[self.diff[m, i], row] = v
        xl = [(x_int >> (self.B * i)) & ((1 << self.B) - 1)
              for i in range(self.L)]
        s = [xl[i] + dl[i] - self._pm1[i] for i in range(self.L)]
        self.chain.fill(cols, row, m, s)

    def fill_vec(self, cols: np.ndarray, rows: np.ndarray, m: int,
                 x_vals: Sequence[int]):
        d_vals = [P25519 - 1 - int(x) for x in x_vals]
        assert min(d_vals) >= 0
        dl = ints_to_limb_mat(d_vals, self.L, self.B)
        xl = ints_to_limb_mat(x_vals, self.L, self.B)
        for i in range(self.L):
            cols[self.diff[m, i], rows] = dl[:, i]
        S = xl + dl - np.asarray(self._pm1, dtype=np.int64)
        self.chain.fill_vec(cols, rows, m, S)
