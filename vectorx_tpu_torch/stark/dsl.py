"""L5 frontend: a typed column/constraint builder for authoring AIRs.

Circuit authors declare typed variables (bytes, u32 words, 32-byte
arrays) and compose builder operations on them; this module turns that
into a row-transition AIR — typed column FAMILIES with automatic
well-formedness constraints, and expression combinators that compile to
the degree-≤3 constraint classes of ``stark.air.Air``.

Usage:

    b = AirBuilder(num_publics=24)
    s  = b.felts("s", 12)            # base-field columns
    ph = b.bits("ph", 32)            # booleanity auto-constrained
    v  = b.u32("bn")                 # 4 byte columns + recomposition

    @b.transition
    def _(ctx):
        ctx.eq(ctx.nxt(s[0]), ctx.cur(s[1]))        # a' = b
        ...

    air = b.build()                  # a stark.air.Air instance

Expressions are operator-overloaded (`+ - *`, int constants lift through
``alg.constant``) and evaluate over whatever ring they are given: the
prover's base-field tensors over an LDE window, the verifier's extension
algebra at ζ, and the recursion machine's ring (``recursion_air.XAlgMB``)
— so a DSL-authored AIR proves, verifies and recurses like a hand-written
one. ``air_poseidon_dsl.py`` re-authors the Poseidon chain AIR with the
same trace layout and constraint order.

Boundary rows have no next row: ``ctx.nxt`` (or ``Col.nxt``) inside a
``first_row``, ``last_row`` or ``every_row`` function raises ValueError
when that boundary class evaluates (the JAX package reads the current
row there instead; no AIR in use calls it, so no proof differs).

Well-formedness the families add automatically:
  bit   — b·(b−1) = 0 on every row
  u8    — 8 bit columns + linear recomposition to the value column
  u16   — 16 bit columns + recomposition (the limb type of the
          GF(2^255−19) gadgets)
  u32   — 4 u8 families + little-endian byte recomposition
  bytes32 — 32 u8 families
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..field import goldilocks as gl
from .air import Air

P = gl.MODULUS

_NO_NEXT = ("ctx.nxt() reads the next row, which only a transition has "
            "(first_row, last_row and every_row see one row)")


# ---------------------------------------------------------------------------
# Expressions — deferred evaluation over an arbitrary constraint algebra
# ---------------------------------------------------------------------------


class Expr:
    """A ring expression; `f(env) -> ring element` where env carries the
    algebra and the row accessors. Build with + - * and the Ctx helpers;
    ints lift to field constants."""

    __slots__ = ("f",)

    def __init__(self, f: Callable):
        self.f = f

    @staticmethod
    def _lift(v) -> "Expr":
        if isinstance(v, Expr):
            return v
        if isinstance(v, int):
            return Expr(lambda env, c=v % P: env.alg.constant(c))
        raise TypeError(f"cannot lift {type(v)} into an AIR expression")

    def __add__(self, o):
        o = Expr._lift(o)
        return Expr(lambda env: env.alg.add(self.f(env), o.f(env)))

    __radd__ = __add__

    def __sub__(self, o):
        o = Expr._lift(o)
        return Expr(lambda env: env.alg.sub(self.f(env), o.f(env)))

    def __rsub__(self, o):
        return Expr._lift(o).__sub__(self)

    def __mul__(self, o):
        o = Expr._lift(o)
        return Expr(lambda env: env.alg.mul(self.f(env), o.f(env)))

    __rmul__ = __mul__

    def __neg__(self):
        return Expr(lambda env: env.alg.sub(env.alg.zero(), self.f(env)))


def _next_of(rows, i: int):
    if rows is None:
        raise ValueError(_NO_NEXT)
    return rows[i]


@dataclass(frozen=True)
class Col:
    """A typed column handle. `kind` is documentation + well-formedness
    marker; `idx` is the committed-trace column index."""

    name: str
    idx: int
    kind: str                      # 'felt' | 'bit' | const kinds

    def cur(self) -> Expr:
        return Expr(lambda env, i=self.idx: env.local[i])

    def nxt(self) -> Expr:
        return Expr(lambda env, i=self.idx: _next_of(env.next, i))


@dataclass(frozen=True)
class ConstCol:
    """A preprocessed (uncommitted, public) constant column — committed
    once per shape into the verifying key (prover.constant_vk)."""

    name: str
    idx: int

    def cur(self) -> Expr:
        return Expr(lambda env, i=self.idx: env.consts[i])

    def nxt(self) -> Expr:
        return Expr(lambda env, i=self.idx: _next_of(env.consts_next, i))


@dataclass(frozen=True)
class UInt:
    """A fixed-width unsigned integer: a value column plus its bit/byte
    decomposition family (well-formedness constraints auto-added)."""

    value: Col
    parts: tuple                   # bit Cols (u8/u16) or u8 UInts (u32)
    width: int


class _Env:
    """What an expression reads: the ring, the row(s), publics, constants.
    ``next``/``consts_next`` are None in a boundary class."""

    __slots__ = ("alg", "local", "next", "publics", "consts", "consts_next")

    def __init__(self, alg, local, nxt, publics, consts, consts_next):
        self.alg = alg
        self.local = local
        self.next = nxt
        self.publics = publics
        self.consts = consts
        self.consts_next = consts_next


class Ctx:
    """Constraint-authoring context passed to @transition/@first_row/
    @last_row/@every_row functions. Collects `eq`/`zero` constraints.
    ``has_next`` is False for the boundary classes, where ``nxt`` raises."""

    def __init__(self, has_next: bool = True):
        self._constraints: List[Expr] = []
        self.has_next = has_next

    # -- accessors --------------------------------------------------------

    def cur(self, col: Col) -> Expr:
        return col.cur()

    def nxt(self, col: Col) -> Expr:
        if not self.has_next:
            raise ValueError(_NO_NEXT)
        return col.nxt()

    def pub(self, i: int) -> Expr:
        return Expr(lambda env: env.alg.lift(env.publics[i]))

    def one(self) -> Expr:
        return Expr(lambda env: env.alg.one())

    def zero_e(self) -> Expr:
        return Expr(lambda env: env.alg.zero())

    # -- constraint sinks -------------------------------------------------

    def zero(self, e: Expr) -> None:
        """Constrain e == 0 (in this context's row class)."""
        self._constraints.append(Expr._lift(e))

    def eq(self, a: Expr, b) -> None:
        self.zero(Expr._lift(a) - b)

    # -- combinators -------------------------------------------------------

    def select(self, bit: Expr, a: Expr, b: Expr) -> Expr:
        """bit ? a : b   (degree +1)."""
        return Expr._lift(b) + Expr._lift(bit) * (Expr._lift(a) - b)

    def sum(self, es: Sequence[Expr]) -> Expr:
        acc = Expr._lift(0)
        for e in es:
            acc = acc + e
        return acc

    def dot(self, es: Sequence[Expr], coeffs: Sequence[int]) -> Expr:
        """Σ coeff_i · e_i with int coefficients (constant-folded)."""
        acc = Expr._lift(0)
        for e, c in zip(es, coeffs):
            acc = acc + Expr._lift(e) * (c % P)
        return acc

    def one_hot_dot(self, sel: Sequence[Expr], values: Sequence[int]) -> Expr:
        """Blend per-phase constants through a one-hot register (random
        access into a constant table by selector)."""
        return self.dot(sel, values)

    def recompose(self, parts: Sequence[Expr], base: int) -> Expr:
        """Σ parts_i · base^i (little-endian)."""
        acc = Expr._lift(0)
        mult = 1
        for p in parts:
            acc = acc + Expr._lift(p) * mult
            mult = (mult * base) % P
        return acc

    def rlc_window(self, gamma: Expr, elems: Sequence[Expr]) -> Expr:
        """γ-RLC of a window: Σ elems_i · γ^i — the byte-window binding
        used by air_header/air_rotate."""
        acc = Expr._lift(0)
        g_pow = self.one()
        for e in elems:
            acc = acc + Expr._lift(e) * g_pow
            g_pow = g_pow * gamma
        return acc


class _DslAir(Air):
    """The Air produced by AirBuilder.build()."""

    max_constraint_degree = 3

    def __init__(self, builder: "AirBuilder"):
        self.num_cols = builder._next_col
        self.num_publics = builder.num_publics
        self._t_fns = list(builder._t_fns)
        self._f_fns = list(builder._f_fns)
        self._l_fns = list(builder._l_fns)
        self._e_fns = list(builder._e_fns)
        self._auto_bits = [c.idx for c in builder._bit_cols]
        self._const_vals = builder._const_vals
        self._lookup_cols = list(builder._lookup_cols)
        self._name = builder.name
        if builder.n_rows is not None:
            self.n_rows = builder.n_rows

    # -- constraint classes ----------------------------------------------

    def _run(self, fns, alg, local, nxt, publics, consts, consts_next):
        env = _Env(alg, local, nxt, publics, consts, consts_next)
        out = []
        for fn in fns:
            ctx = Ctx(has_next=nxt is not None)
            fn(ctx)
            out.extend(e.f(env) for e in ctx._constraints)
        return out

    def _booleanity(self, alg, local):
        return [alg.sub(alg.mul(local[i], local[i]), local[i])
                for i in self._auto_bits]

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        # family well-formedness: bit booleanity on every transition row
        cs = self._booleanity(alg, local)
        cs.extend(self._run(self._t_fns + self._e_fns, alg, local,
                            next_row, publics, consts, consts_next))
        return cs

    def first_row(self, alg, local, publics, consts=()):
        return self._run(self._f_fns, alg, local, None, publics, consts,
                         None)

    def last_row(self, alg, local, publics, consts=()):
        cs = self._booleanity(alg, local)
        cs.extend(self._run(self._l_fns + self._e_fns, alg, local, None,
                            publics, consts, None))
        return cs

    def lookup_range_columns(self):
        return list(self._lookup_cols)

    def constant_columns(self, n_rows: int):
        out = np.zeros((len(self._const_vals), n_rows), dtype=np.uint64)
        for i, vals in enumerate(self._const_vals):
            m = min(len(vals), n_rows)
            out[i, :m] = np.asarray(vals[:m], dtype=np.uint64)
        return out


class AirBuilder:
    """Declare typed columns and constraint functions; build() an Air.

    Columns are typed handles, constraints are written against accessor
    and combinator operations, and the mapping onto the proof system
    (column indices, booleanity, decomposition identities, lookup
    registration) is the builder's job — not the author's."""

    def __init__(self, num_publics: int = 0, name: str = "dsl_air",
                 n_rows: Optional[int] = None):
        self.num_publics = num_publics
        self.name = name
        self.n_rows = n_rows
        self._next_col = 0
        self._next_const = 0
        self._bit_cols: List[Col] = []
        self._lookup_cols: List[int] = []
        self._const_vals: List[list] = []
        self._t_fns: List[Callable] = []
        self._f_fns: List[Callable] = []
        self._l_fns: List[Callable] = []
        self._e_fns: List[Callable] = []
        self._names = {}

    # -- column families --------------------------------------------------

    def _col(self, name: str, kind: str) -> Col:
        if name in self._names:
            raise ValueError(f"duplicate column name {name!r}")
        c = Col(name, self._next_col, kind)
        self._names[name] = c
        self._next_col += 1
        return c

    def felt(self, name: str) -> Col:
        return self._col(name, "felt")

    def felts(self, name: str, k: int) -> List[Col]:
        return [self.felt(f"{name}[{j}]") for j in range(k)]

    def bit(self, name: str) -> Col:
        c = self._col(name, "bit")
        self._bit_cols.append(c)
        return c

    def bits(self, name: str, k: int) -> List[Col]:
        return [self.bit(f"{name}[{j}]") for j in range(k)]

    def _uint_bits(self, name: str, width: int) -> UInt:
        v = self.felt(name)
        bs = self.bits(f"{name}.b", width)

        def wf(ctx, v=v, bs=bs):
            ctx.eq(ctx.cur(v),
                   ctx.recompose([ctx.cur(b) for b in bs], 2))

        self.every_row(wf)
        return UInt(v, tuple(bs), width)

    def u8(self, name: str) -> UInt:
        """A byte: value column + 8 bit columns."""
        return self._uint_bits(name, 8)

    def u16(self, name: str) -> UInt:
        return self._uint_bits(name, 16)

    def u32(self, name: str) -> UInt:
        """4 little-endian u8 families + a value column recomposing them."""
        v = self.felt(name)
        bytes_ = tuple(self.u8(f"{name}.byte{j}") for j in range(4))

        def wf(ctx, v=v, bytes_=bytes_):
            ctx.eq(ctx.cur(v),
                   ctx.recompose([ctx.cur(b.value) for b in bytes_], 256))

        self.every_row(wf)
        return UInt(v, bytes_, 32)

    def bytes32(self, name: str) -> List[UInt]:
        """32 byte families."""
        return [self.u8(f"{name}[{j}]") for j in range(32)]

    def range_checked(self, name: str) -> Col:
        """A column range-checked to [0, n_rows) via the LogUp row-ramp
        table."""
        c = self._col(name, "felt")
        self._lookup_cols.append(c.idx)
        return c

    def constant(self, name: str, values: Sequence[int]) -> ConstCol:
        c = ConstCol(name, self._next_const)
        self._next_const += 1
        self._const_vals.append([int(v) % P for v in values])
        return c

    # -- constraint registration ------------------------------------------

    def transition(self, fn: Callable) -> Callable:
        self._t_fns.append(fn)
        return fn

    def first_row(self, fn: Callable) -> Callable:
        self._f_fns.append(fn)
        return fn

    def last_row(self, fn: Callable) -> Callable:
        self._l_fns.append(fn)
        return fn

    def every_row(self, fn: Callable) -> Callable:
        """Holds on all rows (emitted into both the transition and the
        last-row class, like the LogUp inverse definitions)."""
        self._e_fns.append(fn)
        return fn

    def build(self) -> _DslAir:
        return _DslAir(self)


class TraceWriter:
    """Witness-side counterpart: fill named columns with exact ints and
    emit the (num_cols, n_rows) Goldilocks trace."""

    def __init__(self, builder_or_air, n_rows: int):
        src = builder_or_air
        names = src._names if isinstance(src, AirBuilder) else None
        if names is None:
            raise TypeError("TraceWriter wants the AirBuilder")
        self._names = names
        self._n = n_rows
        self._cols = np.zeros((max(c.idx for c in names.values()) + 1,
                               n_rows), dtype=np.object_)

    def set(self, col, row: int, value: int) -> None:
        idx = col.idx if isinstance(col, Col) else self._names[col].idx
        self._cols[idx, row] = int(value) % P

    def set_uint(self, u: UInt, row: int, value: int) -> None:
        """Set a UInt's value column AND its whole decomposition family."""
        value = int(value)
        self.set(u.value, row, value % P)
        if u.parts and isinstance(u.parts[0], UInt):      # u32: bytes
            for j, b in enumerate(u.parts):
                self.set_uint(b, row, (value >> (8 * j)) & 0xFF)
        else:                                             # bits
            for j, b in enumerate(u.parts):
                self.set(b, row, (value >> j) & 1)

    def finish(self, device=None) -> gl.Fp:
        """The trace on ``device`` (the current CUDA device unless named)."""
        return gl.to_fp(self._cols, device)
