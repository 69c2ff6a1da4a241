"""AIR (algebraic intermediate representation) interface for the STARK.

An AIR defines a trace layout plus constraint polynomials over (local_row,
next_row, publics). The same constraint code runs in two rings:

- ``BaseVecAlgebra``: base-field vectors over the whole LDE domain (prover —
  every constraint evaluates on all N_lde points at once);
- ``ExtAlgebra``:     GF(p^2) scalars at the out-of-domain point ζ (verifier
  ALI consistency check).

A base-ring element is one tensor; an extension-ring element is a
``(re, im)`` tuple. Transition constraints hold on rows 0..N-2 (divisor
(x^N-1)/(x-g^{N-1})), ``first``/``last`` boundary constraints at row 0 /
N-1 (divisors x-1, x-g^{N-1}).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import default_device
from ..field import goldilocks as gl
from ..field import ext


class BaseVecAlgebra:
    """Elements: Fp tensors of a fixed shape (the LDE domain)."""

    def __init__(self, shape, device=None):
        self.shape = tuple(shape)
        self.device = default_device(device)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def constant(self, c: int):
        return gl.full((), c, self.device).expand(self.shape)

    def lift(self, scalar: gl.Fp):
        """Broadcast a scalar Fp (shape ()) into the domain shape."""
        return scalar.expand(self.shape)

    def one(self):
        return self.constant(1)

    def zero(self):
        return self.constant(0)


class ExtAlgebra:
    """Elements: Fp2 scalars (shape-() components)."""

    def __init__(self, device=None):
        self.device = default_device(device)

    def add(self, a, b):
        return ext.add(a, b)

    def sub(self, a, b):
        return ext.sub(a, b)

    def mul(self, a, b):
        return ext.mul(a, b)

    def constant(self, c: int):
        return ext.from_base(gl.full((), c, self.device))

    def lift(self, scalar: gl.Fp):
        return ext.from_base(scalar)

    def one(self):
        return self.constant(1)

    def zero(self):
        return self.constant(0)


# -- groups: ring elements stacked along a leading axis ------------------------
# An extension element is a (re, im) tuple, a base element a tensor; the
# helpers map over the tuple for the former. In the recursion machine's
# ring (recursion_air.XAlgMB) an element is an XCell, a (re_cell, im_cell)
# tuple of ints, and a group of them is a ``GX`` list.

class GX(list):
    """A GROUP of scalar machine cells (XCells): the MachineBuilder-ring
    counterpart of a leading group axis on tensor ring elements. Lives here
    so AIR constraint helpers can be ring-generic without importing the
    recursion machinery."""


def is_group_cells(e) -> bool:
    return isinstance(e, GX)


def _map(f, e):
    return (f(e[0]), f(e[1])) if isinstance(e, tuple) else f(e)


def stack_group(elems):
    """Stack ring elements along a leading group axis: torch.stack for the
    tensor rings, a GX list for the machine ring."""
    elems = list(elems)
    e0 = elems[0]
    if isinstance(e0, GX):
        raise TypeError("stack_group over GX groups is not supported")
    if (isinstance(e0, tuple) and len(e0) == 2
            and isinstance(e0[0], (int, np.integer))):
        return GX(elems)
    if isinstance(e0, tuple):
        return (torch.stack([e[0] for e in elems]),
                torch.stack([e[1] for e in elems]))
    return torch.stack(elems)


def roll_group(e, k: int):
    """Circular roll along the group axis (element i of the result is
    element i-k of the input)."""
    if isinstance(e, GX):
        m = len(e)
        k %= m
        return GX(e[m - k:] + e[:m - k])
    return _map(lambda x: torch.roll(x, k, dims=0), e)


def slice_group(e, a: int, b: int):
    if isinstance(e, GX):
        return GX(list(e)[a:b])
    return _map(lambda x: x[a:b], e)


def index_group(e, i: int):
    """Single element of a group (a scalar ring element)."""
    if isinstance(e, GX):
        return e[i]
    return _map(lambda x: x[i], e)


def sum_group(e, alg=None):
    """Σ over the group axis -> scalar ring element. The machine ring
    needs ``alg`` (cells add through emitted rows)."""
    if isinstance(e, GX):
        acc = e[0]
        for x in e[1:]:
            acc = alg.add(acc, x)
        return acc
    return _map(lambda x: gl.sum_mod(x, axis=0), e)


class Air:
    """Subclass and define the trace + constraints.

    Conventions:
    - ``local``/``next_row`` are lists of ring elements, one per column.
    - ``publics`` is a list of Fp scalars (shape ()); use ``alg.lift``.
    - ``consts``/``consts_next`` are lists of ring elements for the AIR's
      public constant columns (``constant_columns``): known to both sides,
      committed once into the verifying key (prover.constant_vk).
    - every constraint must have total degree <= max_constraint_degree.
    """

    num_cols: int = 0
    max_constraint_degree: int = 3

    def ram_multiset(self):
        """None, or (mult_cidx, load_cidx, addr_cidx, active_cidx, val_col)
        declaring a pair-multiset memory argument over the trace:

            Σ_stores mult(r)/(γ − addr(r) − δ·val(r))
                == Σ_loads 1/(γ − addr(r) − δ·val(r))

        mult (how many loads a store serves; 0 is legal), load (0/1) and
        active (0/1: store-or-load row) are CONSTANT-column flags, addr a
        CONSTANT column, val a COMMITTED column. γ, δ are squeezed after
        the trace commitment. Adds 4 aux base columns (inv re/im,
        running-sum re/im) to the aux commitment (prover.py)."""
        return None

    def lookup_range_columns(self) -> List[int]:
        """Trace column indices range-checked to [0, n_rows) via LogUp: the
        table is the row ramp 0..n_rows-1. The aux columns (inverses,
        running sum, multiplicities) are built by the prover after the
        trace commitment and a dedicated challenge γ; see prover.py."""
        return []

    def constant_columns(self, n_rows: int):
        """-> (k, n_rows) numpy int array (possibly k = 0)."""
        return np.zeros((0, n_rows), dtype=np.uint64)

    def transition(self, alg, local: List, next_row: List, publics: List,
                   consts: List = (), consts_next: List = ()) -> List:
        return []

    def transition_iter(self, alg, local: List, next_row: List,
                        publics: List, consts: List = (),
                        consts_next: List = ()):
        """Streaming form: yields the same constraints in the same order as
        ``transition``."""
        yield from self.transition(alg, local, next_row, publics, consts,
                                   consts_next)

    def first_row(self, alg, local: List, publics: List,
                  consts: List = ()) -> List:
        return []

    def last_row(self, alg, local: List, publics: List,
                 consts: List = ()) -> List:
        return []

    def num_constraints(self) -> int:
        """Total constraint count (transition + first + last): a shape
        probe on the host, whatever device the proofs run on."""
        alg = ExtAlgebra("cpu")
        dummy = [alg.zero() for _ in range(self.num_cols)]
        k = self.constant_columns(2).shape[0]
        dc = [alg.zero() for _ in range(k)]
        pubs = [gl.zeros((), "cpu")
                for _ in range(getattr(self, "num_publics", 0))]
        return (len(self.transition(alg, dummy, dummy, pubs, dc, dc))
                + len(self.first_row(alg, dummy, pubs, dc))
                + len(self.last_row(alg, dummy, pubs, dc)))


def const_values(cvals) -> np.ndarray:
    """An AIR's constant columns for ``gl.to_fp``: unsigned arrays as they
    are (a (k, n) uint64 schedule stays one buffer), anything else as
    exact Python ints."""
    arr = np.asarray(cvals)
    return arr if arr.dtype.kind == "u" else arr.astype(np.object_)


def check_constraints(air: Air, trace: gl.Fp, publics) -> bool:
    """Evaluate every constraint directly on the trace domain (no LDE, no
    commitment): transition constraints must vanish on rows 0..N-2,
    first/last on their rows."""
    n = trace.shape[1]
    alg = BaseVecAlgebra((n,), trace.device)
    local = [trace[c] for c in range(air.num_cols)]
    nxt_all = torch.roll(trace, -1, dims=1)
    nxt = [nxt_all[c] for c in range(air.num_cols)]
    cvals = const_values(air.constant_columns(n))
    if cvals.shape[0]:
        cfp = gl.to_fp(cvals, trace.device)
        consts = list(cfp)
        consts_next = list(torch.roll(cfp, -1, dims=1))
    else:
        consts, consts_next = [], []
    ok = True
    for c in air.transition(alg, local, nxt, publics, consts, consts_next):
        ok = ok and bool(torch.all(c[..., :n - 1] == 0))
    for c in air.first_row(alg, local, publics, consts):
        ok = ok and bool(torch.all(c[..., 0] == 0))
    for c in air.last_row(alg, local, publics, consts):
        ok = ok and bool(torch.all(c[..., n - 1] == 0))
    return ok


class FibonacciAir(Air):
    """Toy AIR: two columns (a, b); step (a, b) -> (b, a+b).

    Publics: [a0, b0, res] with res = a at the last row."""

    num_cols = 2
    num_publics = 3

    def transition(self, alg, local, next_row, publics, consts=(), consts_next=()):
        a, b = local
        an, bn = next_row
        return [
            alg.sub(an, b),                    # a' = b
            alg.sub(bn, alg.add(a, b)),        # b' = a + b
        ]

    def first_row(self, alg, local, publics, consts=()):
        a, b = local
        return [
            alg.sub(a, alg.lift(publics[0])),
            alg.sub(b, alg.lift(publics[1])),
        ]

    def last_row(self, alg, local, publics, consts=()):
        a, b = local
        return [alg.sub(a, alg.lift(publics[2]))]

    @staticmethod
    def make_trace(n: int, a0: int = 0, b0: int = 1, device=None):
        """Host-side trace builder -> ((2, n) Fp trace, publics list)."""
        P = gl.MODULUS
        a, b = a0 % P, b0 % P
        col_a, col_b = [], []
        for _ in range(n):
            col_a.append(a)
            col_b.append(b)
            a, b = b, (a + b) % P
        trace = gl.to_fp([col_a, col_b], device)
        publics = [a0 % P, b0 % P, col_a[-1]]
        return trace, publics
