"""Full in-AIR STARK verification — the recursion machine.

A reduce node of the MapReduce layer verifies child proofs *inside* a
proof (VectorX verifies two child plonky2 proofs per reduce circuit). This
module is that machine: ONE AIR whose trace interleaves

- **Poseidon sponge rows** (the transcript replay and every Merkle-path
  check — the same permutation the out-of-circuit commitments use), and
- **scalar ALU rows** over a shared K-register file (all verification
  arithmetic: ALI at ζ, LogUp terms, DEEP composition, FRI folds,
  query-index bit decomposition),

so that *every* check of verifier.py runs inside the proof: transcript
challenges are squeezed from in-trace sponge states, openings are witness
bound by in-trace Merkle paths against witness caps that are themselves
absorbed into the in-trace transcript. The outer statement is exactly
"there exists an inner proof for these publics that verifies".

Machine design (all constraints degree ≤ 3):

- Schedule is STATIC: every row's role (round r / absorb / ALU op), port
  selectors and literals are public constant columns derived from
  (inner_air, log_n, config) alone — the verifier rebuilds them from the
  claim shape, never from the witness.
- Registers are scalar base-field cells; GF(p²) ops expand to scalar rows
  (Fp2 mul = 6 rows). Values move between regions through the register
  file: absorb lanes are free witness EQ-pinned to registers, squeezed
  challenges are lane reads, Merkle digests EQ against cap registers.
- Witness-dependent control flow (query indices) becomes arithmetic: the
  squeezed element is bit-decomposed (canonically — the sub-p check is
  enforced), and bits drive path sibling order, fold-side selection and
  the x = shift·w^idx square-ladder via multiplicative selects.

The recording (MachineBuilder, XAlgMB, the streamed recorder,
record_stark_verify) is host Python on exact ints and emits the JAX
package's schedule row for row, so ``schedule_digest`` equals the JAX
package's; the proofs it reads are port tensors on any device.
``RecursionAir.transition`` runs on the port's grouped tensor rings and,
through XAlgMB, on the machine ring itself (a RecursionAir proof recurses).

Row cost: a permutation is 30 round rows; an absorb adds 1 overwrite row
+ one EQ row per absorbed lane; a Merkle level ≈ 80 rows. A tiny inner
proof (rate 1, 2 queries) verifies in ≈ 2^13 rows × ~(K+40) columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device
from ..field import goldilocks as gl
from ..field import ext
from ..hashes import poseidon as ps
from .air import Air, GX, stack_group

P = gl.MODULUS
W = ext.W
WIDTH = ps.WIDTH          # 12
RATE = ps.RATE            # 8
N_ROUNDS = ps.N_ROUNDS    # 30
_HALF_F = ps.FULL_ROUNDS // 2

OP_NOP, OP_LOAD, OP_LOADW, OP_MUL, OP_AXPY, OP_BIT = range(6)


# ---------------------------------------------------------------------------
# Host-side Poseidon round (exact ints) — per-round states for the witness
# ---------------------------------------------------------------------------

def _round_ints(s: List[int], r: int) -> List[int]:
    rc = ps.round_constants()
    m = ps.mds_matrix()
    t = [(x + c) % P for x, c in zip(s, rc[r])]
    if _HALF_F <= r < _HALF_F + ps.PARTIAL_ROUNDS:
        sb = [pow(t[0], 7, P)] + t[1:]
    else:
        sb = [pow(x, 7, P) for x in t]
    return [sum(m[i][j] * sb[j] for j in range(WIDTH)) % P
            for i in range(WIDTH)]


# ---------------------------------------------------------------------------
# Rows + the machine builder
# ---------------------------------------------------------------------------

# absorb-row lane modes
L_COPY, L_ZERO, L_FREE = 0, 1, 2


@dataclass
class _Row:
    op: int = OP_NOP
    a: object = None            # cell id | ('h', lane) | None
    b: Optional[int] = None     # cell id | None
    lit: int = 0
    zp: bool = False
    pub: int = -1
    cell: int = -1              # cell defined by this row (ALU rows)
    hround: int = -1            # poseidon round index, or -1
    # absorb row: 12 lane modes; free lanes carry their source cell id
    hmode: Optional[Tuple[int, ...]] = None
    hcells: Optional[Tuple[int, ...]] = None
    aval: int = 0
    bval: int = 0
    cval: int = 0
    # value-RAM flags (air.ram_multiset): this row's C value is a STORE
    # (ram=1, serving ram_mult later loads) or a LOAD (ram=2) of address
    # ram_addr — all schedule-static
    ram: int = 0
    ram_addr: int = 0
    ram_mult: int = 0


class MachineBuilder:
    """Records the static schedule + concrete witness of one program run.

    All `*_` emit methods take concrete Python-int witness values; the
    SCHEDULE they emit must not depend on those values (asserted by
    tests via schedule-digest comparison against a dummy-proof build)."""

    def __init__(self):
        self.rows: List[_Row] = []
        self.vals: List[int] = []          # cell id -> concrete value
        self.h = [0] * WIDTH               # current sponge state
        self.hsnap: List[Tuple[int, ...]] = []   # per-row state
        self.publics: List[int] = []
        self._consts = {}                  # literal -> cached cell
        self.cell_row: List[int] = []      # cell id -> defining row index
        self.ram_addr_base = 0             # next free RAM address block

    # -- ALU ---------------------------------------------------------------

    def _alu(self, op, a=None, b=None, lit=0, zp=False, pub=-1, val=0) -> int:
        cell = len(self.vals)
        val %= P
        self.vals.append(val)
        aval = 0
        if isinstance(a, tuple):
            aval = self.h[a[1]]
        elif a is not None:
            aval = self.vals[a]
        bval = self.vals[b] if b is not None else 0
        self.hsnap.append(tuple(self.h))
        self.cell_row.append(len(self.rows))
        self.rows.append(_Row(op=op, a=a, b=b, lit=lit % P, zp=zp, pub=pub,
                              cell=cell, aval=aval, bval=bval, cval=val))
        return cell

    # -- value RAM (air.ram_multiset; phase-5 spill) -----------------------

    def ram_store(self, cell: int, addr: int) -> None:
        """Flag `cell`'s defining row as the STORE of `addr` (multiplicity
        back-patched by ram_set_mult once load counts are known)."""
        r = self.rows[self.cell_row[cell]]
        assert r.ram == 0
        r.ram = 1
        r.ram_addr = addr % P

    def ram_load(self, v: int, addr: int) -> int:
        """Fresh witness cell whose value is FORCED (by the multiset
        argument) to equal some store of `addr`."""
        cell = self.loadw(v)
        r = self.rows[self.cell_row[cell]]
        r.ram = 2
        r.ram_addr = addr % P
        return cell

    def ram_set_mult(self, store_cell: int, mult: int) -> None:
        self.rows[self.cell_row[store_cell]].ram_mult = mult % P

    def load(self, v: int) -> int:
        return self._alu(OP_LOAD, lit=v, val=v)

    def const(self, v: int) -> int:
        """Cached literal cell (for 0, 1, and other reused constants)."""
        v %= P
        if v not in self._consts:
            self._consts[v] = self.load(v)
        return self._consts[v]

    def loadw(self, v: int, pub: int = -1) -> int:
        return self._alu(OP_LOADW, val=v, pub=pub)

    def mul(self, a: int, b: int) -> int:
        return self._alu(OP_MUL, a, b, val=self.vals[a] * self.vals[b])

    def axpy(self, a: int, b: Optional[int], k: int) -> int:
        """C = A + k·B (k a literal)."""
        bv = self.vals[b] if b is not None else 0
        return self._alu(OP_AXPY, a, b, lit=k,
                         val=self.vals[a] + (k % P) * bv)

    def add(self, a: int, b: int) -> int:
        return self.axpy(a, b, 1)

    def sub(self, a: int, b: int) -> int:
        return self.axpy(a, b, P - 1)

    def scale(self, a: int, k: int) -> int:
        """C = k·A."""
        return self.axpy(self.const(0), a, k)

    def mov_lane(self, lane: int) -> int:
        return self._alu(OP_AXPY, ('h', lane), None, lit=0,
                         val=self.h[lane])

    def bit(self, v: int) -> int:
        assert v in (0, 1)
        return self._alu(OP_BIT, val=v)

    def eq_cells(self, a: int, b: int) -> None:
        self._alu(OP_AXPY, a, b, lit=P - 1, zp=True,
                  val=self.vals[a] - self.vals[b])

    def eq_lane(self, lane: int, cell: int) -> None:
        self._alu(OP_AXPY, ('h', lane), cell, lit=P - 1, zp=True,
                  val=self.h[lane] - self.vals[cell])

    def assert_zero(self, cell: int) -> None:
        self._alu(OP_AXPY, cell, None, lit=0, zp=True, val=self.vals[cell])

    def pin_public(self, v: int) -> int:
        """Load v as witness pinned to the next outer public."""
        j = len(self.publics)
        self.publics.append(v % P)
        return self.loadw(v, pub=j)

    # -- hash rows ---------------------------------------------------------

    def _hash_row(self, hround=-1, hmode=None, hcells=None, next_h=None):
        self.hsnap.append(tuple(self.h))
        self.rows.append(_Row(hround=hround, hmode=hmode, hcells=hcells))
        self.h = next_h

    def permute_rounds(self) -> None:
        for r in range(N_ROUNDS):
            self._hash_row(hround=r, next_h=_round_ints(self.h, r))

    def absorb_then_permute(self, modes: Sequence[Tuple[int, Optional[int]]],
                            cb: Optional[Callable[[], None]] = None) -> None:
        """modes: 12 × (L_COPY|L_ZERO|L_FREE, cell-or-None). Emits the
        overwrite row, EQ rows binding each free lane to its cell, an
        optional ALU callback (runs while the absorbed state holds), then
        the 30 round rows."""
        assert len(modes) == WIDTH
        nxt = []
        for j, (m, c) in enumerate(modes):
            if m == L_COPY:
                nxt.append(self.h[j])
            elif m == L_ZERO:
                nxt.append(0)
            else:
                nxt.append(self.vals[c])
        self._hash_row(hmode=tuple(m for m, _ in modes),
                       hcells=tuple((c if c is not None else -1)
                                    for _, c in modes),
                       next_h=nxt)
        for j, (m, c) in enumerate(modes):
            if m == L_FREE:
                self.eq_lane(j, c)
        if cb is not None:
            cb()
        self.permute_rounds()

    def read_digest(self) -> List[int]:
        return [self.mov_lane(j) for j in range(ps.DIGEST_WIDTH)]

    def eq_digest(self, cap_cells: Sequence[int]) -> None:
        for j in range(ps.DIGEST_WIDTH):
            self.eq_lane(j, cap_cells[j])

    # -- compound helpers --------------------------------------------------

    def sponge(self, cells: Sequence[int],
               chunk_cb=None) -> None:
        """hash_many semantics: fresh sponge over `cells` (zero-padded to
        full RATE chunks; capacity zeroed on the first chunk)."""
        n = len(cells)
        nch = max(1, -(-n // RATE))
        for j in range(nch):
            chunk = list(cells[j * RATE:(j + 1) * RATE])
            modes = []
            for k in range(RATE):
                if k < len(chunk):
                    modes.append((L_FREE, chunk[k]))
                else:
                    modes.append((L_ZERO, None))
            capm = L_ZERO if j == 0 else L_COPY
            modes += [(capm, None)] * ps.CAPACITY
            cb = (lambda ch=chunk: chunk_cb(ch)) if chunk_cb else None
            self.absorb_then_permute(modes, cb=cb)

    def compress(self, left: Sequence[int], right: Sequence[int]) -> None:
        """2-to-1 Merkle compression of two 4-cell digests (result = next
        sponge state lanes 0..3)."""
        modes = ([(L_FREE, c) for c in left] + [(L_FREE, c) for c in right]
                 + [(L_ZERO, None)] * ps.CAPACITY)
        self.absorb_then_permute(modes)

    def mux(self, bit_c: int, a: int, b: int) -> int:
        """bit ? b : a  (= a + bit·(b − a))."""
        t = self.sub(b, a)
        u = self.mul(bit_c, t)
        return self.add(a, u)

    def ladder(self, bits: Sequence[int], base: int) -> int:
        """base^{Σ bits_i 2^i} via square-ladder over literal powers."""
        one = self.const(1)
        acc = one
        w = base % P
        for b in bits:
            f = self.axpy(one, b, (w - 1) % P)
            acc = self.mul(acc, f)
            w = (w * w) % P
        return acc

    def decompose64(self, cell: int) -> List[int]:
        """Canonical 64-bit decomposition of a field element; returns the
        bit cells (LSB first). Enforces Σ b_i 2^i == cell AND the value is
        the canonical representative (< p)."""
        v = self.vals[cell]
        assert 0 <= v < P
        bits = []
        lo = None
        for i in range(32):
            b = self.bit((v >> i) & 1)
            bits.append(b)
            lo = b if i == 0 else self.axpy(lo, b, 1 << i)
        hi = None
        for i in range(32, 64):
            b = self.bit((v >> i) & 1)
            bits.append(b)
            hi = b if i == 32 else self.axpy(hi, b, 1 << (i - 32))
        full = self.axpy(lo, hi, 1 << 32)
        self.eq_cells(full, cell)
        # canonicity: hi == 2^32−1 ⇒ lo == 0 (v < p = 2^64 − 2^32 + 1)
        one = self.const(1)
        d = self.axpy(hi, one, P - ((1 << 32) - 1))     # hi − (2^32−1)
        dv = self.vals[d]
        e = self.bit(1 if dv == 0 else 0)
        u = self.loadw(pow(dv, P - 2, P) if dv else 0)
        t1 = self.mul(d, u)
        t2 = self.add(t1, e)                             # d·u + e == 1
        self.assert_zero(self.axpy(t2, one, P - 1))
        self.assert_zero(self.mul(e, d))
        self.assert_zero(self.mul(e, lo))
        return bits

    # -- Fp2 layer (XCell = (re_cell, im_cell)) -----------------------------

    def xconst(self, re: int, im: int = 0):
        return (self.const(re), self.const(im))

    def xadd(self, x, y):
        return (self.add(x[0], y[0]), self.add(x[1], y[1]))

    def xsub(self, x, y):
        return (self.sub(x[0], y[0]), self.sub(x[1], y[1]))

    def xmul(self, x, y):
        c1 = self.mul(x[0], y[0])
        c2 = self.mul(x[1], y[1])
        re = self.axpy(c1, c2, W)
        c3 = self.mul(x[0], y[1])
        c4 = self.mul(x[1], y[0])
        return (re, self.add(c3, c4))

    def xmul_base(self, x, c: int):
        """x · base-cell c."""
        return (self.mul(x[0], c), self.mul(x[1], c))

    def xscale(self, x, k: int):
        return (self.scale(x[0], k), self.scale(x[1], k))

    def xval(self, x) -> Tuple[int, int]:
        return (self.vals[x[0]], self.vals[x[1]])

    def xinv_checked(self, x):
        """Witnessed 1/x with the product==1 check zero-pinned."""
        a, b = self.xval(x)
        d = (a * a - W * b * b) % P
        dinv = pow(d, P - 2, P) if d else 0
        inv = (self.loadw(a * dinv % P), self.loadw((P - b) * dinv % P))
        t = self.xmul(x, inv)
        self.assert_zero(self.axpy(t[0], self.const(1), P - 1))
        self.assert_zero(t[1])
        return inv

    def xeq0(self, x) -> None:
        self.assert_zero(x[0])
        self.assert_zero(x[1])

    def xeq(self, x, y) -> None:
        self.xeq0(self.xsub(x, y))

    def xmux(self, bit_c: int, a, b):
        return (self.mux(bit_c, a[0], b[0]), self.mux(bit_c, a[1], b[1]))


class XAlgMB:
    """ExtAlgebra lookalike over MachineBuilder XCells — runs the INNER
    AIR's constraint code to record its ALI evaluation as machine rows.
    ``publics`` entries must already be XCells (lift is identity).

    GROUPED operands (``GX`` lists of XCells — what _stackring produces in
    this ring) broadcast elementwise against scalars, so grouped-tensor
    constraint code (RecursionAir itself) records unchanged."""

    def __init__(self, mb: MachineBuilder):
        self.mb = mb

    def _zip(self, a, b, f):
        ga, gb = isinstance(a, GX), isinstance(b, GX)
        if ga or gb:
            m = len(a) if ga else len(b)
            return GX([f(a[i] if ga else a, b[i] if gb else b)
                       for i in range(m)])
        return f(a, b)

    def add(self, a, b):
        return self._zip(a, b, self.mb.xadd)

    def sub(self, a, b):
        return self._zip(a, b, self.mb.xsub)

    def mul(self, a, b):
        return self._zip(a, b, self.mb.xmul)

    def constant(self, c: int):
        return self.mb.xconst(c % P)

    def lift(self, x):
        if isinstance(x, GX):
            return x
        assert isinstance(x, tuple) and len(x) == 2
        return x

    def one(self):
        return self.constant(1)

    def zero(self):
        return self.constant(0)


# ---------------------------------------------------------------------------
# The AIR over a recorded schedule
# ---------------------------------------------------------------------------

# GX lives in air.py so AIR constraint helpers are ring-generic: RecursionAir's
# own code and the statement AIRs record through XAlgMB as well.


def _is_xcell(e) -> bool:
    return (isinstance(e, tuple) and len(e) == 2
            and isinstance(e[0], (int, np.integer)))


def _stackring(elems):
    return stack_group(elems)


def _is_ext(e) -> bool:
    """An extension-ring element (a (re, im) tuple of tensors); a base-ring
    element is one tensor."""
    return isinstance(e, tuple)


def _sum0(e, alg=None):
    if isinstance(e, GX):
        acc = e[0]
        for x in e[1:]:
            acc = alg.add(acc, x)
        return acc
    if _is_ext(e):
        return (gl.sum_mod(e[0], axis=0), gl.sum_mod(e[1], axis=0))
    return gl.sum_mod(e, axis=0)


def _ring_device(e):
    return (e[0] if _is_ext(e) else e).device


def _const_tensor(arr: np.ndarray, shape, device):
    """numpy ints in [0, p) -> an int64 bit-pattern tensor of ``shape``."""
    u = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(u.view(np.int64)).reshape(shape).to(device)


def _bconst_grouped(arr: np.ndarray, like):
    """numpy int array (G,) or (G, G2) -> base-ring constant broadcastable
    against grouped ring elements shaped (G, *rest)."""
    if isinstance(like, GX):
        return arr.astype(np.object_).reshape(-1)
    rest = (like[0].dim() if _is_ext(like) else like.dim()) - 1
    return _const_tensor(arr, arr.shape + (1,) * rest, _ring_device(like))


def _mulb(e, b, alg=None):
    """ring element × base constant (componentwise for ext)."""
    if isinstance(e, GX):
        return GX([alg.mb.xscale(x, int(k)) for x, k in zip(e, b)])
    if _is_ext(e):
        return (gl.mul(e[0], b), gl.mul(e[1], b))
    return gl.mul(e, b)


def _mds_grouped(sb, alg=None):
    """MDS over a (12, *rest)-grouped ring element."""
    m = np.array(ps.mds_matrix(), dtype=np.object_)
    if isinstance(sb, GX):
        out = []
        for i in range(WIDTH):
            acc = alg.mb.xscale(sb[0], int(m[i][0]))
            for j in range(1, WIDTH):
                acc = alg.mb.xadd(acc, alg.mb.xscale(sb[j], int(m[i][j])))
            out.append(acc)
        return GX(out)
    rest = (sb[0].dim() if _is_ext(sb) else sb.dim()) - 1
    mt = _const_tensor(m, (WIDTH, WIDTH) + (1,) * rest, _ring_device(sb))

    def comp(c):
        prod = gl.mul(c[None], mt)                     # (12, 12, *rest)
        return gl.sum_mod(prod, axis=1)

    if _is_ext(sb):
        return (comp(sb[0]), comp(sb[1]))
    return comp(sb)


BANK_W = 16   # registers per selector bank (port selects are 2-level:
              # bank one-hot × offset one-hot — degree 3 with the
              # register read, and 3·(K/16+16) constant columns instead
              # of 3·K one-hots, which dominated the area for big-K
              # machines: a K=2875 recording needed 8.6k selector consts)


class RecursionAir(Air):
    """Proves execution of a MachineBuilder program.

    Committed columns: h[12] | x3[12] | x7[12] | R[K] | A B C.
    Constant columns: c_round Ff Pp | c2[12] c3[12] rc[12] | op flags
    (load mul axpy bit) zp lit | hsel[12] | banked port selectors
    (a/b/w: bank[NB] + offset[BANK_W] each) | osel[num_publics].
    Port select k decomposes as bank[k // BANK_W] · off[k % BANK_W].
    """

    max_constraint_degree = 3

    # const layout offsets (computed in __init__)

    def __init__(self, mb: MachineBuilder, k_regs: int = 0):
        self.mb = mb
        self.reg, k_min = _allocate(mb)
        self.K = max(k_regs, k_min)
        n = 1
        while n < len(mb.rows) + 1:     # ≥1 trailing NOP pad row
            n <<= 1
        self.n_rows = n
        K = self.K
        self.NB = -(-K // BANK_W)       # selector banks
        NB = self.NB
        self.COL_H = 0
        self.COL_X3 = 12
        self.COL_X7 = 24
        self.COL_R = 36
        self.COL_A = 36 + K
        self.COL_B = 37 + K
        self.COL_C = 38 + K
        self.num_cols = 39 + K
        self.num_publics = len(mb.publics)
        # consts
        self.C_ROUND, self.C_FF, self.C_PP = 0, 1, 2
        self.C_C2 = 3
        self.C_C3 = 15
        self.C_RC = 27
        self.C_LOAD, self.C_MUL, self.C_AXPY, self.C_BIT, self.C_ZP = \
            39, 40, 41, 42, 43
        self.C_LIT = 44
        self.C_HSEL = 45
        self.C_ABANK = 57
        self.C_AOFF = 57 + NB
        self.C_BBANK = self.C_AOFF + BANK_W
        self.C_BOFF = self.C_BBANK + NB
        self.C_WBANK = self.C_BOFF + BANK_W
        self.C_WOFF = self.C_WBANK + NB
        self.C_OSEL = self.C_WOFF + BANK_W
        self.num_consts = self.C_OSEL + self.num_publics
        # value-RAM constant columns (only if the program has RAM rows)
        self.has_ram = any(r.ram for r in mb.rows)
        if self.has_ram:
            self.C_RMULT = self.num_consts
            self.C_RLOAD = self.num_consts + 1
            self.C_RADDR = self.num_consts + 2
            self.C_RACT = self.num_consts + 3
            self.num_consts += 4

    def ram_multiset(self):
        if not self.has_ram:
            return None
        return (self.C_RMULT, self.C_RLOAD, self.C_RADDR, self.C_RACT,
                self.COL_C)

    # -- schedule -> constant columns -------------------------------------

    def _schedule_arrays(self):
        """One pass over the recorded rows -> per-row numpy arrays of the
        schedule (row kind, round, op, literal, flags, port registers and
        the value-RAM fields)."""
        rows = self.mb.rows
        reg = self.reg
        nr = len(rows)
        kind = np.zeros(nr, np.int8)            # 0 ALU/NOP, 1 round, 2 absorb
        hround = np.zeros(nr, np.int64)
        hmode = np.zeros((nr, WIDTH), np.int8)
        op = np.zeros(nr, np.int64)
        lit = [0] * nr
        zp = np.zeros(nr, bool)
        pub = np.full(nr, -1, np.int64)
        alane = np.full(nr, -1, np.int64)
        areg = np.full(nr, -1, np.int64)
        breg = np.full(nr, -1, np.int64)
        wreg = np.full(nr, -1, np.int64)
        ram = np.zeros(nr, np.int8)
        raddr = [0] * nr
        rmult = [0] * nr
        for i, row in enumerate(rows):
            if row.hround >= 0:
                kind[i] = 1
                hround[i] = row.hround
                continue
            if row.hmode is not None:
                kind[i] = 2
                hmode[i] = row.hmode
                continue
            op[i] = row.op
            lit[i] = row.lit
            zp[i] = row.zp
            pub[i] = row.pub
            if isinstance(row.a, tuple):
                alane[i] = row.a[1]
            elif row.a is not None:
                areg[i] = reg[row.a]
            if row.b is not None:
                breg[i] = reg[row.b]
            if row.cell >= 0:
                wreg[i] = reg[row.cell]
            if row.ram:
                ram[i] = row.ram
                raddr[i] = row.ram_addr
                rmult[i] = row.ram_mult
        return dict(kind=kind, hround=hround, hmode=hmode, op=op,
                    lit=np.array(lit, dtype=np.uint64), zp=zp, pub=pub,
                    alane=alane, areg=areg, breg=breg, wreg=wreg, ram=ram,
                    raddr=np.array(raddr, dtype=np.uint64),
                    rmult=np.array(rmult, dtype=np.uint64))

    def constant_columns(self, n_rows: int):
        """(num_consts, n_rows) uint64: the schedule as public columns, the
        JAX package's row-by-row fill done column-wise (cached)."""
        if n_rows != self.n_rows:
            return np.zeros((self.num_consts, n_rows), dtype=np.uint64)
        cached = self.__dict__.get("_consts")
        if cached is not None:
            return cached
        out = np.zeros((self.num_consts, n_rows), dtype=np.uint64)
        sa = self._schedule_arrays()
        nr = len(self.mb.rows)

        rnd = np.nonzero(sa["kind"] == 1)[0]
        rr = sa["hround"][rnd]
        out[self.C_ROUND, rnd] = 1
        partial = (rr >= _HALF_F) & (rr < _HALF_F + ps.PARTIAL_ROUNDS)
        out[self.C_PP, rnd[partial]] = 1
        out[self.C_FF, rnd[~partial]] = 1
        rc = np.array(ps.round_constants(), dtype=np.uint64)
        out[self.C_RC:self.C_RC + WIDTH, rnd] = rc[rr].T

        ab = np.nonzero(sa["kind"] == 2)[0]
        modes = sa["hmode"][ab]
        out[self.C_C2:self.C_C2 + WIDTH, ab] = (modes == L_COPY).T
        out[self.C_C3:self.C_C3 + WIDTH, ab] = (modes == L_ZERO).T

        # ALU/NOP rows copy the hash state; pad rows too
        alu = np.nonzero(sa["kind"] == 0)[0]
        out[self.C_C2:self.C_C2 + WIDTH, alu] = 1
        out[self.C_C2:self.C_C2 + WIDTH, nr:] = 1
        act = alu[sa["op"][alu] != OP_NOP]
        op = sa["op"][act]
        out[self.C_LOAD, act[op == OP_LOAD]] = 1
        out[self.C_MUL, act[op == OP_MUL]] = 1
        out[self.C_AXPY, act[op == OP_AXPY]] = 1
        out[self.C_BIT, act[op == OP_BIT]] = 1
        with_lit = act[(op == OP_LOAD) | (op == OP_AXPY)]
        out[self.C_LIT, with_lit] = sa["lit"][with_lit]
        out[self.C_ZP, act[sa["zp"][act]]] = 1
        sel = act[sa["pub"][act] >= 0]
        out[self.C_OSEL + sa["pub"][sel], sel] = 1
        sel = act[sa["alane"][act] >= 0]
        out[self.C_HSEL + sa["alane"][sel], sel] = 1
        for key, cbank, coff in (("areg", self.C_ABANK, self.C_AOFF),
                                 ("breg", self.C_BBANK, self.C_BOFF),
                                 ("wreg", self.C_WBANK, self.C_WOFF)):
            sel = act[sa[key][act] >= 0]
            k = sa[key][sel]
            out[cbank + k // BANK_W, sel] = 1
            out[coff + k % BANK_W, sel] = 1
        if self.has_ram:
            ram = sa["ram"][act]
            st = act[ram == 1]
            out[self.C_RMULT, st] = sa["rmult"][st]
            out[self.C_RLOAD, act[ram == 2]] = 1
            acc = act[ram > 0]
            out[self.C_RADDR, acc] = sa["raddr"][acc]
            out[self.C_RACT, acc] = 1
        self._consts = out
        return out

    def schedule_digest(self) -> str:
        """Witness-independent identity of the program (a verifier's
        claim-shape rebuild must give the prover's)."""
        import hashlib
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(
            self.constant_columns(self.n_rows)).tobytes())
        return h.hexdigest()

    # -- constraints (ring-generic, grouped tensors) -----------------------

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        K = self.K
        cs = []
        h = _stackring([local[self.COL_H + j] for j in range(WIDTH)])
        hn = _stackring([next_row[self.COL_H + j] for j in range(WIDTH)])
        x3 = _stackring([local[self.COL_X3 + j] for j in range(WIDTH)])
        x7 = _stackring([local[self.COL_X7 + j] for j in range(WIDTH)])
        rc = _stackring([consts[self.C_RC + j] for j in range(WIDTH)])
        c2 = _stackring([consts[self.C_C2 + j] for j in range(WIDTH)])
        c3 = _stackring([consts[self.C_C3 + j] for j in range(WIDTH)])
        R = consts[self.C_ROUND]
        Ff, Pp = consts[self.C_FF], consts[self.C_PP]

        t = alg.add(h, rc)
        # S-box splitters (witnessed on every row; rc = 0 off rounds)
        cs.append(alg.sub(x3, alg.mul(alg.mul(t, t), t)))
        cs.append(alg.sub(x7, alg.mul(alg.mul(x3, x3), t)))

        # sbox blend: full → x7 everywhere; partial → x7 on lane 0, t else
        lane0 = np.zeros(WIDTH, dtype=np.uint64)
        lane0[0] = 1
        m0 = _bconst_grouped(lane0, x7)
        m0c = _bconst_grouped(1 - lane0, x7)
        part = alg.add(_mulb(x7, m0, alg), _mulb(t, m0c, alg))
        sb = alg.add(alg.mul(Ff, x7), alg.mul(Pp, part))
        mds = _mds_grouped(sb, alg)
        # lane transition: R·(h' − MDS) + c2·(h' − h) + c3·h' = 0
        cs.append(alg.add(alg.add(alg.mul(R, alg.sub(hn, mds)),
                                  alg.mul(c2, alg.sub(hn, h))),
                          alg.mul(c3, hn)))

        regs_list = [local[self.COL_R + k] for k in range(K)]
        regs_n_list = [next_row[self.COL_R + k] for k in range(K)]
        hsel = _stackring([consts[self.C_HSEL + j] for j in range(WIDTH)])

        # Bank-chunked register machinery: selects are 2-level products
        # sel_k = bank[k//BW]·off[k%BW] (only NB+16 selector constants
        # however large K is), and every (K, N)-shaped tensor is
        # processed one BANK at a time — an unchunked K=725 register
        # group at a 2^20-point LDE is a 6 GB live tensor. Per-bank
        # emission preserves the flattened
        # constraint order exactly, so α assignment (prover/verifier/
        # recursion) is unchanged.
        def _bank_sel(cb, co, nb, w):
            bank = consts[cb + nb]
            off = _stackring([consts[co + j] for j in range(w)])
            if isinstance(off, GX):
                return GX([alg.mul(o, bank) for o in off])
            return alg.mul(off, bank)

        def _port_sum(cb, co):
            acc = None
            for nb in range(self.NB):
                chunk = regs_list[nb * BANK_W:(nb + 1) * BANK_W]
                sel = _bank_sel(cb, co, nb, len(chunk))
                term = _sum0(alg.mul(sel, _stackring(chunk)), alg)
                acc = term if acc is None else alg.add(acc, term)
            return acc

        A = local[self.COL_A]
        B = local[self.COL_B]
        C = local[self.COL_C]
        one = alg.one()

        cs.append(alg.sub(A, alg.add(_port_sum(self.C_ABANK, self.C_AOFF),
                                     _sum0(alg.mul(hsel, h), alg))))
        cs.append(alg.sub(B, _port_sum(self.C_BBANK, self.C_BOFF)))

        lit = consts[self.C_LIT]
        cs.append(alg.mul(consts[self.C_LOAD], alg.sub(C, lit)))
        cs.append(alg.mul(consts[self.C_MUL], alg.sub(C, alg.mul(A, B))))
        cs.append(alg.mul(consts[self.C_AXPY],
                          alg.sub(C, alg.add(A, alg.mul(lit, B)))))
        cs.append(alg.mul(consts[self.C_BIT], alg.sub(alg.mul(C, C), C)))
        cs.append(alg.mul(consts[self.C_ZP], C))

        if self.num_publics:
            osel = _stackring([consts[self.C_OSEL + j]
                               for j in range(self.num_publics)])
            # a public may be a (1,) tensor (gl.to_fp of an int): lift it
            # as a scalar so the group stays (num_publics, *rest)
            pubs = _stackring([alg.lift(_scalar(publics[j]))
                               for j in range(self.num_publics)])
            cs.append(alg.mul(osel, alg.sub(C, pubs)))

        # register writes: R' = wsel·C + (1 − wsel)·R — emitted one bank
        # group at a time (same flattened order == same α assignment)
        for nb in range(self.NB):
            chunk = regs_list[nb * BANK_W:(nb + 1) * BANK_W]
            chunk_n = regs_n_list[nb * BANK_W:(nb + 1) * BANK_W]
            sel = _bank_sel(self.C_WBANK, self.C_WOFF, nb, len(chunk))
            rb = _stackring(chunk)
            rbn = _stackring(chunk_n)
            cs.append(alg.sub(rbn,
                              alg.add(alg.mul(sel, C),
                                      alg.mul(alg.sub(one, sel), rb))))
        return cs

    def first_row(self, alg, local, publics, consts=()):
        # sponge starts from the zero state (Challenger.new)
        return [_stackring([local[self.COL_H + j] for j in range(WIDTH)])]

    # -- witness -----------------------------------------------------------

    def make_trace(self, device=None):
        """-> ((num_cols, n_rows) trace on ``device``, publics as ints):
        numpy uint64 columns given to ``gl.to_fp`` once."""
        mb = self.mb
        n = self.n_rows
        K = self.K
        nr = len(mb.rows)
        cols = np.zeros((self.num_cols, n), dtype=np.uint64)

        # hash lanes: recorded snapshots; pad rows carry the final state
        hs = np.empty((n, WIDTH), dtype=np.uint64)
        hs[:nr] = np.array(mb.hsnap, dtype=np.uint64).reshape(nr, WIDTH)
        hs[nr:] = np.array(mb.h, dtype=np.uint64)
        cols[self.COL_H:self.COL_H + WIDTH] = hs.T

        # x3/x7 from h + rc (rc = 0 off the round rows)
        rnd = np.array([i for i, row in enumerate(mb.rows)
                        if row.hround >= 0], dtype=np.int64)
        rc_col = np.zeros((n, WIDTH), dtype=np.uint64)
        if rnd.size:
            rcs = np.array(ps.round_constants(), dtype=np.uint64)
            rc_col[rnd] = rcs[[mb.rows[i].hround for i in rnd]]
        t = hs + rc_col
        t += (t < rc_col) * ps._EPS                 # a carry: 2^64 ≡ EPS
        x3 = ps._mul_np(ps._mul_np(t, t), t)
        x7 = ps._mul_np(ps._mul_np(x3, x3), t)
        cols[self.COL_X3:self.COL_X3 + WIDTH] = _canon(x3).T
        cols[self.COL_X7:self.COL_X7 + WIDTH] = _canon(x7).T

        # registers: forward-fill between write events — one slice
        # assignment per write
        writes: List[List[Tuple[int, int]]] = [[] for _ in range(K)]
        for i, row in enumerate(mb.rows):
            if row.cell >= 0 and self.reg[row.cell] >= 0:
                writes[self.reg[row.cell]].append((i, mb.vals[row.cell]))
        for k in range(K):
            col = cols[self.COL_R + k]
            cur = 0
            start = 0
            for (i, v) in writes[k]:
                if start <= i:
                    col[start:i + 1] = cur
                cur = v
                start = i + 1
            col[start:n] = cur

        cols[self.COL_A, :nr] = np.array([row.aval % P for row in mb.rows],
                                         dtype=np.uint64)
        cols[self.COL_B, :nr] = np.array([row.bval % P for row in mb.rows],
                                         dtype=np.uint64)
        cols[self.COL_C, :nr] = np.array([row.cval % P for row in mb.rows],
                                         dtype=np.uint64)
        return gl.to_fp(cols, device), list(mb.publics)


def _scalar(p):
    """A public as a 0-d tensor (an XCell of the machine ring as it is)."""
    return p.reshape(()) if isinstance(p, torch.Tensor) else p


def _canon(x: np.ndarray) -> np.ndarray:
    return np.where(x >= np.uint64(P), x - np.uint64(P), x)


def _allocate(mb: MachineBuilder) -> Tuple[List[int], int]:
    """Linear-scan register allocation over cells.

    A cell is defined by its ALU row and lives until its last port read
    (cell ids are monotone in row order, so they double as the timeline).
    Never-read cells (every zero-pin/EQ row) get NO register — nothing
    forces a write, wsel stays all-zero and the file copies through.
    A reader may reuse a register freed by its own operand: ports read the
    register file on the SAME row, the write lands on the next row."""
    nc = len(mb.vals)
    last_use = [-1] * nc
    for row in mb.rows:
        if row.cell < 0:
            continue
        for src in (row.a, row.b):
            if isinstance(src, int):
                last_use[src] = max(last_use[src], row.cell)
    free: List[int] = []
    next_reg = 0
    reg = [-1] * nc
    expiry = {}
    for c in range(nc):
        for dead in expiry.pop(c, []):
            free.append(reg[dead])
        if last_use[c] < 0:
            continue
        if free:
            reg[c] = free.pop()
        else:
            reg[c] = next_reg
            next_reg += 1
        expiry.setdefault(last_use[c], []).append(c)
    return reg, max(next_reg, 1)


# ---------------------------------------------------------------------------
# Transcript recorder (mirrors challenger.Challenger exactly)
# ---------------------------------------------------------------------------

class _TranscriptRec:
    """Replays the Fiat-Shamir transcript as machine rows: absorbs are
    free-lane overwrites EQ-pinned to register cells, squeezes are lane
    reads after the in-trace permutation."""

    def __init__(self, mb: MachineBuilder):
        self.mb = mb
        self.pending: List[int] = []
        # Challenger.new starts from the ZERO state: the first absorb
        # zeroes every non-absorbed lane so a transcript may start
        # anywhere in the program (reduce nodes replay several)
        self.fresh = True

    def _absorb(self, chunk: List[int]) -> None:
        rest = L_ZERO if self.fresh else L_COPY
        self.fresh = False
        modes = ([(L_FREE, c) for c in chunk]
                 + [(rest, None)] * (WIDTH - len(chunk)))
        self.mb.absorb_then_permute(modes)

    def observe(self, cells: Sequence[int]) -> None:
        allc = self.pending + list(cells)
        nfull = len(allc) // RATE
        for i in range(nfull):
            self._absorb(allc[i * RATE:(i + 1) * RATE])
        self.pending = allc[nfull * RATE:]

    def _flush(self) -> None:
        if not self.pending:
            return
        self._absorb(self.pending)
        self.pending = []

    def squeeze(self, n: int) -> List[int]:
        self._flush()
        outs: List[int] = []
        rem = n
        while rem > 0:
            take = min(rem, RATE)
            outs += [self.mb.mov_lane(j) for j in range(take)]
            self.mb.permute_rounds()
            rem -= take
        return outs

    def squeeze_ext(self):
        o = self.squeeze(2)
        return (o[0], o[1])


# ---------------------------------------------------------------------------
# Streaming: transcript-replay binding for wide inner AIRs
# ---------------------------------------------------------------------------
#
# Problem: the plain recorder loads every ζ/gζ opening up front and keeps it live until ALI/DEEP consume it — for a
# 799-column HeaderAir that is ~4k simultaneously-live cells and the
# K-register file (and its 3K one-hot selector constants) explodes.
#
# Fix: openings are loaded in 8-cell groups, absorbed into the transcript
# and DIE immediately. After the transcript completes, the consume pass
# re-witnesses each value where ALI/DEEP need it and REPLAYS the
# transcript's opening segment with the re-witnessed cells: starting from
# the captured sponge state S0 (right after the ζ squeeze) the replay
# emits the exact same absorb-row sequence and must land on the captured
# state S1 (the state β was squeezed from). Sponge-chain collision
# resistance then binds every re-witnessed cell to the absorbed original
# — the same computational argument that backs the Merkle caps. No
# protocol change: prover/verifier transcripts are untouched.
#
# Two cooperating mechanisms:
#
# 1. REPLAY PASS (the binding + DEEP S-sums): one eager pass in
#    transcript order re-witnesses every opening cell, STOREs it to the
#    value RAM (air.ram_multiset — addresses are slot indices), absorbs
#    it into the replay sponge and folds the running-β DEEP S-sums.
#    Cells die within their chunk: K contribution ≈ 16.
# 2. RAM-LOADED HANDLES (the ALI consume side): constraint code receives
#    _RefCell handles that resolve to a CURRENT cell at every component
#    access; a cell older than RAM_SPAN rows is re-witnessed via a
#    RAM LOAD — the multiset argument (γ, δ squeezed after the outer
#    trace commit) forces every load to replay some store. Register
#    liveness is span-bounded no matter how long the Python constraint
#    code holds a reference (the JAX package measured a HeaderAir(1)
#    leaf at span 256: K ≈ 386 against 2875 unbounded).
#
# Store multiplicities (static load counts) are back-patched at finish.
# Schedule depends only on (inner_air, log_n, config): touch order is
# the AIR's static constraint-evaluation order, never a witness value.

RAM_SPAN = 256           # rows a RAM-loaded opening cell stays live
STREAM_MIN_CELLS = 1024  # auto-enable streaming above this opening count


def _xpow_static(mb: MachineBuilder, x, e: int):
    """x^e for a STATIC exponent e >= 0 (square-and-multiply)."""
    one_x = (mb.const(1), mb.const(0))
    if e == 0:
        return one_x
    acc = None
    base = x
    while True:
        if e & 1:
            acc = base if acc is None else mb.xmul(acc, base)
        e >>= 1
        if e == 0:
            return acc
        base = mb.xmul(base, base)


class _RefCell(tuple):
    """Lazy XCell: component access resolves to the CURRENT span-fresh
    RAM-load cells, so holding this Python object indefinitely costs no
    register liveness — every use site re-resolves (and re-loads through
    the multiset when stale). isinstance(tuple) and len 2 keep it
    duck-compatible with plain XCells everywhere in the machine ring."""

    def __new__(cls, streamer, vi: int, i: int):
        self = super().__new__(cls, (-1, -1))
        self.st = streamer
        self.vi = vi
        self.i = i
        return self

    def __getitem__(self, k):
        return self.st.touch(self.vi, self.i)[k]

    def __iter__(self):
        return iter(self.st.touch(self.vi, self.i))


class _LazyVec:
    """Opening-vector handle: presents (m,) _RefCells. Slicing returns
    plain lists of _RefCells without materializing anything."""

    def __init__(self, streamer, vi: int, m: int):
        self.st = streamer
        self.vi = vi
        self.m = m

    def __len__(self):
        return self.m

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.m))]
        if i < 0:
            i += self.m
        return _RefCell(self.st, self.vi, i)

    def __iter__(self):
        for i in range(self.m):
            yield self[i]


class _OpeningStreamer:
    """Slot-space manager for the streamed consume pass (see module-level
    phase-5 notes above). Vectors are registered in transcript-absorb
    order; slot layout per vector = m re-slots then m im-slots, matching
    load order. Produces the DEEP S-sums and the replay-state equality."""

    def __init__(self, mb: MachineBuilder, beta):
        self.mb = mb
        self.beta = beta
        self.vecs = []          # (name, values[(re,im)], m)
        self.cells = []         # per vec: current LOAD pair or None
        self.birth = []         # per vec: row index the pair was loaded
        self.vec_base = []      # vi -> first global slot of its re-block
        self.s0 = None          # 4 cells: transcript lanes 8..11 at seg start
        self.s1 = None          # 12 cells: transcript state β was read from
        self.addr_base = None
        self.finished = False
        self.replayed = False
        self.n_accesses = 0
        self.n_loads = 0
        self.loads = {}         # (vi, i) -> load count (mult back-patch)
        self.store_refs = []    # (store_cell, vi, i)
        self.block_acc = {}     # 2*vi+half -> closed S accumulator
        self.total = 0

    def add_vec(self, name: str, values, m: int) -> _LazyVec:
        vi = len(self.vecs)
        self.vecs.append((name, values, m))
        self.cells.append([None] * m)
        self.birth.append([0] * m)
        self.vec_base.append(self.total)
        self.total += 2 * m
        return _LazyVec(self, vi, m)

    def _addr(self, vi: int, half: int, i: int) -> int:
        return self.addr_base + self.vec_base[vi] + half * self.vecs[vi][2] + i

    # -- consume side (RAM loads, span-bounded liveness) -------------------

    def touch(self, vi: int, i: int):
        self.n_accesses += 1
        cc = self.cells[vi][i]
        now = len(self.mb.rows)
        if cc is not None and now - self.birth[vi][i] <= RAM_SPAN:
            return cc
        re, im = self.vecs[vi][1][i]
        cc = (self.mb.ram_load(re, self._addr(vi, 0, i)),
              self.mb.ram_load(im, self._addr(vi, 1, i)))
        self.cells[vi][i] = cc
        self.birth[vi][i] = now
        self.loads[(vi, i)] = self.loads.get((vi, i), 0) + 1
        self.n_loads += 2
        return cc

    # -- binding side ------------------------------------------------------

    def replay_pass(self) -> None:
        """One eager pass in transcript order: fresh witnesses STORE to
        the RAM, absorb into the replay sponge (S0 chunk-chain must land
        on S1 — collision resistance binds them to the transcript
        originals) and fold the DEEP S-sums with the prover's running-β
        weights. Every cell dies within its chunk."""
        assert not self.replayed
        if self.addr_base is None:
            self.addr_base = self.mb.ram_addr_base
            self.mb.ram_addr_base += self.total
        mb = self.mb
        pending = []
        first = True

        def flush(final=False):
            nonlocal first, pending
            if not pending and not final:
                return
            modes = [(L_FREE, c) for c in pending]
            if first:
                assert len(pending) == RATE, "first opening chunk is full"
                modes += [(L_FREE, c) for c in self.s0]
            else:
                modes += [(L_COPY, None)] * (WIDTH - len(pending))
            mb.absorb_then_permute(modes)
            first = False
            pending = []

        for vi, (name, values, m) in enumerate(self.vecs):
            for half in (0, 1):
                acc = (mb.const(0), mb.const(0))
                pw = (mb.const(1), mb.const(0))
                for i in range(m):
                    c = mb.loadw(values[i][half])
                    mb.ram_store(c, self._addr(vi, half, i))
                    self.store_refs.append((c, vi, i))
                    acc = mb.xadd(acc, mb.xmul_base(pw, c))
                    pw = mb.xmul(pw, self.beta)
                    pending.append(c)
                    if len(pending) == RATE:
                        flush()
                self.block_acc[2 * vi + half] = acc
        flush(final=bool(pending))
        for j in range(WIDTH):
            mb.eq_lane(j, self.s1[j])
        self.replayed = True

    def _umul(self, x):
        """u·x for u² = W: (a, b) -> (W·b, a)."""
        return (self.mb.scale(x[1], W), x[0])

    def s_sum(self, vi: int):
        """Σ_i β^i · v_i over vector vi (Fp2) — requires replay_pass()."""
        assert self.replayed
        acc_re = self.block_acc[2 * vi]
        acc_im = self.block_acc[2 * vi + 1]
        return self.mb.xadd(acc_re, self._umul(acc_im))

    def finish(self) -> None:
        """Back-patch store multiplicities (static load counts) — every
        store accounts for exactly its loads, 0 included."""
        if self.finished:
            return
        assert self.replayed
        for (c, vi, i) in self.store_refs:
            self.mb.ram_set_mult(c, self.loads.get((vi, i), 0))
        self.finished = True


# ---------------------------------------------------------------------------
# Full verification recorder
# ---------------------------------------------------------------------------

def _np_int(t) -> np.ndarray:
    """Port Fp tensor (any device, any shape) -> numpy object array of
    Python ints."""
    return gl.from_fp(t)


def _zero_proof(air: Air, log_n: int, config):
    """A zero-filled StarkProof of the right SHAPE (host tensors) — used to
    rebuild the outer AIR's schedule without the witness (verifier side)."""
    from .serialize import empty_proof_like_shapes
    return empty_proof_like_shapes(air, config, log_n)


def record_stark_verify(mb: MachineBuilder, inner_air: Air, proof,
                        publics_cells: Sequence[int], log_n: int,
                        config, stream: Optional[bool] = None,
                        stats: Optional[dict] = None, device=None) -> None:
    """Emit the COMPLETE DEEP-ALI verification of `proof` as machine rows:
    transcript replay, ALI at ζ (incl. LogUp terms), Merkle membership of
    every opening, DEEP recomputation at the query points and the FRI
    fold/final-poly checks. Every check is zero-pinned; `publics_cells`
    are the inner publics (already in registers — pin them to outer
    publics or link them across children as the caller wishes).

    Mirrors verifier.py / fri.verify step for step; the schedule depends
    only on (inner_air, log_n, config, len(publics_cells)) — tests assert
    this via RecursionAir.schedule_digest against a _zero_proof build.
    ``device``: where the inner AIR's constant VK is computed (default: the
    proof's device)."""
    from .prover import num_quotient_chunks, _padded_lk

    n = 1 << log_n
    rate = config.rate_bits
    log_nlde = log_n + rate
    n_lde = n << rate
    half0 = n_lde // 2
    db = log_nlde - 1
    n_chunks = num_quotient_chunks(inner_air)
    fri_cfg = config.fri_config
    num_layers = fri_cfg.num_layers(log_nlde)
    fl = fri_cfg.final_poly_len
    q = config.num_queries
    assert num_layers >= 1, "recursion needs >= 1 FRI layer"
    assert config.cap_height == 0, "recursion: cap_height 0 only (for now)"
    # the port's verifier flushes the pending buffer before the nonce when
    # pow_bits > 0; the transcript replayed here matches it only where that
    # flush is a no-op (2·final_poly_len a multiple of RATE)
    assert (config.pow_bits == 0
            or (2 * config.final_poly_len) % RATE == 0), \
        "recursion: pow_bits > 0 needs 2 * final_poly_len % RATE == 0"
    n_consts = int(np.asarray(inner_air.constant_columns(n)).shape[0])
    has_consts = n_consts > 0
    lk_cols = inner_air.lookup_range_columns()
    has_lk = len(lk_cols) > 0
    ram_inner = inner_air.ram_multiset()
    has_ram_inner = ram_inner is not None
    has_aux = has_lk or has_ram_inner
    if has_ram_inner:
        assert n_consts > 0, "RAM AIRs carry their flags in const columns"
    lk_p = _padded_lk(lk_cols) if has_lk else []
    kk2 = len(lk_p) // 2
    g_dom = gl.primitive_root_of_unity(log_n)
    g_last = pow(g_dom, n - 1, P)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    w_lde = gl.primitive_root_of_unity(log_nlde)
    from . import fri as fri_mod

    C = inner_air.num_cols
    from .prover import num_aux_cols
    A = num_aux_cols(len(lk_cols), has_ram_inner) if has_aux else 0
    n_open_cells = 2 * (2 * C + (2 * A if has_aux else 0)
                        + (2 * n_consts if has_consts else 0) + n_chunks)
    if stream is None:
        stream = n_open_cells >= STREAM_MIN_CELLS

    tr = _TranscriptRec(mb)
    one = mb.const(1)
    zero = mb.const(0)
    one_x = (one, zero)

    def load_digests(fp_arr) -> List[int]:
        vals = _np_int(fp_arr).reshape(-1)
        return [mb.loadw(int(v)) for v in vals]

    def load_ext_vec(fp2_vec, m) -> List[Tuple[int, int]]:
        """Load an (m,) Fp2 opening vector; observe-order = all re then
        all im. Returns XCells."""
        re = _np_int(fp2_vec[0])
        im = _np_int(fp2_vec[1])
        re_c = [mb.loadw(int(re[i])) for i in range(m)]
        im_c = [mb.loadw(int(im[i])) for i in range(m)]
        tr.observe(re_c + im_c)
        return list(zip(re_c, im_c))

    # -- transcript -------------------------------------------------------
    tr.observe(list(publics_cells))
    if has_consts:
        # the preprocessed-constant VK cap enters as SCHEDULE LITERALS —
        # part of the outer claim's identity (outer_air_for recomputes the
        # same cap from the inner AIR), exactly plonky2's
        # constants_sigmas_cap role. Openings below are witness bound to
        # it by Merkle paths + the DEEP terms.
        from . import prover as _pv
        vk_dev = device if device is not None else proof.trace_cap.device
        vk_cap_vals = _np_int(_pv.constant_vk(inner_air, log_n, config,
                                              vk_dev)[0].cap).reshape(-1)
        vk_cap = [mb.load(int(v)) for v in vk_cap_vals]
        tr.observe(vk_cap)
    trace_cap = load_digests(proof.trace_cap)
    tr.observe(trace_cap)
    if has_aux:
        gamma = tr.squeeze_ext()
        if has_ram_inner:
            delta_r = tr.squeeze_ext()
        aux_cap = load_digests(proof.aux_cap)
        tr.observe(aux_cap)
    alpha = tr.squeeze_ext()
    quot_cap = load_digests(proof.quotient_cap)
    tr.observe(quot_cap)
    zeta = tr.squeeze_ext()

    if stream:
        # phase-5 streaming: cells absorb chunk-wise and die; the consume
        # pass re-witnesses them under the transcript-replay binding
        st = _OpeningStreamer(mb, None)
        st.s0 = [mb.mov_lane(RATE + j) for j in range(ps.CAPACITY)]

        def load_vec_streamed(fp2_vec, m, name):
            re = _np_int(fp2_vec[0])
            im = _np_int(fp2_vec[1])
            vals = [(int(re[i]), int(im[i])) for i in range(m)]
            h = st.add_vec(name, vals, m)
            flat = [int(re[i]) for i in range(m)] + [int(im[i])
                                                     for i in range(m)]
            for j in range(0, len(flat), RATE):
                cells = [mb.loadw(v) for v in flat[j:j + RATE]]
                tr.observe(cells)
            return h

        tz = load_vec_streamed(proof.trace_zeta, C, 'tz')
        tgz = load_vec_streamed(proof.trace_gzeta, C, 'tgz')
        if has_aux:
            az = load_vec_streamed(proof.aux_zeta, A, 'az')
            agz = load_vec_streamed(proof.aux_gzeta, A, 'agz')
        if has_consts:
            cz = load_vec_streamed(proof.const_zeta, n_consts, 'cz')
            cgz = load_vec_streamed(proof.const_gzeta, n_consts, 'cgz')
        qz = load_vec_streamed(proof.quotient_zeta, n_chunks, 'qz')
        vi_q = len(st.vecs) - 1
        tr._flush()
        st.s1 = [mb.mov_lane(j) for j in range(WIDTH)]
        beta = tr.squeeze_ext()
        st.beta = beta
    else:
        tz = load_ext_vec(proof.trace_zeta, C)
        tgz = load_ext_vec(proof.trace_gzeta, C)
        if has_aux:
            az = load_ext_vec(proof.aux_zeta, A)
            agz = load_ext_vec(proof.aux_gzeta, A)
        if has_consts:
            cz = load_ext_vec(proof.const_zeta, n_consts)
            cgz = load_ext_vec(proof.const_gzeta, n_consts)
        qz = load_ext_vec(proof.quotient_zeta, n_chunks)
        beta = tr.squeeze_ext()

    fri_caps: List[List[int]] = []
    fold_betas = []
    for L in range(num_layers):
        capL = load_digests(proof.fri_proof.caps[L])
        tr.observe(capL)
        fri_caps.append(capL)
        fold_betas.append(tr.squeeze_ext())
    fc_re = _np_int(proof.fri_proof.final_coeffs[0])
    fc_im = _np_int(proof.fri_proof.final_coeffs[1])
    fc_re_c = [mb.loadw(int(fc_re[i])) for i in range(fl)]
    fc_im_c = [mb.loadw(int(fc_im[i])) for i in range(fl)]
    tr.observe(fc_re_c + fc_im_c)
    fc = list(zip(fc_re_c, fc_im_c))

    nonce = mb.loadw(int(_np_int(proof.fri_proof.pow_nonce)))
    tr.observe([nonce])
    resp = tr.squeeze(1)[0]
    if fri_cfg.pow_bits > 0:
        rbits = mb.decompose64(resp)
        for b in rbits[:fri_cfg.pow_bits]:
            mb.assert_zero(b)
    idx_cells = tr.squeeze(q)
    if stats is not None:
        stats['rows_transcript'] = len(mb.rows)

    # -- ALI at ζ ---------------------------------------------------------
    if stream:
        # binding + DEEP S-sums first: every opening is stored to the
        # value RAM and replayed onto the captured transcript states;
        # the ALI pass below then consumes span-fresh RAM loads
        st.replay_pass()
    alg = XAlgMB(mb)
    publics_x = [(c, zero) for c in publics_cells]
    consts_x = cz if has_consts else []
    consts_next_x = cgz if has_consts else []
    if stream:
        # generator: constraint rows emit lazily inside comb() below, so
        # each group's result cells fold into the ALI accumulator as soon
        # as they exist (liveness-capped recording)
        ct = inner_air.transition_iter(alg, tz, tgz, publics_x, consts_x,
                                       consts_next_x)
    else:
        ct = inner_air.transition(alg, tz, tgz, publics_x, consts_x,
                                  consts_next_x)
    cf = inner_air.first_row(alg, tz, publics_x, consts_x)
    cl = inner_air.last_row(alg, tz, publics_x, consts_x)

    def recomb(re_xc, im_xc):
        """ext element stored as two base columns: re + u·im."""
        a, b = re_xc
        c, d = im_xc
        return (mb.axpy(a, d, W), mb.add(b, c))

    if has_lk:
        invs = [recomb(az[2 * j], az[2 * j + 1]) for j in range(kk2)]
        inv_t = recomb(az[2 * kk2], az[2 * kk2 + 1])
        m_z = az[2 * kk2 + 2]
        s_z = recomb(az[2 * kk2 + 3], az[2 * kk2 + 4])
        s_gz = recomb(agz[2 * kk2 + 3], agz[2 * kk2 + 4])
        t_z = az[2 * kk2 + 5]
        t_gz = agz[2 * kk2 + 5]
        defs = []
        contrib = (zero, zero)
        for j in range(kk2):
            d0 = mb.xsub(gamma, tz[lk_p[2 * j]])
            d1 = mb.xsub(gamma, tz[lk_p[2 * j + 1]])
            defs.append(mb.xsub(mb.xmul(mb.xmul(d0, d1), invs[j]), one_x))
            contrib = mb.xadd(contrib, mb.xmul(invs[j], mb.xadd(d0, d1)))
        contrib = mb.xsub(contrib, mb.xmul(m_z, inv_t))
        def_t = mb.xsub(mb.xmul(mb.xsub(gamma, t_z), inv_t), one_x)
        lk_e = defs + [def_t]
        lk_t = [mb.xsub(mb.xsub(s_gz, s_z), contrib),
                mb.xsub(mb.xsub(t_gz, t_z), one_x)]
        lk_f = [s_z, t_z]
        lk_l = [mb.xadd(s_z, contrib)]
    else:
        lk_e = lk_t = lk_f = lk_l = []

    if has_ram_inner:
        # mirror prover._ram_constraint_evals in the machine ring
        mult_c, ld_c, ad_c, act_c, val_col = ram_inner
        base_r = (2 * kk2 + 6) if has_lk else 0
        inv_z = recomb(az[base_r], az[base_r + 1])
        sR_z = recomb(az[base_r + 2], az[base_r + 3])
        sR_gz = recomb(agz[base_r + 2], agz[base_r + 3])
        fp_r = mb.xsub(gamma, mb.xadd(cz[ad_c],
                                      mb.xmul(delta_r, tz[val_col])))
        def_i = mb.xsub(mb.xmul(fp_r, inv_z), cz[act_c])
        contrib_r = mb.xmul(mb.xsub(cz[mult_c], cz[ld_c]), inv_z)
        lk_e = list(lk_e) + [def_i]
        lk_t = list(lk_t) + [mb.xsub(mb.xsub(sR_gz, sR_z), contrib_r)]
        lk_f = list(lk_f) + [sR_z]
        lk_l = list(lk_l) + [mb.xadd(sR_z, contrib_r)]

    k_pow = [one_x]

    def comb(cs, acc):
        for g in cs:
            # grouped constraints flatten in stack order — the same α-power
            # order the prover's _combine assigns to the group axis
            for c in (g if isinstance(g, GX) else [g]):
                acc = mb.xadd(acc, mb.xmul(k_pow[0], c))
                k_pow[0] = mb.xmul(k_pow[0], alpha)
        return acc

    zero_x = (zero, zero)
    ct_c = comb(ct, zero_x)
    ct_c = comb(lk_t, ct_c)
    cf_c = comb(cf, zero_x)
    cf_c = comb(lk_f, cf_c)
    cl_c = comb(cl, zero_x)
    cl_c = comb(lk_l, cl_c)
    ce_c = comb(lk_e, zero_x)

    zn = zeta
    for _ in range(log_n):
        zn = mb.xmul(zn, zn)
    zh = mb.xsub(zn, one_x)
    zm1 = mb.xsub(zeta, one_x)
    zmg = mb.xsub(zeta, mb.xconst(g_last))
    inv_zh = mb.xinv_checked(zh)
    inv_zm1 = mb.xinv_checked(zm1)
    inv_zmg = mb.xinv_checked(zmg)
    expected = mb.xadd(
        mb.xadd(mb.xmul(mb.xmul(ct_c, zmg), inv_zh),
                mb.xmul(cf_c, inv_zm1)),
        mb.xadd(mb.xmul(cl_c, inv_zmg), mb.xmul(ce_c, inv_zh)))
    opened_q = zero_x
    zn_pow = one_x
    for i in range(n_chunks):
        opened_q = mb.xadd(opened_q, mb.xmul(zn_pow, qz[i]))
        zn_pow = mb.xmul(zn_pow, zn)
    mb.xeq(expected, opened_q)
    if stats is not None:
        stats['rows_after_ali'] = len(mb.rows)
        if stream:
            stats['touches'] = sum(1 for v in st.cells for c in v
                                   if c is not None)
            stats['accesses'] = st.n_accesses
            stats['total_open'] = st.total

    # -- DEEP S-sums (query-independent ζ-side weighted sums) --------------
    g_zeta = mb.xscale(zeta, g_dom)
    if stream:
        # the streamer folded every β^i·v_i at drain time (same weights
        # as the loops below); close it out and run the replay-binding
        # equality against the captured transcript state
        st.finish()
        S_z = st.s_sum(0)
        S_gz = st.s_sum(1)
        off1 = _xpow_static(mb, beta, C)
        off2 = _xpow_static(mb, beta, 2 * C)
        if has_aux:
            S_az = st.s_sum(2)
            S_agz = st.s_sum(3)
            off3 = _xpow_static(mb, beta, 2 * C + A)
            off4 = _xpow_static(mb, beta, 2 * C + 2 * A)
        else:
            off3 = off4 = off2
        if has_consts:
            ci = 4 if has_aux else 2
            S_cz = st.s_sum(ci)
            S_cgz = st.s_sum(ci + 1)
            base_e = 2 * C + (2 * A if has_aux else 0)
            off_cz = off4
            off_cgz = _xpow_static(mb, beta, base_e + n_consts)
            off_q = _xpow_static(mb, beta, base_e + 2 * n_consts)
        else:
            off_cz = off_cgz = off_q = off4
        S_q = st.s_sum(vi_q)
    else:
        pw = one_x
        S_z = zero_x
        S_gz = zero_x
        for c in range(C):
            S_z = mb.xadd(S_z, mb.xmul(pw, tz[c]))
            S_gz = mb.xadd(S_gz, mb.xmul(pw, tgz[c]))
            pw = mb.xmul(pw, beta)
        off1 = pw                                  # β^C
        off2 = mb.xmul(off1, off1)                 # β^{2C}
        if has_aux:
            pwa = one_x
            S_az = zero_x
            S_agz = zero_x
            for c in range(A):
                S_az = mb.xadd(S_az, mb.xmul(pwa, az[c]))
                S_agz = mb.xadd(S_agz, mb.xmul(pwa, agz[c]))
                pwa = mb.xmul(pwa, beta)
            off3 = mb.xmul(off2, pwa)              # β^{2C+A}
            off4 = mb.xmul(off3, pwa)              # β^{2C+2A}
        else:
            off3 = off4 = off2
        if has_consts:
            pwc = one_x
            S_cz = zero_x
            S_cgz = zero_x
            for c in range(n_consts):
                S_cz = mb.xadd(S_cz, mb.xmul(pwc, cz[c]))
                S_cgz = mb.xadd(S_cgz, mb.xmul(pwc, cgz[c]))
                pwc = mb.xmul(pwc, beta)
            off_cz = off4                          # β^{2C+2A}
            off_cgz = mb.xmul(off_cz, pwc)         # β^{2C+2A+Cc}
            off_q = mb.xmul(off_cgz, pwc)          # β^{2C+2A+2Cc}
        else:
            off_cz = off_cgz = off_q = off4
        pwq = one_x
        S_q = zero_x
        for i in range(n_chunks):
            S_q = mb.xadd(S_q, mb.xmul(pwq, qz[i]))
            pwq = mb.xmul(pwq, beta)

    if stats is not None:
        stats['rows_after_ssums'] = len(mb.rows)
    # -- per-query checks --------------------------------------------------
    tra = _np_int(proof.trace_rows_a)
    trb = _np_int(proof.trace_rows_b)
    tpa = _np_int(proof.trace_paths_a)
    tpb = _np_int(proof.trace_paths_b)
    qra = _np_int(proof.quot_rows_a)
    qrb = _np_int(proof.quot_rows_b)
    qpa = _np_int(proof.quot_paths_a)
    qpb = _np_int(proof.quot_paths_b)
    if has_aux:
        ara = _np_int(proof.aux_rows_a)
        arb = _np_int(proof.aux_rows_b)
        apa = _np_int(proof.aux_paths_a)
        apb = _np_int(proof.aux_paths_b)
    if has_consts:
        cra = _np_int(proof.const_rows_a)
        crb = _np_int(proof.const_rows_b)
        cpa = _np_int(proof.const_paths_a)
        cpb = _np_int(proof.const_paths_b)
    fri_leaves = [_np_int(x) for x in proof.fri_proof.query_leaves]
    fri_paths = [_np_int(x) for x in proof.fri_proof.query_paths]

    def leaf_commit_and_sum(values, beta_x=None):
        """Sponge-commit a leaf row, optionally β-accumulating its values
        (the per-query side of the DEEP weighted sums). Leaves the digest
        in the sponge lanes; returns (cells, T-sum-or-None)."""
        nch = max(1, -(-len(values) // RATE))
        acc = [zero_x, one_x]          # [T-sum, running β power]
        all_cells: List[int] = []
        for j in range(nch):
            chunk_vals = values[j * RATE:(j + 1) * RATE]
            chunk = [mb.loadw(int(v)) for v in chunk_vals]
            all_cells += chunk
            modes = ([(L_FREE, cc) for cc in chunk]
                     + [(L_ZERO, None)] * (RATE - len(chunk)))
            modes += [(L_ZERO if j == 0 else L_COPY, None)] * ps.CAPACITY

            def cb(chunk=chunk):
                for cc in chunk:
                    acc[0] = mb.xadd(acc[0], mb.xmul_base(acc[1], cc))
                    acc[1] = mb.xmul(acc[1], beta_x)

            mb.absorb_then_permute(modes,
                                   cb=cb if beta_x is not None else None)
        return all_cells, (acc[0] if beta_x is not None else None)

    def walk_path(path_vals, path_bits, cap_cells):
        """From the digest in the sponge lanes, fold sibling path levels
        (order chosen by bits) and pin the root to the cap cells."""
        depth = len(path_bits)
        for d in range(depth):
            dig = mb.read_digest()
            sib = [mb.loadw(int(path_vals[d][cmp])) for cmp in range(4)]
            b = path_bits[d]
            left, right = [], []
            for cmp in range(4):
                l = mb.mux(b, dig[cmp], sib[cmp])
                r = mb.sub(mb.add(dig[cmp], sib[cmp]), l)
                left.append(l)
                right.append(r)
            mb.compress(left, right)
        mb.eq_digest(cap_cells)

    for qi in range(q):
        bits = mb.decompose64(idx_cells[qi])
        ibits = bits[:db]

        # FRI layer leaves: commit + path-check each (cells reused below)
        leafs: List[List[int]] = []
        for L in range(num_layers):
            cells, _ = leaf_commit_and_sum(
                [fri_leaves[L][qi][cmp] for cmp in range(4)])
            leafs.append(cells)
            walk_path(fri_paths[L][qi], ibits[:db - L], fri_caps[L])

        # FRI folds + final poly (mirrors fri.verify)
        a_x = (leafs[0][0], leafs[0][1])
        b_x = (leafs[0][2], leafs[0][3])
        cur = None
        for L in range(num_layers):
            if L > 0:
                aL = (leafs[L][0], leafs[L][1])
                bL = (leafs[L][2], leafs[L][3])
                expect = mb.xmux(ibits[db - L], aL, bL)
                mb.xeq(cur, expect)
                a_x, b_x = aL, bL
            shift_L, root_L, llog = fri_mod._layer_domain(log_nlde, L)
            nbits = db - L
            inv_root = pow(root_L, P - 2, P)
            inv2x = mb.scale(mb.ladder(ibits[:nbits], inv_root),
                             pow(2 * shift_L % P, P - 2, P))
            s = mb.xscale(mb.xadd(a_x, b_x), fri_mod.INV2)
            d = mb.xmul_base(mb.xsub(a_x, b_x), inv2x)
            cur = mb.xadd(s, mb.xmul(fold_betas[L], d))
        shift_F, root_F, llog_F = fri_mod._layer_domain(log_nlde, num_layers)
        x_f = mb.scale(mb.ladder(ibits[:max(llog_F, 1)], root_F), shift_F)
        acc = fc[fl - 1]
        for i in range(fl - 2, -1, -1):
            acc = mb.xadd(mb.xmul_base(acc, x_f), fc[i])
        mb.xeq(cur, acc)

        # DEEP at both halves + Merkle membership of the opened rows
        xa = mb.scale(mb.ladder(ibits, w_lde), shift)
        xb = mb.scale(xa, P - 1)
        for side, x_cell, t_rows, t_paths, q_rows, q_paths, topbit in (
                (0, xa, tra, tpa, qra, qpa, zero),
                (1, xb, trb, tpb, qrb, qpb, one)):
            xe = (x_cell, zero)
            inv_xz = mb.xinv_checked(mb.xsub(xe, zeta))
            inv_xgz = mb.xinv_checked(mb.xsub(xe, g_zeta))
            pbits = ibits + [topbit]

            t_cells, T1 = leaf_commit_and_sum(t_rows[qi], beta)
            walk_path(t_paths[qi], pbits, trace_cap)
            if has_aux:
                a_cells, Ta = leaf_commit_and_sum(ara[qi] if side == 0
                                                  else arb[qi], beta)
                walk_path(apa[qi] if side == 0 else apb[qi], pbits, aux_cap)
            if has_consts:
                c_cells, Tc = leaf_commit_and_sum(cra[qi] if side == 0
                                                  else crb[qi], beta)
                walk_path(cpa[qi] if side == 0 else cpb[qi], pbits, vk_cap)
            q_cells, _ = leaf_commit_and_sum(q_rows[qi])
            walk_path(q_paths[qi], pbits, quot_cap)
            # quotient chunk values are ext pairs of base columns
            pwq2 = one_x
            Tq = zero_x
            for i in range(n_chunks):
                qv = (q_cells[2 * i], q_cells[2 * i + 1])
                Tq = mb.xadd(Tq, mb.xmul(pwq2, qv))
                pwq2 = mb.xmul(pwq2, beta)

            F = mb.xmul(mb.xsub(T1, S_z), inv_xz)
            F = mb.xadd(F, mb.xmul(off1,
                                   mb.xmul(mb.xsub(T1, S_gz), inv_xgz)))
            if has_aux:
                F = mb.xadd(F, mb.xmul(off2,
                                       mb.xmul(mb.xsub(Ta, S_az), inv_xz)))
                F = mb.xadd(F, mb.xmul(off3,
                                       mb.xmul(mb.xsub(Ta, S_agz),
                                               inv_xgz)))
            if has_consts:
                F = mb.xadd(F, mb.xmul(off_cz,
                                       mb.xmul(mb.xsub(Tc, S_cz), inv_xz)))
                F = mb.xadd(F, mb.xmul(off_cgz,
                                       mb.xmul(mb.xsub(Tc, S_cgz),
                                               inv_xgz)))
            F = mb.xadd(F, mb.xmul(off_q,
                                   mb.xmul(mb.xsub(Tq, S_q), inv_xz)))
            leaf_val = ((leafs[0][0], leafs[0][1]) if side == 0
                        else (leafs[0][2], leafs[0][3]))
            mb.xeq(F, leaf_val)


# ---------------------------------------------------------------------------
# Top-level API
# ---------------------------------------------------------------------------

def _pub_ints(publics) -> List[int]:
    out = []
    for p in publics:
        if isinstance(p, (int, np.integer)):
            out.append(int(p) % P)
        else:
            v = _np_int(p).reshape(-1)
            assert v.size == 1, "a public is one field element"
            out.append(int(v[0]))
    return out


def _mark(timer, phase: str) -> None:
    if timer is not None:
        timer(phase)


def _prove_machine(mb: MachineBuilder, outer_config, device, timer):
    """RecursionAir over a recorded program -> (air, proof, publics).
    ``timer(phase)``, if given, is called as each phase ends: record (the
    caller's), constants, witness, then the prover's phases."""
    from . import prover as pv
    device = default_device(device)
    _mark(timer, "record")
    air = RecursionAir(mb)
    air.constant_columns(air.n_rows)
    _mark(timer, "constants")
    trace, pubs = air.make_trace(device)
    pubs_fp = [gl.to_fp(p, device) for p in pubs]
    _mark(timer, "witness")
    proof = pv.prove(air, trace, pubs_fp, outer_config, timer=timer)
    return air, proof, pubs


def prove_recursive(inner_air: Air, inner_proof, inner_publics,
                    inner_log_n: int, inner_config, outer_config,
                    stream: Optional[bool] = None, device=None, timer=None):
    """ONE outer proof attesting `verifier.verify(inner_air, inner_proof,
    publics) == True` — fully in-AIR (transcript, Merkle, ALI, DEEP, FRI).
    Returns (outer_air, outer_proof, outer_publics). Outer publics ==
    inner publics. The outer proof is made on ``device`` (the current CUDA
    device unless named)."""
    mb = MachineBuilder()
    cells = [mb.pin_public(v) for v in _pub_ints(inner_publics)]
    record_stark_verify(mb, inner_air, inner_proof, cells, inner_log_n,
                        inner_config, stream=stream)
    return _prove_machine(mb, outer_config, device, timer)


def outer_air_for(inner_air: Air, inner_log_n: int, inner_config,
                  num_publics: int, stream: Optional[bool] = None,
                  device=None) -> RecursionAir:
    """Rebuild the outer AIR from the CLAIM SHAPE alone (zero-filled proof)
    — what a verifier uses; its schedule must equal the prover's.
    ``device``: where an inner constant VK is recomputed."""
    mb = MachineBuilder()
    cells = [mb.pin_public(0) for _ in range(num_publics)]
    record_stark_verify(mb, inner_air, _zero_proof(inner_air, inner_log_n,
                                                   inner_config),
                        cells, inner_log_n, inner_config, stream=stream,
                        device=default_device(device))
    return RecursionAir(mb)


def record_reduce(children, links, expose,
                  stream: Optional[bool] = None) -> MachineBuilder:
    """The reduce node's program: the children's publics as cells, the
    exposed publics pinned, the links, then every child's verification."""
    mb = MachineBuilder()
    cell_lists = []
    for (air_i, proof_i, pubs_i, log_n_i, cfg_i) in children:
        cell_lists.append([mb.loadw(v) for v in _pub_ints(pubs_i)])
    for (ci, pi) in expose:
        pc = mb.pin_public(mb.vals[cell_lists[ci][pi]])
        mb.eq_cells(pc, cell_lists[ci][pi])
    for (ci, pi, cj, pj) in links:
        mb.eq_cells(cell_lists[ci][pi], cell_lists[cj][pj])
    for (air_i, proof_i, pubs_i, log_n_i, cfg_i), cells in zip(children,
                                                               cell_lists):
        record_stark_verify(mb, air_i, proof_i, cells, log_n_i, cfg_i,
                            stream=stream)
    return mb


def prove_reduce(children, links, expose, outer_config,
                 stream: Optional[bool] = None, device=None, timer=None):
    """Reduce node: verify MULTIPLE child proofs in one outer AIR with
    cross-child public links — the MapReduce reduce semantics of VectorX
    (verify two children + boundary adjacency, emit combined publics).

    children: list of (air, proof, publics, log_n, config)
    links:    [(ci, pi, cj, pj)] equality constraints child_i.pub[pi] ==
              child_j.pub[pj] (the adjacency links)
    expose:   [(ci, pi)] — which child publics become outer publics, in
              order (the combined claim)
    """
    mb = record_reduce(children, links, expose, stream)
    return _prove_machine(mb, outer_config, device, timer)


def reduce_air_for(children_shapes, links, expose,
                   stream: Optional[bool] = None,
                   device=None) -> RecursionAir:
    """Verifier-side reduce AIR from claim shapes: children_shapes =
    [(air, log_n, config, num_publics)]."""
    device = default_device(device)
    mb = MachineBuilder()
    cell_lists = []
    for (air_i, log_n_i, cfg_i, np_i) in children_shapes:
        cell_lists.append([mb.loadw(0) for _ in range(np_i)])
    for (ci, pi) in expose:
        pc = mb.pin_public(0)
        mb.eq_cells(pc, cell_lists[ci][pi])
    for (ci, pi, cj, pj) in links:
        mb.eq_cells(cell_lists[ci][pi], cell_lists[cj][pj])
    for (air_i, log_n_i, cfg_i, np_i), cells in zip(children_shapes,
                                                    cell_lists):
        record_stark_verify(mb, air_i, _zero_proof(air_i, log_n_i, cfg_i),
                            cells, log_n_i, cfg_i, stream=stream,
                            device=device)
    return RecursionAir(mb)
