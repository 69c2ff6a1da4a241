"""Port vs reference: the grouped GF(2^255-19) gadget banks (gadget_vec).

The VecGadgetAir of tests/test_gadget_vec.py (B = 8, 32 limbs: a MulBank of
three variable products, one with an offset limb expression, a MulBank with
a constant operand, a LinZeroBank of two negations and a CanonBank of two
canonicity checks, each bank with its carry chain) is built once for each
package from the same seeded field elements. Held with tolerance 0:

- both fill paths, ``fill`` on Python ints and ``fill_vec`` on numpy int64
  rows, give the same column matrix in both packages, and the two paths
  give the same matrix;
- the grouped constraints, evaluated under BaseVecAlgebra on 8 seeded
  random values per column and under ExtAlgebra at one seeded random
  point, equal the JAX package's, constraint by constraint;
- check_constraints holds on the honest trace and fails on a tampered limb.

The JAX package's constraint values are recorded (tests/reference_data/
test_torch_gadget_vec.json, made by tests/reference_data/record.py), and
so are the Ed25519 files'. The ``*_eval`` and ``assert_equal_*`` helpers
are shared with those files.
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.stark import air as jair
from vectorx_tpu.stark import gadget_vec as jgv
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import air as pair
from vectorx_tpu_torch.stark import gadget_vec as gv
from vectorx_tpu_torch.stark.air import check_constraints

import reference_data as rd
from reference_data import inputs
from reference_data.inputs import random_columns

torch.set_num_threads(1)

B = inputs.GV_B
L = inputs.GV_L
N = inputs.GV_N
K0 = inputs.GV_K0
P25519 = gv.P25519


# -- evaluating a transition in the port --------------------------------------------

def base_eval(air, cols, publics=()):
    """The transition of `air` under BaseVecAlgebra over the columns' width:
    cols = (local, next, consts, consts_next) uint64 matrices, publics a
    uint64 vector (record.py's base_eval gives the JAX package's)."""
    n = cols[0].shape[1]
    rows = [list(gl.to_fp(m, "cpu")) for m in cols]
    pubs = list(gl.to_fp(np.asarray(publics, dtype=np.uint64), "cpu"))
    alg = pair.BaseVecAlgebra((n,), "cpu")
    local, nxt, consts, consts_next = rows
    return air.transition(alg, local, nxt, pubs, consts, consts_next)


def ext_eval(air, cols):
    """The transition under ExtAlgebra at one point: cols = (local, next,
    consts, consts_next), each a (k, 2) uint64 matrix of (re, im)."""
    rows = []
    for m in cols:
        re, im = gl.to_fp(m[:, 0], "cpu"), gl.to_fp(m[:, 1], "cpu")
        rows.append([(re[i], im[i]) for i in range(m.shape[0])])
    alg = pair.ExtAlgebra("cpu")
    local, nxt, consts, consts_next = rows
    return air.transition(alg, local, nxt, [], consts, consts_next)


def assert_equal_base(port_c, want):
    """A port constraint's values against a recorded JAX one's."""
    assert rd.array(gl.to_u64(port_c)) == want


def assert_equal_ext(port_c, want):
    for k in range(2):
        assert rd.array(gl.to_u64(port_c[k])) == want[k]


# -- the gadget AIR, once for each package ----------------------------------------

def _limbs(v):
    return [(v >> (B * i)) & 0xFF for i in range(L)]


def fill_rows(mod, air, a_vals, b_vals):
    """The row-by-row witness (``fill``, Python ints): int64 columns."""
    cols = np.zeros((air.num_cols, N), dtype=np.int64)
    for r in range(N):
        a, b = int(a_vals[r]), int(b_vals[r])
        al, bl = _limbs(a), _limbs(b)
        for i in range(L):
            cols[air.a[i], r] = al[i]
            cols[air.b[i], r] = bl[i]
            cols[air.na[i], r] = ((P25519 - a) >> (B * i)) & 0xFF
            cols[air.nb[i], r] = ((P25519 - b) >> (B * i)) & 0xFF
        c0 = air.vm.fill(cols, r, 0, al, bl)
        c1 = air.vm.fill(cols, r, 1, _limbs(c0), al)
        e_l = mod.lin_limbs_int([(1, _limbs(c0)), (-1, _limbs(c1))],
                                4 * P25519, L, B)
        air.vm.fill(cols, r, 2, e_l, bl)
        air.cm.fill(cols, r, 0, _limbs(c0), b_const=K0)
        air.lz.fill(cols, r, 0, mod.lin_limbs_int(
            [(1, al), (1, _limbs(P25519 - a))], 0, L, B))
        air.lz.fill(cols, r, 1, mod.lin_limbs_int(
            [(1, bl), (1, _limbs(P25519 - b))], 0, L, B))
        air.cb.fill(cols, r, 0, a)
        air.cb.fill(cols, r, 1, b)
    return cols


def fill_all_rows(mod, air, a_vals, b_vals):
    """The row-batched witness (``fill_vec``, numpy int64): int64 columns."""
    cols = np.zeros((air.num_cols, N), dtype=np.int64)
    rows = np.arange(N)

    def mat(vals):
        return mod.ints_to_limb_mat(vals, L, B)

    na_vals = [P25519 - a for a in a_vals]
    nb_vals = [P25519 - b for b in b_vals]
    am, bm, nam, nbm = mat(a_vals), mat(b_vals), mat(na_vals), mat(nb_vals)
    for bank, m in ((air.a, am), (air.b, bm), (air.na, nam), (air.nb, nbm)):
        cols[bank] = m.T
    c0 = air.vm.fill_vec(cols, rows, 0, am, a_vals, bm, b_vals)
    c1 = air.vm.fill_vec(cols, rows, 1, mat(c0), c0, am, a_vals)
    e_m = mat(c0) - mat(c1) + np.asarray(mod.limbs_top(4 * P25519, L, B),
                                         dtype=np.int64)
    e_v = [x + 4 * P25519 - y for x, y in zip(c0, c1)]
    air.vm.fill_vec(cols, rows, 2, e_m, e_v, bm, b_vals)
    air.cm.fill_vec(cols, rows, 0, mat(c0), c0, b_const=K0)
    air.lz.fill_vec(cols, rows, 0, am + nam,
                    [x + y for x, y in zip(a_vals, na_vals)])
    air.lz.fill_vec(cols, rows, 1, bm + nbm,
                    [x + y for x, y in zip(b_vals, nb_vals)])
    air.cb.fill_vec(cols, rows, 0, a_vals)
    air.cb.fill_vec(cols, rows, 1, b_vals)
    return cols


A_VALS, B_VALS = inputs.GV_A_VALS, inputs.GV_B_VALS
AIRS = {"port": inputs.vec_gadget_air(gv, pair.Air),
        "jax": inputs.vec_gadget_air(jgv, jair.Air)}
N_CONSTRAINTS = 5      # MulBank, constant MulBank, LinZero (bits, chain), Canon
_cache = {}


def _cached(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


def _trace(pkg, path):
    mod = gv if pkg == "port" else jgv
    fill = fill_rows if path == "fill" else fill_all_rows
    return _cached(("trace", pkg, path),
                   lambda: fill(mod, AIRS[pkg], A_VALS, B_VALS))


# -- layout and fill paths ------------------------------------------------------

def test_layout_equal_reference():
    port, ref = AIRS["port"], AIRS["jax"]
    assert port.num_cols == ref.num_cols
    assert port.lookup_range_columns() == ref.lookup_range_columns()
    for bank in ("vm", "cm", "lz", "cb"):
        p, j = getattr(port, bank), getattr(ref, bank)
        assert np.array_equal(p.chain.ul, j.chain.ul)
        assert vars(p.chain.spec) == vars(j.chain.spec)
    for bank in ("vm", "cm"):
        p, j = getattr(port, bank), getattr(ref, bank)
        assert (p.LQ, p.n_coeffs) == (j.LQ, j.n_coeffs)
        assert np.array_equal(p.c, j.c) and np.array_equal(p.q, j.q)
    assert np.array_equal(port.lz.bits, ref.lz.bits)
    assert np.array_equal(port.cb.diff, ref.cb.diff)


@pytest.mark.parametrize("v", [0, 1, P25519 - 1, 4 * P25519, 6 * P25519 + 5])
def test_limb_helpers_equal_reference(v):
    assert gv.limbs_top(v, L, B) == jgv.limbs_top(v, L, B)
    assert gv.limbs_to_int(gv.limbs_top(v, L, B), B) == v
    assert gv.p_limbs(13, 20) == jgv.p_limbs(13, 20)
    if v < 1 << 256:
        assert np.array_equal(gv.ints_to_limb_mat([v, 3], L, B),
                              jgv.ints_to_limb_mat([v, 3], L, B))


@pytest.mark.parametrize("path", ["fill", "fill_vec"])
def test_fill_equal_reference(path):
    assert np.array_equal(_trace("port", path), _trace("jax", path))


def test_fill_paths_agree():
    assert np.array_equal(_trace("port", "fill"), _trace("port", "fill_vec"))


def test_check_constraints_on_trace():
    air = AIRS["port"]
    trace = gl.to_fp(_trace("port", "fill_vec").view(np.uint64), "cpu")
    assert check_constraints(air, trace, [gl.to_fp(0, "cpu")])
    bad = trace.clone()
    bad[air.vm.c[1, 3], 17] ^= 1          # one limb of c1 = c0·a
    assert not check_constraints(air, bad, [gl.to_fp(0, "cpu")])


# -- the constraints under both algebras ---------------------------------------

@pytest.fixture(scope="module")
def jax_evals():
    """The JAX package's constraint values on the same rows, as recorded."""
    return rd.load("test_torch_gadget_vec", inputs.test_torch_gadget_vec())


def _base():
    def run():
        air = AIRS["port"]
        rng = np.random.default_rng(5)
        cols = (random_columns(rng, air.num_cols, 8),
                random_columns(rng, air.num_cols, 8),
                random_columns(rng, 0, 8), random_columns(rng, 0, 8))
        return base_eval(air, cols)
    return _cached(("base", "port"), run)


def _ext():
    def run():
        air = AIRS["port"]
        rng = np.random.default_rng(6)
        cols = (random_columns(rng, air.num_cols, 2),
                random_columns(rng, air.num_cols, 2),
                random_columns(rng, 0, 2), random_columns(rng, 0, 2))
        return ext_eval(air, cols)
    return _cached(("ext", "port"), run)


@pytest.mark.parametrize("i", range(N_CONSTRAINTS))
def test_base_constraints_equal_reference(i, jax_evals):
    assert len(_base()) == len(jax_evals["base"]) == N_CONSTRAINTS
    assert_equal_base(_base()[i], jax_evals["base"][i])


@pytest.mark.parametrize("i", range(N_CONSTRAINTS))
def test_ext_constraints_equal_reference(i, jax_evals):
    assert len(_ext()) == len(jax_evals["ext"]) == N_CONSTRAINTS
    assert_equal_ext(_ext()[i], jax_evals["ext"][i])
