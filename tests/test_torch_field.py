"""Port vs reference: Goldilocks and GF(p^2) arithmetic (exact equality).

Numpy-seeded inputs go through vectorx_tpu.field (JAX, on the CPU), the
port's vectorx_tpu_torch.field (torch, CPU) and tests/oracle.py.
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.field import ext as jext
from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu_torch import convert
from vectorx_tpu_torch.field import ext
from vectorx_tpu_torch.field import goldilocks as gl

from oracle import P, fp2_inv, fp2_mul, gl_add, gl_inv, gl_mul, gl_sub

torch.set_num_threads(1)

# 0, 1, 2^32±1, 2^63±1, p−1 and values that are negative as int64
EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 63) - 1,
        1 << 63, (1 << 63) + 1, P - 1, P - 2, P - (1 << 32),
        0xFFFFFFFF00000000 - 1, P // 2, P // 2 + 1, 0xFFFFFFFE00000001]


def _values(seed, n=256):
    rng = np.random.default_rng(seed)
    rand = [int(x) % P for x in rng.integers(0, 1 << 64, n, dtype=np.uint64)]
    return EDGE + rand


def _pairs(seed):
    a = _values(seed)
    # every edge value against every edge value, then random pairs
    b = list(reversed(a))
    ea = [x for x in EDGE for _ in EDGE]
    eb = [y for _ in EDGE for y in EDGE]
    return a + ea, b + eb


def _ints(x: torch.Tensor):
    return [int(v) for v in gl.from_fp(x).reshape(-1)]


def _jax_ints(x):
    return [int(v) for v in np.asarray(jgl.from_fp(x)).reshape(-1)]


def test_negative_int64_representation():
    x = gl.to_fp([P - 1, 1 << 63], "cpu")
    assert x.dtype == torch.int64
    assert x.tolist() == [-(1 << 32), -(1 << 63)]
    assert _ints(x) == [P - 1, 1 << 63]


@pytest.mark.parametrize("op,oracle", [
    ("add", gl_add), ("sub", gl_sub), ("mul", gl_mul)])
def test_binary_ops_match_reference(op, oracle):
    a, b = _pairs(1)
    got = _ints(getattr(gl, op)(gl.to_fp(a, "cpu"), gl.to_fp(b, "cpu")))
    want = [oracle(x, y) for x, y in zip(a, b)]
    assert got == want
    jgot = _jax_ints(getattr(jgl, op)(jgl.to_fp(a), jgl.to_fp(b)))
    assert got == jgot


def test_neg_square_double():
    a = _values(2)
    x = gl.to_fp(a, "cpu")
    assert _ints(gl.neg(x)) == [(-v) % P for v in a]
    assert _ints(gl.square(x)) == [v * v % P for v in a]
    assert _ints(gl.double(x)) == [2 * v % P for v in a]


@pytest.mark.parametrize("k", [0, 1, 7, 0xFFFFFFFF, 1 << 32, P - 1])
def test_mul_scalar(k):
    a = _values(3)
    got = _ints(gl.mul_scalar(gl.to_fp(a, "cpu"), k))
    assert got == [v * k % P for v in a]
    assert got == _jax_ints(jgl.mul_scalar(jgl.to_fp(a), k))


def test_inv_and_batch_inv():
    a = _values(4, 64)
    want = [gl_inv(v) for v in a]
    assert _ints(gl.inv(gl.to_fp(a, "cpu"))) == want
    assert _ints(gl.batch_inv(gl.to_fp(a, "cpu"))) == want
    assert _jax_ints(jgl.inv(jgl.to_fp(a))) == want


@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (7,), (1000,), (3, 4, 5)])
def test_inv_product_tree_edges(shape):
    """The product-tree inverse at odd and even lengths and with leading
    axes, zeros (inv(0) = 0), 1 and p - 1 among the values."""
    n = int(np.prod(shape))
    a = _values(11 + n, n)[:n]          # the edge values first
    for i, v in zip(range(0, n, 3), (0, 1, P - 1, 0)):
        a[i] = v
    got = gl.inv(gl.to_fp(np.array(a, dtype=np.uint64).reshape(shape), "cpu"))
    assert got.shape == shape
    assert _ints(got.reshape(-1)) == [gl_inv(v) for v in a]


@pytest.mark.parametrize("e", [0, 1, 7, 15, 16, 12345, P - 2])
def test_pow_const(e):
    a = _values(5, 32)
    got = _ints(gl.pow_const(gl.to_fp(a, "cpu"), e))
    assert got == [pow(v, e, P) for v in a]
    assert got == _jax_ints(jgl.pow_const(jgl.to_fp(a), e))


@pytest.mark.parametrize("shape,axis", [((7, 300), 0), ((7, 300), -1),
                                        ((40000,), 0)])
def test_sum_mod_exact(shape, axis):
    rng = np.random.default_rng(6)
    n = int(np.prod(shape))
    vals = np.array([int(x) % P for x in
                     rng.integers(0, 1 << 64, n, dtype=np.uint64)],
                    dtype=object)
    vals[: len(EDGE)] = EDGE
    vals = vals.reshape(shape)
    got = gl.sum_mod(gl.to_fp(vals, "cpu"), axis=axis)
    want = np.sum(vals, axis=axis) % P
    assert _ints(got) == [int(v) for v in np.asarray(want).reshape(-1)]
    jgot = jgl.sum_mod(jgl.to_fp(vals), axis=axis) if n <= (1 << 15) else None
    if jgot is not None:
        assert _ints(got) == _jax_ints(jgot)


def test_sum_mod_all_max():
    x = gl.full((40000,), P - 1, "cpu")
    assert _ints(gl.sum_mod(x, 0)) == [(P - 1) * 40000 % P]


def test_roots_of_unity_match_reference():
    for log_n in (0, 1, 5, 14, 32):
        assert gl.primitive_root_of_unity(log_n) == jgl.primitive_root_of_unity(log_n)


def _fp2_vals(seed, n=64):
    a = _values(seed, n)
    b = _values(seed + 100, n)
    return list(zip(a, b))


def test_fp2_mul_matches_reference():
    x = _fp2_vals(7)
    y = list(reversed(_fp2_vals(8)))
    got = ext.mul(ext.to_fp2(x, "cpu"), ext.to_fp2(y, "cpu"))
    want = [fp2_mul(u, v) for u, v in zip(x, y)]
    assert list(zip(_ints(got[0]), _ints(got[1]))) == want
    j = jext.mul(jext.to_fp2(x), jext.to_fp2(y))
    assert _ints(got[0]) == _jax_ints(j[0]) and _ints(got[1]) == _jax_ints(j[1])


def test_fp2_inv_matches_reference():
    x = _fp2_vals(9, 48)
    got = ext.inv(ext.to_fp2(x, "cpu"))
    want = [fp2_inv(u) for u in x]
    assert list(zip(_ints(got[0]), _ints(got[1]))) == want
    j = jext.inv(jext.to_fp2(x))
    assert _ints(got[0]) == _jax_ints(j[0]) and _ints(got[1]) == _jax_ints(j[1])


@pytest.mark.parametrize("e", [0, 3, 16, 1 << 11])
def test_fp2_pow_const(e):
    x = _fp2_vals(10, 16)
    got = ext.pow_const(ext.to_fp2(x, "cpu"), e)
    j = jext.pow_const(jext.to_fp2(x), e)
    assert _ints(got[0]) == _jax_ints(j[0]) and _ints(got[1]) == _jax_ints(j[1])


def test_convert_pairs_round_trip():
    a = _values(11)
    lo, hi = convert.fp_to_pairs(gl.to_fp(a, "cpu"))
    jlo, jhi = jgl.to_fp(a)
    assert np.array_equal(lo, np.asarray(jlo)) and np.array_equal(hi, np.asarray(jhi))
    assert _ints(convert.fp_from_pairs(jlo, jhi, "cpu")) == a
