"""Port vs reference: Poseidon tables, the plain permutation, the sponge.

The port's plain torch rounds and its CPU route (``permute`` on a CPU
tensor: numpy rounds) are held against vectorx_tpu's JAX permutation, its
Pallas kernel in interpret mode and the exact-int oracle.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.hashes import poseidon as jps
from vectorx_tpu.ops import poseidon_pallas as pp
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.ops import poseidon_cuda

from oracle import P

torch.set_num_threads(1)


def _u64(lo, hi):
    return (np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << np.uint64(32)))


def _states(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, P, (n, 12), dtype=np.uint64)
    s[0] = P - 1
    if n > 1:
        s[1] = 0
    return s


def _jax(x: np.ndarray):
    return jgl.to_fp(x.astype(object))


def _port(x: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def test_round_constants_match_reference():
    rc, m = ps._np_constants()
    rc_lo, rc_hi, m_lo, m_hi = jps._np_constants()
    assert np.array_equal(rc, _u64(rc_lo, rc_hi))
    assert np.array_equal(m, _u64(m_lo, m_hi))
    assert ps.round_constants() == jps.round_constants()
    assert ps.MDS_ROW == jps.MDS_ROW


def test_fast_partial_tables_match_reference():
    assert ps.fast_partial_ints() == jps.fast_partial_ints()
    for mine, (lo, hi) in zip(ps._np_fast_partial(), jps._np_fast_partial()):
        assert np.array_equal(mine, _u64(lo, hi))


def test_mds_shift_table_matches_reference():
    k, _ = jps._mds_shift_tables()
    assert np.array_equal(ps._mds_shift_tables(), k)


@pytest.mark.parametrize("n", [1, 5])
def test_plain_permute_matches_jax_and_oracle(n):
    s = _states(n, n)
    got = gl.to_u64(ps.permute(_port(s)))
    want = np.asarray([jps.permute_ints([int(v) for v in row]) for row in s],
                      dtype=np.uint64)
    assert np.array_equal(got, want)
    assert np.array_equal(gl.to_u64(ps.permute_plain(_port(s))), want)
    j = jps.permute(_jax(s))
    assert np.array_equal(got, _u64(*j))


def test_plain_permute_leading_shape():
    s = _states(3, 6)
    got = ps.permute(_port(s).reshape(2, 3, 12))
    assert got.shape == (2, 3, 12)
    assert np.array_equal(gl.to_u64(got).reshape(6, 12),
                          gl.to_u64(ps.permute(_port(s))))


def test_plain_permute_matches_pallas_interpret_ragged_batch():
    """A batch over one Pallas tile (4096) with a ragged tail."""
    n = pp.TILE + 3
    base = _states(4, 4)
    s = np.tile(base, (n // 4 + 1, 1))[:n]
    got = gl.to_u64(ps.permute(_port(s)))
    j = pp.permute(_jax(s), interpret=True)
    assert np.array_equal(got, _u64(*j))
    assert np.array_equal(gl.to_u64(ps.permute_plain(_port(s))), got)
    for i in (0, 1, pp.TILE - 1, pp.TILE, n - 1):
        assert [int(v) for v in got[i]] == jps.permute_ints([int(v) for v in s[i]])


@pytest.mark.parametrize("width", [1, 8, 9, 799])
def test_hash_many_matches_reference(width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, P, (3, width), dtype=np.uint64)
    got = gl.to_u64(ps.hash_many(_port(rows)))
    j = jps.hash_many(_jax(rows))
    assert np.array_equal(got, _u64(*j))
    assert [int(v) for v in got[0]] == jps.hash_ints([int(v) for v in rows[0]])


def test_hash_two_to_one_matches_reference():
    rng = np.random.default_rng(12)
    left = rng.integers(0, P, (4, 4), dtype=np.uint64)
    right = rng.integers(0, P, (4, 4), dtype=np.uint64)
    got = gl.to_u64(ps.hash_two_to_one(_port(left), _port(right)))
    j = jps.hash_two_to_one(_jax(left), _jax(right))
    assert np.array_equal(got, _u64(*j))


def test_kernel_wrapper_rejects_what_it_cannot_launch():
    x = torch.zeros((2, 12), dtype=torch.int64)
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x)                     # not a CUDA tensor
    # the dispatcher never falls back for an unknown device type
    with pytest.raises(NotImplementedError):
        ps.permute(torch.zeros((2, 12), dtype=torch.int64, device="meta"))
