"""Port vs reference: the plain versions of the duplex chain and the sponge,
and the CPU route (numpy rounds, Python ints for a transcript's state).

``duplex_plain`` (what the ``duplex`` kernel is held against on the card) is
driven through the same observe/squeeze sequence as vectorx_tpu's
Challenger, and ``hash_many_plain`` (the plain version of ``sponge_rows``)
is held against vectorx_tpu's ``hash_many`` on a row-major matrix and on a
transposed view of a column-major one. Inputs come from numpy seeds; the
tolerance is 0 (exact equality). The JAX side runs its plain permutation on
the CPU; the CUDA kernels run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.hashes import poseidon as jps
from vectorx_tpu.stark.challenger import Challenger as JChallenger
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.stark.challenger import Challenger

from oracle import P

torch.set_num_threads(1)


def _u64(pair):
    lo, hi = pair
    return np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << np.uint64(32))


def _jax(x: np.ndarray):
    return jgl.to_fp(x.astype(object))


def _port(x: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


@pytest.mark.parametrize("n_squeeze", [1, 9])
@pytest.mark.parametrize("tail", [0, 1, 7])
@pytest.mark.parametrize("chunks", [0, 1, 3])
def test_plain_duplex_matches_reference_challenger(chunks, tail, n_squeeze):
    rng = np.random.default_rng(1000 * chunks + 10 * tail + n_squeeze)
    state0 = rng.integers(0, P, 12, dtype=np.uint64)
    data = rng.integers(0, P, chunks * 8 + tail, dtype=np.uint64)

    ref = JChallenger(state=_jax(state0), pending=[])
    if data.size:
        ref.observe(_jax(data))
    # observe: the full chunks absorb, the tail stays pending
    state, none = ps.duplex_plain(_port(state0), _port(data))
    assert none.shape == (0,)
    assert np.array_equal(gl.to_u64(state), _u64(ref.state))
    assert len(ref.pending) == tail

    # squeeze: the pending tail is flushed first
    want = ref.squeeze(n_squeeze)
    state, got = ps.duplex_plain(state, _port(data[chunks * 8:]), flush=True,
                                 n_squeeze=n_squeeze)
    assert np.array_equal(gl.to_u64(got), _u64(want))
    assert np.array_equal(gl.to_u64(state), _u64(ref.state))

    # the whole chain in one call, and through the port's Challenger
    state1, got1 = ps.duplex_plain(_port(state0), _port(data), flush=True,
                                   n_squeeze=n_squeeze)
    assert torch.equal(state1, state) and torch.equal(got1, got)
    ch = Challenger(state=_port(state0), pending=_port(data[:0]))
    ch.observe(_port(data))
    assert ch.pending.shape == (tail,)
    assert torch.equal(ch.squeeze(n_squeeze), got)
    assert torch.equal(ch.state, state) and ch.pending.shape == (0,)


@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("m,n_squeeze", [(0, 0), (0, 3), (7, 1), (8, 0),
                                         (23, 9), (64, 17)])
def test_ints_duplex_equals_plain(m, n_squeeze, flush):
    """The CPU route of a single-state chain (Python ints) against the torch
    rounds; ``duplex`` takes it for a (12,) state on the CPU."""
    rng = np.random.default_rng(7 * m + n_squeeze)
    state0 = _port(rng.integers(0, P, 12, dtype=np.uint64))
    data = _port(rng.integers(0, P, m, dtype=np.uint64))
    want = ps.duplex_plain(state0, data, flush, n_squeeze)
    for got in (ps.duplex_ints(state0, data, flush, n_squeeze),
                ps.duplex(state0, data, flush, n_squeeze)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_duplex_refuses_a_batch_of_states():
    """A transcript is one state: ``duplex`` on the CPU takes a (12,) state
    and flat data, as the kernel does, and raises for anything else."""
    rng = np.random.default_rng(5)
    states = _port(rng.integers(0, P, (3, 12), dtype=np.uint64))
    data = _port(rng.integers(0, P, 16, dtype=np.uint64))
    with pytest.raises(ValueError, match="duplex takes"):
        ps.duplex(states, data.expand(3, 16))
    with pytest.raises(ValueError, match="duplex takes"):
        ps.duplex(states[0], data.reshape(2, 8))


def _boundary_states(rng, n):
    """Random states with rows at the carry boundaries: p-1-k, k(2^32-1),
    zero and [p-2^32, p)."""
    s = rng.integers(0, P, (n, 12), dtype=np.uint64)
    s[0::5] = np.uint64(P - 1) - rng.integers(0, 8, (len(s[0::5]), 12),
                                              dtype=np.uint64)
    s[1::5] = (rng.integers(0, 5, (len(s[1::5]), 12)).astype(np.uint64)
               * np.uint64(0xFFFFFFFF)) % np.uint64(P)
    s[2::5] = 0
    s[3::5] = np.uint64(P) - rng.integers(1, 1 << 32, (len(s[3::5]), 12),
                                          dtype=np.uint64)
    return s


@pytest.mark.parametrize("n", [1, 2, 17, 600])
def test_host_permute_equals_plain_and_oracle(n):
    """The CPU route of ``permute`` (numpy rounds) against the torch rounds
    and the exact-int oracle."""
    s = _boundary_states(np.random.default_rng(n), n)
    got = ps.permute_np(s)
    assert np.array_equal(got, gl.to_u64(ps.permute_plain(_port(s))))
    assert np.array_equal(gl.to_u64(ps.permute(_port(s))), got)
    for i in sorted({0, 1, 2, 3, n - 1} & set(range(n))):
        assert [int(v) for v in got[i]] == ps.permute_ints(
            [int(v) for v in s[i]])


@pytest.mark.parametrize("seed", range(4))
def test_list_permute_equals_oracle(seed):
    """The transcript's permutation on Python ints (sparse partial rounds)
    against the dense oracle."""
    for row in _boundary_states(np.random.default_rng(100 + seed), 25):
        state = [int(v) for v in row]
        assert ps._permute_list(state) == ps.permute_ints(state)


@pytest.mark.parametrize("shape", [(2, 3, 17), (4, 0), (1, 8)])
def test_host_hash_many_equals_plain(shape):
    rng = np.random.default_rng(sum(shape))
    x = _port(rng.integers(0, P, shape, dtype=np.uint64))
    got = ps.hash_many(x)
    assert got.shape == shape[:-1] + (4,)
    assert torch.equal(got, ps.hash_many_plain(x))


@pytest.mark.parametrize("layout", ["row_major", "column_major_view"])
@pytest.mark.parametrize("width", [4, 9, 135])
def test_plain_hash_many_matches_reference(width, layout):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, P, (5, width), dtype=np.uint64)
    if layout == "row_major":
        x = _port(rows)
        assert x.is_contiguous()
    else:
        x = _port(rows.T).t()                 # (w, n) storage, (n, w) view
        assert x.stride() == (1, 5)
    got = ps.hash_many_plain(x)
    assert np.array_equal(gl.to_u64(got), _u64(jps.hash_many(_jax(rows))))
    assert torch.equal(ps.hash_many(x), got)   # the CPU dispatch
    assert [int(v) for v in gl.to_u64(got)[0]] == jps.hash_ints(
        [int(v) for v in rows[0]])
