"""The port's sharded NTT (parallel/ntt_dist.py) against poly/ntt.py and
the JAX package's ntt_dist, and the prover's NTT seam.

An 8-shard mesh of the CPU (``Mesh(["cpu"] * 8)``) on the port's side, the
8-device CPU mesh of tests/conftest.py on the JAX side, the shapes of
tests/test_ntt_dist.py (and the transform at 2^6 and 2^12); inputs are
seeded numpy arrays. Against poly/ntt.py alone, every split: log n from 4
to 11 on 1 to 8 shards, the LDE at rates 1 to 3, the coset transforms.
Exact field arithmetic gives one answer, so every output must be
bit-equal (tolerance 0). A repeat call builds no table. A
FibonacciAir(2^6) proof with ``ntt_ops`` over 2, 4 and 8
shards at the dry run's config (rate 1, 2 queries) is byte-equal to the
unsharded proof and verifies.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.parallel import ntt_dist as jnd
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.parallel import ntt_dist as nd
from vectorx_tpu_torch.parallel.mesh import Mesh
from vectorx_tpu_torch.poly import ntt as pntt
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import FibonacciAir

torch.set_num_threads(1)

MESH = Mesh(["cpu"] * 8)
SHIFT = 7


def _jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("batch",))


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, gl.MODULUS, shape,
                                                dtype=np.uint64)


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _jax(x):
    return jgl.to_fp(x.astype(object))


def _u64(j):
    return (np.asarray(j[0], np.uint64)
            | (np.asarray(j[1], np.uint64) << np.uint64(32)))


def _check(got, want_port, want_jax):
    assert torch.equal(got, want_port)
    assert np.array_equal(gl.to_u64(got), _u64(want_jax))


@pytest.mark.parametrize("log_n", [6, 9, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_sharded_equals_butterfly_and_reference(inverse, log_n):
    x = _rand(1, 1 << log_n)
    _check(nd.ntt_sharded(_port(x), MESH, inverse=inverse),
           pntt.ntt(_port(x), inverse),
           jnd.ntt_sharded(_jax(x), _jmesh(), inverse=inverse))


@pytest.mark.parametrize("shape,rate", [((3, 64), 1), ((5, 128), 2)])
def test_coset_lde_sharded_equals_butterfly_and_reference(shape, rate):
    x = _rand(2, shape)
    _check(nd.coset_lde_sharded(_port(x), rate, MESH),
           pntt.coset_lde(_port(x), rate),
           jnd.coset_lde_sharded(_jax(x), rate, _jmesh()))


def test_coset_intt_sharded_equals_butterfly_and_reference():
    x = _rand(3, (5, 128))
    _check(nd.coset_intt_sharded(_port(x), SHIFT, MESH),
           pntt.coset_intt(_port(x), SHIFT),
           jnd.coset_intt_sharded(_jax(x), SHIFT, _jmesh()))


@pytest.mark.parametrize("shape", [(1 << 6,), (3, 1 << 7)])
def test_coeffs_to_coset_evals_sharded_equals_butterfly_and_reference(shape):
    x = _rand(4, shape)
    _check(nd.coeffs_to_coset_evals_sharded(_port(x), 1, MESH),
           pntt.coeffs_to_coset_evals(_port(x), 1),
           jnd.coeffs_to_coset_evals_sharded(_jax(x), 1, _jmesh()))


def _splits():
    """(log n, shards) for every log n from 4 to 11 and 1, 2, 4 or 8
    shards that divide the n2 columns."""
    return [(log_n, shards) for log_n in range(4, 12)
            for shards in (1, 2, 4, 8) if nd._split(1 << log_n)[1] % shards == 0]


@pytest.mark.parametrize("log_n,shards", _splits())
def test_every_split_equals_butterfly(log_n, shards):
    """Both parities of log n, one to eight shards, forward and inverse."""
    x = _port(_rand(log_n, (2, 1 << log_n)))
    mesh = Mesh(["cpu"] * shards)
    assert torch.equal(nd.ntt_sharded(x, mesh), pntt.ntt(x))
    assert torch.equal(nd.ntt_sharded(x, mesh, inverse=True), pntt.intt(x))


@pytest.mark.parametrize("rate", [1, 2, 3])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_every_lde_split_equals_butterfly(rate, shards):
    x = _port(_rand(8 + rate, (3, 64)))
    assert torch.equal(nd.coset_lde_sharded(x, rate, Mesh(["cpu"] * shards)),
                       pntt.coset_lde(x, rate))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_every_coset_split_equals_butterfly(shards):
    """coset_intt_sharded and coeffs_to_coset_evals_sharded (rate 0 and 1)
    on one to eight shards."""
    mesh = Mesh(["cpu"] * shards)
    x = _port(_rand(20 + shards, (3, 128)))
    assert torch.equal(nd.coset_intt_sharded(x, SHIFT, mesh),
                       pntt.coset_intt(x, SHIFT))
    for rate in (0, 1):
        assert torch.equal(nd.coeffs_to_coset_evals_sharded(x, rate, mesh),
                           pntt.coeffs_to_coset_evals(x, rate))


def test_a_transform_too_short_for_the_mesh_is_refused():
    with pytest.raises(ValueError, match="does not split over 8 shards"):
        nd.ntt_sharded(_port(_rand(5, 16)), MESH)


@pytest.mark.parametrize("inverse", [False, True])
def test_repeat_call_builds_no_table(monkeypatch, inverse):
    x = _port(_rand(6, (2, 1 << 8)))
    first = nd.ntt_sharded(x, MESH, inverse=inverse)
    entries = nd._tables.cache_info().currsize

    def no_build(*args):
        raise AssertionError("a table was built again")

    monkeypatch.setattr(nd, "_twiddle_table", no_build)
    for _ in range(3):
        assert torch.equal(nd.ntt_sharded(x, MESH, inverse=inverse), first)
    assert nd._tables.cache_info().currsize == entries


@pytest.mark.parametrize("tile", [1, 2, 3, 4])
def test_wide_lde_goes_in_column_blocks(monkeypatch, tile):
    """A batch wider than the working set runs a block of columns at a
    time (here 1 to 4 of 5) and gives the whole batch's values."""
    x = _port(_rand(7, (5, 64)))
    monkeypatch.setattr(pntt, "col_tile", lambda w, n, temps, device: tile)
    assert torch.equal(nd.coset_lde_sharded(x, 2, MESH),
                       pntt.coset_lde(x, 2))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_ntt_prove_equals_unsharded_and_verifies(shards):
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
    air = FibonacciAir()
    trace, publics = FibonacciAir.make_trace(1 << 6, device="cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    ops = nd.ShardedNttOps(Mesh(["cpu"] * shards))
    proof = prover.prove(air, trace, pubs, cfg, ntt_ops=ops)
    assert serialize.serialize_proof(proof) == serialize.serialize_proof(
        prover.prove(air, trace, pubs, cfg))
    assert verifier.verify(air, proof, pubs, 6, cfg)
