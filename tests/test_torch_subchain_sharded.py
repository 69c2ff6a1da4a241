"""The port's sharded header axis (parallel/subchain.verify_subchain with
a mesh) against the JAX package's sharded verify_subchain and the port's
single-device one.

The 16-header chain of tests/test_subchain.py (300-byte headers in
512-byte slots, trusted block 77) over 8 shards of 2 slots: a mesh of the
CPU (``Mesh(["cpu"] * 8)``) on the port's side, the 8-device CPU mesh of
tests/conftest.py with the header axis sharded (``shard_batch``) on the
JAX side. Every field of the result must be equal (exact): the honest
chain, a broken link at every slot (on a shard boundary and inside a
shard), and every ``num_active`` from 0 to past the slots (ending inside a
shard or on a boundary).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorx_tpu.parallel import mesh as jmesh
from vectorx_tpu.parallel import subchain as jsub
from vectorx_tpu_torch.circuits import commitments, scale
from vectorx_tpu_torch.parallel import mesh as pmesh
from vectorx_tpu_torch.parallel import subchain

torch.set_num_threads(1)

RNG = np.random.default_rng(7)
TRUSTED_BLOCK = 77
TREE = 16
SLOT = 512
MESH = pmesh.Mesh(["cpu"] * 8)


def make_chain(trusted_hash: bytes, n: int, size: int = 300):
    """SCALE-shaped headers forming a valid blake2b chain."""
    headers, metas, parent = [], [], trusted_hash
    for i in range(n):
        state_root, data_root = RNG.bytes(32), RNG.bytes(32)
        body = (parent + scale.encode_compact_u32(TRUSTED_BLOCK + 1 + i)
                + state_root)
        header = body + RNG.bytes(size - len(body) - 32) + data_root
        headers.append(header)
        metas.append((state_root, data_root))
        parent = hashlib.blake2b(header, digest_size=32).digest()
    return headers, metas, parent


TRUSTED = RNG.bytes(32)
HEADERS, METAS, TARGET = make_chain(TRUSTED, TREE)
BUF, SIZES = subchain.pack_headers(HEADERS, TREE, SLOT)

_jitted = []


def _jax_sharded(buf, num_active):
    """The JAX package's verify_subchain, header axis over 8 devices."""
    if not _jitted:
        m = jmesh.make_mesh(8)
        shard, repl = jmesh.shard_batch(m), jmesh.replicate(m)
        _jitted.append((jax.jit(jsub.verify_subchain, in_shardings=(
            shard, shard, repl, repl, repl)), shard))
    fn, shard = _jitted[0]
    return fn(jax.device_put(jnp.asarray(buf), shard),
              jax.device_put(jnp.asarray(SIZES), shard),
              jnp.int32(num_active),
              jnp.asarray(np.frombuffer(TRUSTED, np.uint8)),
              jnp.uint32(TRUSTED_BLOCK))


def _port(buf, num_active, mesh=None):
    return subchain.verify_subchain(
        torch.from_numpy(buf), torch.from_numpy(SIZES), num_active,
        torch.frombuffer(bytearray(TRUSTED), dtype=torch.uint8),
        TRUSTED_BLOCK, mesh=mesh)


def _assert_equal(port, single, ref):
    for name, p, s, r in zip(port._fields, port, single, ref):
        assert torch.equal(p, s), name
        assert np.array_equal(p.numpy(), np.asarray(r).astype(p.numpy().dtype)), name


def _words_to_bytes(w):
    return b"".join(int(x).to_bytes(4, "big") for x in w)


def _broken(slot: int):
    buf = BUF.copy()
    buf[slot, 0] ^= 1               # the first byte of its parent hash
    return buf


def test_honest_chain_equals_reference_and_one_device():
    got = _port(BUF, TREE, MESH)
    _assert_equal(got, _port(BUF, TREE), _jax_sharded(BUF, TREE))
    assert bool(got.links_ok) and bool(got.blocks_sequential)
    assert _words_to_bytes(got.target_hash_words) == TARGET
    want = commitments.range_commitments([m[0] for m in METAS],
                                         [m[1] for m in METAS], TREE)
    assert (_words_to_bytes(got.state_root_words),
            _words_to_bytes(got.data_root_words)) == want


@pytest.mark.parametrize("slot", range(TREE))
def test_broken_link_equals_reference(slot):
    """A break at every slot: on a shard boundary (even slots) or inside a
    shard (odd ones)."""
    buf = _broken(slot)
    got = _port(buf, TREE, MESH)
    _assert_equal(got, _port(buf, TREE), _jax_sharded(buf, TREE))
    assert not bool(got.links_ok)
    # the same break beyond the active headers does not count
    assert bool(_port(buf, slot, MESH).links_ok)


@pytest.mark.parametrize("num_active", range(TREE + 2))
def test_num_active_equals_reference(num_active):
    """Every count: an odd one ends inside a shard (11 inside shard 5), an
    even one on a boundary (12 after it); 0 and 17 read the target at a
    clamped slot."""
    buf = _broken(13)               # outside the range for 11 and 12
    _assert_equal(_port(buf, num_active, MESH), _port(buf, num_active),
                  _jax_sharded(buf, num_active))


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
def test_every_shard_count_equals_one_device(shards):
    buf = _broken(4)
    for num_active in (3, 4, 5, TREE):
        got = _port(buf, num_active, pmesh.Mesh(["cpu"] * shards))
        want = _port(buf, num_active)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shards", [3, 5, 6, 12, 32])
def test_shards_must_split_the_slots_into_powers_of_two(shards):
    with pytest.raises(ValueError, match="power-of-two"):
        _port(BUF, TREE, pmesh.Mesh(["cpu"] * shards))


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
def test_mesh_put_and_gather_round_trip(shards):
    mesh = pmesh.Mesh(["cpu"] * shards)
    x = torch.arange(32).reshape(16, 2)
    parts = pmesh.shard_batch(mesh).put(x)
    assert [s.shape for s in parts] == [(16 // shards, 2)] * shards
    assert torch.equal(mesh.gather(parts), x)
    assert torch.equal(pmesh.Sharding(mesh, 1).gather(
        pmesh.Sharding(mesh, 1).put(x.T)), x.T)
    copies = pmesh.replicate(mesh).put(x)
    assert len(copies) == shards and all(torch.equal(c, x) for c in copies)
    with pytest.raises(ValueError, match="does not split"):
        MESH.put(torch.arange(12))


def test_make_mesh_never_repeats_a_device():
    one = pmesh.make_mesh(device="cpu")
    assert one == pmesh.Mesh(["cpu"]) and one.shape == {"batch": 1}
    with pytest.raises(ValueError, match=r"Mesh\(\[dev\] \* 2\)"):
        pmesh.make_mesh(2, device="cpu")
