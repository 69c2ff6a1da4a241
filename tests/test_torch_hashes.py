"""Port vs reference: batched SHA-256 / SHA-512 and the public commitments.

The same byte strings, made from numpy seeds, go through hashlib, the JAX
package (vectorx_tpu.hashes, vectorx_tpu.circuits.commitments, on the CPU)
and the port (torch, CPU): digests and commitment words must be equal
(tolerance 0). The boundary lengths cross the padding rules of both hashes
(55/56 and 64 for SHA-256, 111/112 and 128 for SHA-512).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorx_tpu.circuits import commitments as jcm
from vectorx_tpu.hashes import sha256 as js2
from vectorx_tpu.hashes import sha512 as js5
from vectorx_tpu_torch.circuits import commitments as cm
from vectorx_tpu_torch.circuits import consts
from vectorx_tpu_torch.circuits import ed25519 as ed
from vectorx_tpu_torch.hashes import sha256 as s2
from vectorx_tpu_torch.hashes import sha512 as s5
from vectorx_tpu_torch.stark import air_ed25519

torch.set_num_threads(1)

LENGTHS = (0, 55, 56, 64, 111, 112, 128)


def _msgs(length, count=3, seed=1):
    rng = np.random.default_rng(seed + length)
    return [rng.bytes(length) for _ in range(count)]


def _words(raw):
    """32-byte strings -> (n, 8) BE words as a numpy int64 array."""
    return np.frombuffer(b"".join(raw), dtype=">u4").astype(np.int64).reshape(-1, 8)


@pytest.mark.parametrize("length", LENGTHS)
def test_sha256_bytes_against_hashlib_and_reference(length):
    msgs = _msgs(length)
    got = s2.sha256_bytes(msgs, "cpu")
    assert [bytes(row) for row in got] == [hashlib.sha256(m).digest()
                                           for m in msgs]
    assert np.array_equal(got, js2.sha256_bytes(msgs))


@pytest.mark.parametrize("length", LENGTHS)
def test_sha512_bytes_against_hashlib(length):
    msgs = _msgs(length)
    assert s5.sha512_bytes(msgs, "cpu") == [hashlib.sha512(m).digest()
                                            for m in msgs]


def test_sha512_mixed_lengths_against_reference():
    """One padded batch of every boundary length (the variable-block path)."""
    msgs = [m for n in LENGTHS for m in _msgs(n, count=1)]
    got = s5.sha512_bytes(msgs, "cpu")
    assert got == js5.sha512_bytes(msgs)
    assert got == [hashlib.sha512(m).digest() for m in msgs]


def test_sha512_compress_words_against_reference():
    rng = np.random.default_rng(9)
    state = rng.integers(0, 1 << 64, (4, 8), dtype=np.uint64)
    block = rng.integers(0, 1 << 64, (4, 16), dtype=np.uint64)
    got = s5.compress(torch.from_numpy(state.view(np.int64)),
                      torch.from_numpy(block.view(np.int64)))

    def planes(x):
        return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))

    lo, hi = js5.compress(planes(state), planes(block))
    want = np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << np.uint64(32))
    assert np.array_equal(got.numpy().view(np.uint64), want)


def test_sha256_variable_against_reference():
    msgs = [m for n in (0, 55, 56, 64, 128) for m in _msgs(n, count=1)]
    packed = [s2.pad_message(m) for m in msgs]
    nb = max(p.shape[0] for p in packed)
    blocks = np.zeros((len(msgs), nb, 16), np.int64)
    for i, p in enumerate(packed):
        assert np.array_equal(p, js2.pad_message(msgs[i]).astype(np.int64))
        blocks[i, :p.shape[0]] = p
    counts = np.array([p.shape[0] for p in packed], np.int32)
    got = s2.sha256_variable(torch.from_numpy(blocks), torch.from_numpy(counts))
    want = js2.sha256_variable(jnp.asarray(blocks.astype(np.uint32)),
                               jnp.asarray(counts))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert [s2.digest_to_bytes(row) for row in got.numpy()] == [
        hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("n_leaves", [1, 3, 8])
def test_simple_merkle_root_host_and_vec(n_leaves):
    rng = np.random.default_rng(20 + n_leaves)
    leaves = [rng.bytes(32) for _ in range(n_leaves)]
    root = cm.simple_merkle_root(leaves)
    assert root == jcm.simple_merkle_root(leaves)
    size = 1 << (n_leaves - 1).bit_length()
    padded = leaves + [bytes(32)] * (size - n_leaves)
    if size > 1:
        got = cm.simple_merkle_root_vec(torch.from_numpy(_words(padded)))
        assert s2.digest_to_bytes(got.numpy()) == root
        want = jcm.simple_merkle_root_vec(
            jnp.asarray(_words(padded).astype(np.uint32)))
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_range_commitments_against_reference():
    rng = np.random.default_rng(31)
    state = [rng.bytes(32) for _ in range(5)]
    data = [rng.bytes(32) for _ in range(5)]
    assert cm.range_commitments(state, data, 8) == jcm.range_commitments(
        state, data, 8)
    assert consts.HEADER_RANGE_TREE_SIZE_SMALL == 256
    assert consts.MAX_AUTHORITY_SET_SIZE == 300


@pytest.mark.parametrize("num_active", [0, 1, 3, 5])
def test_authority_set_hash_host_and_vec(num_active):
    rng = np.random.default_rng(41)
    keys = [rng.bytes(32) for _ in range(5)]
    want = cm.authority_set_hash(keys[:num_active])
    assert want == jcm.authority_set_hash(keys[:num_active])
    pk = np.frombuffer(b"".join(keys), np.uint8).reshape(5, 32).copy()
    got = cm.authority_set_hash_vec(torch.from_numpy(pk), num_active)
    assert s2.digest_to_bytes(got.numpy()) == (want or bytes(32))
    ref = jcm.authority_set_hash_vec(jnp.asarray(pk), jnp.int32(num_active))
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def test_sha256_pair_words_and_byte_packing():
    rng = np.random.default_rng(51)
    left, right = rng.bytes(32), rng.bytes(32)
    got = cm.sha256_pair_words(torch.from_numpy(_words([left])),
                               torch.from_numpy(_words([right])))
    assert s2.digest_to_bytes(got[0].numpy()) == hashlib.sha256(
        left + right).digest()
    raw = torch.from_numpy(np.frombuffer(left, np.uint8).copy())
    words = cm._bytes32_to_words(raw)
    assert np.array_equal(words.numpy(), _words([left])[0])
    assert bytes(cm._words_to_bytes32(words).numpy()) == left


def test_ed25519_host_constants_against_reference():
    from vectorx_tpu.circuits import ed25519 as jed
    from vectorx_tpu.stark import air_ed25519 as jair
    for name in ("P", "L_ORDER", "D_CONST", "SQRT_M1", "_BX", "_BY"):
        assert getattr(ed, name) == getattr(jed, name), name
    assert air_ed25519.dummy_sig() == jair.dummy_sig()
    a, r, _, _ = air_ed25519.dummy_sig()
    x, y, sign = air_ed25519.decompress_host(a)
    assert (x, y, sign) == jair.decompress_host(a) == (ed._BX, ed._BY, ed._BX & 1)
    assert air_ed25519.compress_host(x, y) == a
    assert air_ed25519.decompress_host(r) == (0, 1, 0)
