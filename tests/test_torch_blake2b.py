"""Port vs reference: batched variable-length Blake2b-256.

One batch of messages at the boundary lengths (0, 1, 111, 112, 127, 128,
129, 255, 256, 257 and the full buffer) with zero-length padding slots,
made from a numpy seed, goes through the JAX package's
``blake2b256_variable`` (once, in a module fixture) and the port's, on the
CPU: the digest planes must be equal, and equal to hashlib's (tolerance
0). The port also hashes bytes directly (``hash_headers``,
``blake2b256_bytes``); those digests must be the same.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorx_tpu.hashes import blake2b as jb2
from vectorx_tpu.parallel import subchain as jsub
from vectorx_tpu_torch.hashes import blake2b as b2
from vectorx_tpu_torch.parallel import subchain

torch.set_num_threads(1)

CHUNKS = 3
LENGTHS = (0, 1, 111, 112, 127, 128, 129, 255, 256, 257, CHUNKS * 128, 0)
M32 = 0xFFFFFFFF


def _messages():
    rng = np.random.default_rng(23)
    return [rng.bytes(n) for n in LENGTHS]


@pytest.fixture(scope="module")
def case():
    msgs = _messages()
    packed = [jb2.pack_message(m, CHUNKS) for m in msgs]
    lo = np.stack([p[0] for p in packed])
    hi = np.stack([p[1] for p in packed])
    lengths = np.array([p[2] for p in packed], np.uint32)
    d_lo, d_hi = jb2.blake2b256_variable(jnp.asarray(lo), jnp.asarray(hi),
                                         jnp.asarray(lengths))
    d_lo, d_hi = np.asarray(d_lo), np.asarray(d_hi)
    return dict(msgs=msgs, lo=lo, hi=hi, lengths=lengths, d_lo=d_lo,
                d_hi=d_hi,
                jax_bytes=np.asarray(jsub._digest_planes_to_bytes32(
                    jnp.asarray(d_lo), jnp.asarray(d_hi))))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def port_planes(case):
    return b2.blake2b256_variable(_t(case["lo"]), _t(case["hi"]),
                                  _t(case["lengths"]))


@pytest.mark.parametrize("i", range(len(LENGTHS)))
def test_variable_planes_equal_reference_and_hashlib(case, port_planes, i):
    d_lo, d_hi = port_planes
    assert np.array_equal(d_lo[i].numpy(), case["d_lo"][i].astype(np.int64))
    assert np.array_equal(d_hi[i].numpy(), case["d_hi"][i].astype(np.int64))
    assert b2.digest_to_bytes(d_lo[i], d_hi[i]) == hashlib.blake2b(
        case["msgs"][i], digest_size=32).digest()


def test_digest_planes_to_bytes32_equals_reference(case, port_planes):
    got = subchain._digest_planes_to_bytes32(*port_planes)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), case["jax_bytes"])


def test_hash_headers_of_bytes_equals_reference(case):
    buf = np.zeros((len(LENGTHS), CHUNKS * 128), np.uint8)
    for i, m in enumerate(case["msgs"]):
        buf[i, :len(m)] = np.frombuffer(m, np.uint8)
    got = subchain.hash_headers(torch.from_numpy(buf),
                                torch.tensor(case["lengths"].astype(np.int64)))
    assert np.array_equal(got.numpy(), case["jax_bytes"])


def test_blake2b256_bytes_equals_hashlib(case):
    got = b2.blake2b256_bytes(case["msgs"], CHUNKS, "cpu")
    assert got == [hashlib.blake2b(m, digest_size=32).digest()
                   for m in case["msgs"]]
    assert got == jb2.blake2b256_bytes(case["msgs"], CHUNKS)


@pytest.mark.parametrize("n", [0, 5, 128, 300])
def test_pack_message_equals_reference(n):
    msg = bytes(range(256)) * 2
    got, want = b2.pack_message(msg[:n], CHUNKS), jb2.pack_message(msg[:n], CHUNKS)
    assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2]))
    assert got[2] == want[2]


@pytest.mark.parametrize("t,last", [(0, False), (128, True), (M32, True),
                                    (M32 - 127, False)])
def test_compress_equals_reference(t, last):
    """One compression at byte counters up to the top of the u32 range
    (the JAX package's counter is a u32 pair with a zero high word)."""
    rng = np.random.default_rng(t & 0xFF)
    h = rng.integers(0, 1 << 32, (2, 8), dtype=np.uint64)
    hh = rng.integers(0, 1 << 32, (2, 8), dtype=np.uint64)
    m = rng.integers(0, 1 << 32, (2, 16), dtype=np.uint64)
    mh = rng.integers(0, 1 << 32, (2, 16), dtype=np.uint64)
    u32 = lambda a: jnp.asarray(a.astype(np.uint32))
    tt = np.full(2, t, np.uint64)
    want_lo, want_hi = jb2.compress(
        u32(h), u32(hh), u32(m), u32(mh), (u32(tt), u32(tt * 0)),
        jnp.full((2,), int(last), jnp.uint32))
    got = b2.compress(_t(h | (hh << np.uint64(32))),
                      _t(m | (mh << np.uint64(32))),
                      torch.full((2,), t), torch.full((2,), last))
    assert np.array_equal((got & M32).numpy(), np.asarray(want_lo).astype(np.int64))
    assert np.array_equal(((got >> 32) & M32).numpy(),
                          np.asarray(want_hi).astype(np.int64))
