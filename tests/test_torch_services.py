"""Port vs reference: the host modules behind the CLI — Keccak-256 and the
ABI, the justification store, GRANDPA decoding and alignment, the hint
runtime and the device justification record.

The same inputs, made from numpy seeds (keys from cryptography's
``from_private_bytes`` on seeded bytes), go through the JAX package's
functions and the port's: bytes, records and decoded values must be equal.
The port's ``align_justification`` also checks the signatures with its
batched Ed25519 verification on the CPU, and refuses a forged one.
"""

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu.circuits import abi as jabi
from vectorx_tpu.services import grandpa as jgrandpa
from vectorx_tpu.services import store as jstore
from vectorx_tpu.stark import hints as jhints
from vectorx_tpu.utils import keccak as jkeccak
from vectorx_tpu_torch.circuits import abi, scale
from vectorx_tpu_torch.services import entrypoint, grandpa, store
from vectorx_tpu_torch.stark import hints
from vectorx_tpu_torch.utils import keccak

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 300])
def test_keccak256_equals_reference(n):
    data = np.random.default_rng(n).bytes(n)
    assert keccak.keccak256(data) == jkeccak.keccak256(data)


def test_abi_equals_reference():
    rng = np.random.default_rng(3)
    h1, h2 = rng.bytes(32), rng.bytes(32)
    hr = abi.HeaderRangeInput(246150, h1, 0x75, h2, 246330)
    assert hr.encode() == jabi.HeaderRangeInput(246150, h1, 0x75, h2,
                                                246330).encode()
    assert abi.HeaderRangeInput.decode(hr.encode()) == hr
    out = abi.HeaderRangeOutput(h1, h2, h1[::-1])
    assert abi.HeaderRangeOutput.decode(out.encode()) == out
    rot = abi.RotateInput(7, h2)
    assert rot.encode() == jabi.RotateInput(7, h2).encode()
    assert abi.range_commitment_key(5, 9) == jabi.range_commitment_key(5, 9)
    with pytest.raises(ValueError):
        abi.HeaderRangeInput.decode(hr.encode()[:79])


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
            for _ in range(n)]
    return keys, [k.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        for k in keys]


def _justification_blob(keys, pubs, n_sign, block_hash, block=4096,
                        round_=9, set_id=4):
    msg = scale.encode_precommit_bytes(block_hash, block, round_, set_id)
    enc = round_.to_bytes(8, "little") + block_hash + block.to_bytes(4, "little")
    enc += scale.encode_compact_u32(n_sign)
    for i in range(n_sign):
        enc += block_hash + block.to_bytes(4, "little") + keys[i].sign(msg) + pubs[i]
    return enc + scale.encode_compact_u32(0), msg


def test_grandpa_decoding_equals_reference():
    keys, pubs = _keys(5, 11)
    block_hash = np.random.default_rng(12).bytes(32)
    enc, _ = _justification_blob(keys, pubs, 4, block_hash)
    got = grandpa.decode_grandpa_justification(enc)
    want = jgrandpa.decode_grandpa_justification(enc)
    assert (got.round, got.target_hash, got.target_number) == (
        want.round, want.target_hash, want.target_number)
    assert [vars(p) for p in got.precommits] == [vars(p) for p in want.precommits]
    proof = block_hash + scale.encode_compact_u32(len(enc)) + enc + bytes(1)
    bh, j = grandpa.decode_finality_proof(proof)
    assert bh == block_hash and j.precommits == got.precommits
    with pytest.raises(ValueError):
        grandpa.decode_grandpa_justification(enc[:40])


def test_align_justification_equals_reference_and_verifies():
    keys, pubs = _keys(4, 13)
    enc, msg = _justification_blob(keys, pubs, 3, bytes(range(32)))
    got = grandpa.align_justification(
        grandpa.decode_grandpa_justification(enc), pubs, 4, verify=True,
        device="cpu")
    want = jgrandpa.align_justification(
        jgrandpa.decode_grandpa_justification(enc), pubs, 4, verify=False)
    assert got.to_json() == want.to_json()
    assert got.validator_signed == [True, True, True, False]
    bad = bytearray(enc)
    bad[44 + 1 + 36] ^= 1                 # the first precommit's signature
    with pytest.raises(ValueError, match="invalid signature"):
        grandpa.align_justification(
            grandpa.decode_grandpa_justification(bytes(bad)), pubs, 4,
            verify=True, device="cpu")


def test_store_equals_reference():
    fields = dict(block_number=77, signed_message="01" * 53,
                  pubkeys=["aa" * 32], signatures=["bb" * 64],
                  num_authorities=1, validator_signed=[True])
    rec = store.StoredJustification(**fields)
    assert rec.to_json() == jstore.StoredJustification(**fields).to_json()
    s = store.InMemoryStore()
    s.add_justification(rec)
    assert s.get_justification(77) == rec and s.get_justification(78) is None
    assert s.justified_blocks_in_range(0, 100) == [77]
    s.add_block_range_data(1, 5, b"d" * 32, b"s" * 32)
    assert s.get_block_range_data(1, 5) == (b"d" * 32, b"s" * 32)
    s.set_cursors("0xAB", [[1, 5]])
    assert s.get_cursors("0xab") == [[1, 5]]


class _Source:
    def get_header(self, block):
        return b"H%d" % block

    def get_justification_record(self, block):
        return {"block": block}

    def get_rotate_data(self, set_id):
        return (25 + set_id, b"HDR", 4, 3, [b"\x01" * 32])


def test_hint_runtime_equals_reference():
    src = _Source()
    assert hints.fetch_header_range_witness(src, 10, 80) == \
        jhints.fetch_header_range_witness(src, 10, 80)
    assert hints.fetch_rotate_witness(src, 7) == \
        jhints.fetch_rotate_witness(src, 7)
    reg = hints.HintRegistry()
    reg.register("x", lambda: None)
    with pytest.raises(ValueError):
        reg.register("x", lambda: None)
    assert reg.names() == ["x"]


def test_device_justification_equals_reference():
    from vectorx_tpu.services.grandpa import to_device_justification
    keys, pubs = _keys(3, 14)
    enc, _ = _justification_blob(keys, pubs, 2, bytes(32))
    rec = grandpa.align_justification(
        grandpa.decode_grandpa_justification(enc), pubs, 4, verify=False)
    got = grandpa.to_device_justification(rec, 8, device="cpu")
    want = to_device_justification(jstore.StoredJustification(**vars(rec)), 8)
    for name in got._fields:
        assert np.array_equal(np.asarray(getattr(got, name)).astype(np.int64),
                              np.asarray(getattr(want, name)).astype(np.int64)), name


def test_justification_host_inputs_and_max_chunks():
    from vectorx_tpu.services.entrypoint import (
        _default_max_chunks, _justification_host_inputs)
    keys, pubs = _keys(3, 15)
    enc, _ = _justification_blob(keys, pubs, 2, bytes(32), round_=5)
    rec = grandpa.align_justification(
        grandpa.decode_grandpa_justification(enc), pubs, 1, verify=False)
    assert entrypoint._justification_host_inputs(rec) == \
        _justification_host_inputs(rec)
    for sizes in ([100], [252], [253], [300, 120], [1990]):
        headers = [b"x" * n for n in sizes]
        assert entrypoint._default_max_chunks(headers) == \
            _default_max_chunks(headers)
