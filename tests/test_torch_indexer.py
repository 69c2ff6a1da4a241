"""The port's justification indexer against the JAX package's.

``verify_justification`` through the port's batched verification
(``device="cpu"``: one ``verify_batch`` over the whole precommit set) and
through its host route (``use_device=False``, RFC 8032 on Python ints),
against the JAX package's host route (``cryptography``; its device route
compiles for minutes on a CPU): a 300-key set with a forged and missing
lanes, a set below the 2/3 threshold, an empty one; and the ``run`` loop.
"""

import asyncio
import dataclasses
import logging

import numpy as np
import pytest
import torch

from vectorx_tpu.services import indexer as jindexer
from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.services import indexer, store

import avail_fake as af

torch.set_num_threads(1)


def _justification(mod, block_hash, block, set_id, pubs, sigs, lanes, forged=()):
    """lanes: the authorities whose precommits are present, in order."""
    return mod.Justification(
        round=2, block_hash=block_hash, block_number=block, authority_set_id=set_id,
        precommit_pubkeys=[pubs[i] for i in lanes],
        precommit_signatures=[af.forged(sigs[i]) if i in forged else sigs[i]
                              for i in lanes])


def test_verify_justification_300_keys_equals_reference():
    """240 signers present in shuffled order, one of them forged, 60
    missing: the forged lane is dropped, the rest aligned."""
    rng = np.random.default_rng(300)
    block, block_hash, set_id = 4321, rng.bytes(32), 11
    message = scale.encode_precommit_bytes(block_hash, block, 2, set_id)
    pubs, sigs = af.signed_set(rng, 300, message)
    lanes = [int(i) for i in rng.permutation(300)[:240]]
    forged = {lanes[17]}

    def make(mod):
        return _justification(mod, block_hash, block, set_id, pubs, sigs, lanes, forged)

    want = jindexer.verify_justification(make(jindexer), pubs, use_device=False)
    got = indexer.verify_justification(make(indexer), pubs, device="cpu")
    host = indexer.verify_justification(make(indexer), pubs, use_device=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(host) == dataclasses.asdict(want)
    assert sum(got.validator_signed) == 239
    assert got.validator_signed == [i in lanes and i not in forged for i in range(300)]
    assert got.signatures[lanes[17]] == bytes(64).hex()


def test_verify_justification_below_threshold_is_refused():
    """12 keys, 9 precommits with one forged: 8 valid <= 12 * 2 // 3."""
    rng = np.random.default_rng(12)
    block_hash = rng.bytes(32)
    message = scale.encode_precommit_bytes(block_hash, 77, 2, 3)
    pubs, sigs = af.signed_set(rng, 12, message)

    def make(mod, forged):
        return _justification(mod, block_hash, 77, 3, pubs, sigs, range(9), forged)

    assert jindexer.verify_justification(make(jindexer, {4}), pubs, use_device=False) is None
    assert indexer.verify_justification(make(indexer, {4}), pubs, device="cpu") is None
    assert indexer.verify_justification(make(indexer, {4}), pubs, use_device=False) is None
    # without the forgery 9 > 8 is enough
    honest = indexer.verify_justification(make(indexer, ()), pubs, use_device=False)
    assert dataclasses.asdict(honest) == dataclasses.asdict(
        jindexer.verify_justification(make(jindexer, ()), pubs, use_device=False))
    empty = indexer.Justification(2, block_hash, 77, 3, [], [])
    assert indexer.verify_justification(empty, pubs, device="cpu") is None


def test_indexer_run_stores_what_verifies(caplog):
    rng = np.random.default_rng(5)
    block_hash = rng.bytes(32)
    message = scale.encode_precommit_bytes(block_hash, 60, 2, 1)
    pubs, sigs = af.signed_set(rng, 4, message)
    queue = [_justification(indexer, block_hash, 60, 1, pubs, sigs, [0, 1, 2]),
             _justification(indexer, block_hash, 60, 1, pubs, sigs, [0, 1])]

    class Source:
        async def next_justification(self):
            if not queue:
                raise EOFError
            return queue.pop(0)

        async def get_authorities(self, block):
            assert block == 59
            return pubs

    s = store.InMemoryStore()
    with caplog.at_level(logging.INFO, logger="vectorx.indexer"), \
            pytest.raises(EOFError):
        asyncio.run(indexer.run(Source(), s, device="cpu"))
    assert s.justified_blocks_in_range(0, 100) == [60]
    assert s.get_justification(60).validator_signed == [True, True, True, False]
    assert any("below threshold" in r.getMessage() for r in caplog.records)
