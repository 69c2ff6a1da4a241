"""Port vs reference: Ed25519VerifyAir(B = 8) under ExtAlgebra, and the
shard helpers of ed25519_prove.

The transition at one seeded random point of GF(p^2) (every column, next
column and constant column a seeded (re, im) pair) is the verifier's ALI
check; the port's values must equal the JAX package's constraint by
constraint (tolerance 0). The lanes of a justification (signed, unsigned),
their shards at B = 9 and each shard's publics must equal the JAX
package's as well. The JAX package's constraint values are recorded
(tests/reference_data/test_torch_ed25519_ext.json, made by
tests/reference_data/record.py).
"""

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu.stark import air_ed25519 as jed
from vectorx_tpu.stark import ed25519_prove as jprove
from vectorx_tpu_torch.stark import air_ed25519 as ped
from vectorx_tpu_torch.stark import ed25519_prove as pprove

import reference_data as rd
import test_torch_gadget_vec as common
from reference_data import inputs
from reference_data.inputs import random_columns
from test_torch_ed25519_air import LANES, MSG, N_CONSTRAINTS

torch.set_num_threads(1)

_cache = {}


@pytest.fixture(scope="module")
def jax_ext():
    """The JAX package's values, as recorded."""
    return rd.load("test_torch_ed25519_ext",
                   inputs.test_torch_ed25519_ext(LANES))["ext"]


def _ext():
    if "port" not in _cache:
        air = ped.Ed25519VerifyAir([LANES["signed"]], B=8)
        rng = np.random.default_rng(9)
        k = air.constant_columns(2).shape[0]
        cols = (random_columns(rng, air.num_cols, 2),
                random_columns(rng, air.num_cols, 2),
                random_columns(rng, k, 2),
                random_columns(rng, k, 2))
        _cache["port"] = common.ext_eval(air, cols)
    return _cache["port"]


@pytest.mark.parametrize("i", range(N_CONSTRAINTS))
def test_ext_constraints_equal_reference(i, jax_ext):
    assert len(_ext()) == len(jax_ext) == N_CONSTRAINTS
    common.assert_equal_ext(_ext()[i], jax_ext[i])


def _justification(n: int, signed):
    keys = [Ed25519PrivateKey.from_private_bytes(
        np.random.default_rng(100 + i).bytes(32)) for i in range(n)]
    pubs = [k.public_key().public_bytes(serialization.Encoding.Raw,
                                        serialization.PublicFormat.Raw)
            for k in keys]
    sigs = [k.sign(MSG) if on else bytes(64) for k, on in zip(keys, signed)]
    return pubs, sigs


def test_lanes_and_shards_equal_reference():
    signed = [True, False, True, True, False]
    pubs, sigs = _justification(5, signed)
    lanes = pprove.sigs_from_justification(pubs, sigs, signed, MSG)
    assert lanes == jprove.sigs_from_justification(pubs, sigs, signed, MSG)
    assert lanes[1] == lanes[4] == ped.dummy_sig()
    shards = pprove.shard_sigs(lanes, 9)
    assert shards == jprove.shard_sigs(lanes, 9)
    assert [len(s) for s in shards] == [2, 2, 1]
    for shard in shards:
        air = ped.Ed25519VerifyAir(shard, B=9)
        assert air.sigs == jed.Ed25519VerifyAir(shard, B=9).sigs
        assert air.publics_list() == jed.Ed25519VerifyAir(
            shard, B=9).publics_list()
        assert air.publics_list()[0] == 2


def test_prove_sigs_spreads_shards_over_several_devices(monkeypatch):
    """Shard i is built and proved on device i % 2 of a list of two (each
    the CPU); the prover is recorded, not run."""
    built, proved = [], []

    def make_trace_vec(self, device=None):
        built.append(device)
        return torch.zeros((1, 4), dtype=torch.int64, device=device), [0]

    def prove(air, trace, pubs, config):
        proved.append((trace.device, pubs[0].device))
        return "proof"

    monkeypatch.setattr(ped.Ed25519VerifyAir, "make_trace_vec",
                        make_trace_vec)
    monkeypatch.setattr(pprove.prover, "prove", prove)
    two = [torch.device("cpu"), torch.device("cpu", 0)]
    out = pprove.prove_sigs([LANES["dummy"]] * 3, 8, None, device=two)
    assert built == [two[0], two[1], two[0]]
    assert proved == [(torch.device("cpu"),) * 2] * 3
    assert [proof for _, proof, _ in out] == ["proof"] * 3
