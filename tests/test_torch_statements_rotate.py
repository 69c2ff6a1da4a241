"""The port's rotate bundle end to end on the CPU, and RotateHeaderAir
against the JAX package.

One bundle is proved in a module-scoped fixture at the sizes of
tests/test_statements_rotate.py (an epoch-end header scheduling 2 new keys,
RotateHeaderAir(2), 2-key chains, Ed25519 and SHA-512 shards of one lane,
B = 8, rate 1, 4 queries) but for the current set: one key, which signs,
where the JAX test has two (each signer costs an Ed25519 proof of minutes
on a CPU; test_torch_statements.py says more). The keys come from seeded
bytes. The cases of tests/test_statements_rotate.py,
one for one: the output equals authority_set_hash of the new keys; a wrong
current set, a tampered window and a wrong epoch block raise
VerificationError; the serialization round trip.

RotateHeaderAir is new in the port with this bundle, so it is held against
the JAX package here (tolerance 0): the header parser, the trace, publics,
digest and constant columns of the same header, and the transition under
BaseVecAlgebra on 8 seeded random values per column and public. The
JAX package's trace, publics, constant columns and constraint values are
recorded (tests/reference_data/test_torch_statements_rotate.json, made by
tests/reference_data/record.py). The other sub-proofs' AIRs are held to
payload parity in the earlier files (test_torch_statement_*.py,
test_torch_ed25519_*.py).
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from vectorx_tpu.circuits import rotate as jrotate
from vectorx_tpu.stark import air_rotate as jrot
from vectorx_tpu_torch.circuits import commitments, rotate, scale
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import air_rotate as prot
from vectorx_tpu_torch.stark import serialize
from vectorx_tpu_torch.stark import statements as st
from vectorx_tpu_torch.stark.air import check_constraints
from vectorx_tpu_torch.stark.prover import StarkConfig

import reference_data as rd
import test_torch_gadget_vec as common
from reference_data import inputs
from reference_data.inputs import random_columns
from test_torch_statements import seeded_keys

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
CFG = StarkConfig(rate_bits=1, num_queries=4, final_poly_len=4)
EPOCH_END_BLOCK = inputs.ROT_EPOCH_END_BLOCK
N_CUR = 1          # current authorities (it signs: 1*3 > 1*2)
N_NEW = 2          # scheduled new authorities
MAX_AUTH = 2       # the chains' size, as in tests/test_statements_rotate.py
SET_ID = 4
ROUND = 1
MAX_CHUNKS = inputs.ROT_MAX_CHUNKS

CUR_KEYS, CUR_PUBS = seeded_keys(RNG, N_CUR)
NEW_PUBS = seeded_keys(RNG, N_NEW)[1]
HEADER = inputs.epoch_end_header(RNG, EPOCH_END_BLOCK, NEW_PUBS)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    digest = hashlib.blake2b(HEADER, digest_size=32).digest()
    msg = scale.encode_precommit_bytes(digest, EPOCH_END_BLOCK, ROUND, SET_ID)
    sigs = [k.sign(msg) for k in CUR_KEYS]
    checkpoint = str(tmp_path_factory.mktemp("rotate_ckpt"))
    bundle = st.prove_rotate(
        EPOCH_END_BLOCK, HEADER, CUR_PUBS, sigs, SET_ID, ROUND, CFG,
        max_chunks=MAX_CHUNKS, max_authorities=MAX_AUTH, device="cpu",
        checkpoint=checkpoint)
    return dict(bundle=bundle, sigs=sigs, checkpoint=checkpoint)


def _verify(bundle, set_hash=None):
    return st.verify_rotate(
        bundle, SET_ID, set_hash or commitments.authority_set_hash(CUR_PUBS),
        CFG, device="cpu")


def test_rotate_bundle_verifies(setup):
    assert _verify(setup["bundle"]) == commitments.authority_set_hash(NEW_PUBS)


def test_rotate_rejects_wrong_current_set(setup):
    with pytest.raises(st.VerificationError):
        _verify(setup["bundle"], hashlib.sha256(b"wrong").digest())


def test_rotate_rejects_tampered_window(setup):
    b = setup["bundle"]
    w = bytearray(b.window)
    w[10] ^= 1                      # a byte of a claimed new key
    with pytest.raises(st.VerificationError):
        _verify(dataclasses.replace(b, window=bytes(w)))


def test_rotate_serialization_round_trip(setup):
    b = setup["bundle"]
    blob = st.serialize_rotate(b, CFG)
    back, cfg = st.deserialize_rotate(blob, "cpu")
    assert cfg == CFG
    for f in dataclasses.fields(b):
        got, want = getattr(back, f.name), getattr(b, f.name)
        if f.name.endswith("proof"):
            assert serialize.payload(got) == serialize.payload(want)
        elif f.name.endswith("proofs"):
            assert ([serialize.payload(p) for p in got]
                    == [serialize.payload(p) for p in want])
        else:
            assert got == want, f.name
    assert st.serialize_rotate(back, CFG) == blob


def test_rotate_rejects_wrong_epoch_block(setup):
    bad = dataclasses.replace(setup["bundle"],
                              epoch_end_block=EPOCH_END_BLOCK + 1)
    with pytest.raises(st.VerificationError):
        _verify(bad)


def test_parallel_arguments_procs_and_device_list(setup, monkeypatch):
    """procs: rotate takes it and drops it, as the JAX package does (its
    map phase is one header): procs=2 gives the procs=1 bundle (its
    sub-proofs from the fixture's checkpoint). A list of devices spreads
    the sub-proofs round-robin (the header on device 0, the two chains on
    1 and 2, signature and challenge shard i on i): over two devices, each
    the CPU, every sub-proof comes from the checkpoint on its slot's device
    and the bundle is the one-device bundle's bytes. header_range with
    procs=2 and no checkpoint refuses, as the JAX package does."""
    def prove(**kw):
        return st.prove_rotate(
            EPOCH_END_BLOCK, HEADER, CUR_PUBS, setup["sigs"], SET_ID, ROUND,
            CFG, max_chunks=MAX_CHUNKS, max_authorities=MAX_AUTH, **kw)

    want = st.serialize_rotate(setup["bundle"], CFG)
    again = prove(device="cpu", procs=2, checkpoint=setup["checkpoint"])
    assert st.serialize_rotate(again, CFG) == want
    assert _verify(again) == commitments.authority_set_hash(NEW_PUBS)
    loads = []
    load = st.Checkpoint.load

    def recording_load(self, label, config, parts, air, device=None):
        loads.append((label, device))
        return load(self, label, config, parts, air, device)

    two = [torch.device("cpu"), torch.device("cpu", 0)]
    monkeypatch.setattr(st.Checkpoint, "load", recording_load)
    spread = prove(device=two, checkpoint=setup["checkpoint"])
    assert st.serialize_rotate(spread, CFG) == want
    n_shards = len(setup["bundle"].sig_proofs)
    labels = (["rot-hdr", "rot-chain", "rot-chain"] + ["sig"] * n_shards
              + ["sha512"] * n_shards)
    slots = [0, 1, 2] + list(range(n_shards)) * 2
    assert loads == [(label, two[i % 2]) for label, i in zip(labels, slots)]
    with pytest.raises(AssertionError, match="checkpoint"):
        st.prove_header_range(
            EPOCH_END_BLOCK - 1, EPOCH_END_BLOCK, [HEADER], CUR_PUBS,
            setup["sigs"], SET_ID, ROUND, CFG, tree_size=2,
            max_chunks=MAX_CHUNKS, max_authorities=MAX_AUTH, device="cpu",
            procs=2)


# -- RotateHeaderAir and the parser against the JAX package -------------------------

def test_find_scheduled_change_equal_reference():
    got = rotate.find_scheduled_change(HEADER)
    assert got == jrotate.find_scheduled_change(HEADER)
    assert got[1:] == (N_NEW, NEW_PUBS)
    assert rotate.find_scheduled_change(HEADER.replace(b"FRNK", b"FRNQ")) is None


@pytest.fixture(scope="module")
def jax_rot():
    """The JAX package's RotateHeaderAir trace, constants and constraint
    values of HEADER, as recorded."""
    return rd.load("test_torch_statements_rotate",
                   inputs.test_torch_statements_rotate(HEADER))


@pytest.fixture(scope="module")
def traces(jax_rot):
    port = prot.RotateHeaderAir(MAX_CHUNKS).make_trace(HEADER, "cpu")
    start, n_auth, pubkeys = jax_rot["info"]
    ref = (jax_rot["trace"], jax_rot["publics"],
           bytes.fromhex(jax_rot["digest"]),
           (start, n_auth, [bytes.fromhex(p) for p in pubkeys]))
    return port, ref


def test_rotate_trace_equal_reference(traces):
    (trace, publics, digest, info), (jtrace, jpublics, jdigest, jinfo) = traces
    assert rd.array(gl.to_u64(trace)) == jtrace
    assert [int(p) for p in publics] == [int(p) for p in jpublics]
    assert digest == jdigest == hashlib.blake2b(HEADER, digest_size=32).digest()
    assert info == jinfo


def test_rotate_constants_and_window_fields_equal_reference(traces, jax_rot):
    air, jair_ = prot.RotateHeaderAir(MAX_CHUNKS), jrot.RotateHeaderAir(MAX_CHUNKS)
    n = air.n_rows
    assert (rd.array(np.asarray(air.constant_columns(n), np.uint64))
            == jax_rot["constant_columns"])
    assert (air.num_cols, air.num_publics) == (jair_.num_cols,
                                               jair_.num_publics)
    (_, publics, _, (start, _, _)), _ = traces
    window = HEADER[start:start + int(publics[prot.P_WLEN])]
    got = prot.rotate_window_fields(publics, window, "cpu")
    assert got == jrot.rotate_window_fields(publics, window)
    assert got["new_pubkeys"] == NEW_PUBS


def test_rotate_check_constraints(traces):
    air = prot.RotateHeaderAir(MAX_CHUNKS)
    trace, publics = traces[0][:2]
    pubs = [gl.to_fp(int(p), "cpu") for p in publics]
    assert check_constraints(air, trace, pubs)
    bad = trace.clone()
    bad[prot.RRA1, 120] ^= 1        # the window's running RLC
    assert not check_constraints(air, bad, pubs)


def test_rotate_transition_equal_reference(jax_rot):
    air = prot.RotateHeaderAir(MAX_CHUNKS)
    k = air.constant_columns(2).shape[0]
    rng = np.random.default_rng(12)
    cols = (random_columns(rng, air.num_cols, 8),
            random_columns(rng, air.num_cols, 8),
            random_columns(rng, k, 8),
            random_columns(rng, k, 8))
    pubs = random_columns(rng, air.num_publics, 1)[:, 0]
    evals = [common.base_eval(air, cols, pubs), jax_rot["transition"]]
    assert len(evals[0]) == len(evals[1]) == 68
    for port_c, jax_c in zip(*evals):
        common.assert_equal_base(port_c, jax_c)
