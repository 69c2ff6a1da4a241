"""Port vs reference: the batched Ed25519 point arithmetic and
verification of ``circuits/ed25519.py``.

Keys come from seeded bytes (an RFC 8032 signer on Python ints,
tests/reference_data/inputs.py); the JAX package's jitted stages
(``decompress``, ``scalar_mul``, ``scalar_mul_binary``) and
``verify_batch``, all at 8 lanes, are recorded (tests/reference_data/
test_torch_ed25519_batch.json, made by tests/reference_data/record.py),
and the port's functions (torch, CPU) must give the same limbs and the
same booleans (tolerance 0). The decompression cases: valid
points, y >= p, a y with no square root, x = 0 with the sign bit set and
the all-zero dummy key. The verification lanes: signed, disabled, a
flipped s, a bad R, a wrong key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorx_tpu.circuits import ed25519 as jed
from vectorx_tpu_torch.circuits import ed25519 as ed
from vectorx_tpu_torch.field import field25519 as fe

import reference_data as rd
from reference_data import inputs

torch.set_num_threads(1)

P = ed.P


_encodings = inputs.ed_encodings
_lanes = inputs.ed_lanes
_scalar_bits = inputs.scalar_bytes
MSG = inputs.EB_MSG
LANES = inputs.EB_LANES


@pytest.fixture(scope="module")
def ref():
    """The JAX package's results on the cases, as recorded."""
    names, enc = _encodings()
    want = rd.load("test_torch_ed25519_batch",
                   inputs.test_torch_ed25519_batch())
    out = {k: ([rd.from_values(c) for c in v] if isinstance(v, list)
               else rd.from_values(v)) for k, v in want.items()}
    return dict(out, names=names, enc=enc)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_point(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.fixture(scope="module")
def port_decompressed(ref):
    return ed.decompress(_t(ref["enc"]))


@pytest.mark.parametrize("case", range(8))
def test_decompress_equals_reference(ref, port_decompressed, case):
    pt, valid = port_decompressed
    assert bool(valid[case]) == bool(ref["valid"][case]), ref["names"][case]
    _same_point([c[case] for c in pt], [c[case] for c in ref["pt"]])


def test_decompress_invalid_cases_rejected(ref, port_decompressed):
    _, valid = port_decompressed
    by_name = dict(zip(ref["names"], valid.tolist()))
    assert not by_name["y_eq_p"] and not by_name["y_ge_p"]
    assert not by_name["non_square"] and not by_name["x0_sign"]
    assert by_name["x0"] and by_name["valid0"] and by_name["valid1"]


def _a_point(port_decompressed):
    return port_decompressed[0]


def test_scalar_mul_window_equals_reference(ref, port_decompressed):
    bits = ed.bytes_to_bits_le(_t(_scalar_bits()))
    assert np.array_equal(bits.numpy(), ref["bits"].astype(np.int64))
    _same_point(ed.scalar_mul(_a_point(port_decompressed), bits),
                ref["window"])


def test_scalar_mul_binary_equals_reference(ref):
    bits = ed.bytes_to_bits_le(_t(_scalar_bits()))
    _same_point(ed.scalar_mul_binary(ed.base_point((8,), "cpu"), bits),
                ref["binary"])


def test_point_add_double_eq_equal_reference(ref, port_decompressed):
    a_pt = _a_point(port_decompressed)
    base = ed.base_point((8,), "cpu")
    _same_point(ed.point_add(a_pt, base), ref["add"])
    _same_point(ed.point_double(a_pt), ref["double"])
    bits = ed.bytes_to_bits_le(_t(_scalar_bits()))
    got = ed.point_eq(ed.scalar_mul(a_pt, bits), a_pt)
    assert np.array_equal(got.numpy(), ref["eq"])


def test_compute_challenges_equals_reference(ref):
    pk, sg, _ = _lanes()
    got = ed.compute_challenges([bytes(r) for r in sg[:, :32]],
                                [bytes(p) for p in pk], MSG, "cpu")
    assert np.array_equal(got, ref["ch"])


@pytest.fixture(scope="module")
def port_verified(ref):
    pk, sg, enabled = _lanes()
    return ed.verify_batch(_t(pk), _t(sg[:, :32]), _t(sg[:, 32:]),
                           _t(ref["ch"]), _t(enabled))


@pytest.mark.parametrize("lane", range(len(LANES)))
def test_verify_batch_equals_reference(ref, port_verified, lane):
    assert bool(port_verified[lane]) == bool(ref["ok"][lane]), LANES[lane]


def test_verify_batch_lanes(port_verified):
    want = [True, True, False, False, False, True, True, True]
    assert port_verified.tolist() == want


def test_limb_byte_helpers_round_trip():
    b = _t(np.random.default_rng(64).integers(0, 256, (4, 32), dtype=np.uint8))
    limbs = ed.bytes_to_limbs_le(b)
    assert torch.equal(ed.limbs_to_bytes_le(limbs), b)
    assert np.array_equal(
        limbs.numpy(), np.asarray(jed.bytes_to_limbs_le(jnp.asarray(b.numpy()))))
    assert list(fe.from_limbs(limbs)) == [
        int.from_bytes(bytes(r), "little") % P for r in b.numpy()]
