"""Port vs reference: the batched Ed25519 point arithmetic and
verification of ``circuits/ed25519.py``.

Keys come from seeded bytes (cryptography's ``from_private_bytes``); the
JAX package's jitted stages (``decompress``, ``scalar_mul``,
``scalar_mul_binary``) and ``verify_batch`` run once, eagerly, in a module
fixture, all at 8 lanes so that each stage compiles once, and the port's functions (torch, CPU) must give the same limbs
and the same booleans (tolerance 0). The decompression cases: valid
points, y >= p, a y with no square root, x = 0 with the sign bit set and
the all-zero dummy key. The verification lanes: signed, disabled, a
flipped s, a bad R, a wrong key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu.circuits import ed25519 as jed
from vectorx_tpu_torch.circuits import ed25519 as ed
from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.field import field25519 as fe

torch.set_num_threads(1)

P = ed.P


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
            for _ in range(n)]
    return keys, [k.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        for k in keys]


def _non_square_y() -> int:
    """The smallest y whose x^2 = (y^2 - 1) / (d y^2 + 1) has no root."""
    for y in range(2, 100):
        u, v = (y * y - 1) % P, (ed.D_CONST * y * y + 1) % P
        if pow(u * pow(v, P - 2, P) % P, (P - 1) // 2, P) == P - 1:
            return y
    raise AssertionError("no non-square below 100")


def _encodings():
    """-> (names, (n, 32) uint8) of the decompression cases."""
    _, pubs = _keys(2, 61)
    cases = {f"valid{i}": p for i, p in enumerate(pubs)}
    cases["y_eq_p"] = P.to_bytes(32, "little")
    cases["y_ge_p"] = (P + 3).to_bytes(32, "little")
    cases["non_square"] = _non_square_y().to_bytes(32, "little")
    cases["x0_sign"] = (1 | (1 << 255)).to_bytes(32, "little")
    cases["x0"] = (1).to_bytes(32, "little")
    cases["dummy"] = bytes(32)
    names = list(cases)
    return names, np.stack([np.frombuffer(cases[k], np.uint8) for k in names])


MSG = scale.encode_precommit_bytes(bytes(range(32)), 1234, 5, 6)
LANES = ("signed0", "disabled", "flipped_s", "bad_r", "wrong_key",
         "signed1", "signed2", "disabled_garbage")


def _lanes():
    keys, pubs = _keys(8, 62)
    sigs = [k.sign(MSG) for k in keys]
    enabled = np.ones(8, bool)
    enabled[1] = enabled[7] = False
    sigs[2] = sigs[2][:32] + bytes([sigs[2][32] ^ 1]) + sigs[2][33:]
    sigs[3] = bytes([sigs[3][0] ^ 4]) + sigs[3][1:]
    pubs[4] = pubs[5]
    sigs[7] = bytes(range(64))
    pk = np.stack([np.frombuffer(p, np.uint8) for p in pubs])
    sg = np.stack([np.frombuffer(s, np.uint8) for s in sigs])
    return pk, sg, enabled


def _scalar_bits():
    rng = np.random.default_rng(63)
    s = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    s[0] = 0
    s[1] = 255
    return s


@pytest.fixture(scope="module")
def ref():
    names, enc = _encodings()
    pt, valid = jed.decompress(jnp.asarray(enc))
    pk, sg, enabled = _lanes()
    ch = jed.compute_challenges([bytes(r) for r in sg[:, :32]],
                                [bytes(p) for p in pk], MSG)
    ok = jed.verify_batch(jnp.asarray(pk), jnp.asarray(sg[:, :32]),
                          jnp.asarray(sg[:, 32:]), jnp.asarray(ch),
                          jnp.asarray(enabled))
    sbytes = _scalar_bits()
    bits = jed.bytes_to_bits_le(jnp.asarray(sbytes))
    base = jed.base_point((8,))
    a_pt = jed.Point(*pt)
    return dict(
        names=names, enc=enc, pt=[np.asarray(c) for c in pt],
        valid=np.asarray(valid), ch=ch, ok=np.asarray(ok),
        window=[np.asarray(c) for c in jed.scalar_mul(a_pt, bits)],
        binary=[np.asarray(c) for c in jed.scalar_mul_binary(base, bits)],
        add=[np.asarray(c) for c in jed.point_add(a_pt, base)],
        double=[np.asarray(c) for c in jed.point_double(a_pt)],
        eq=np.asarray(jed.point_eq(jed.scalar_mul(a_pt, bits), a_pt)),
        bits=np.asarray(bits))


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
