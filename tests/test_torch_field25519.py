"""Port vs reference: GF(2^255 - 19) and the scalar field mod L, limb for
limb.

Every public function of ``field25519`` and ``scalar25519`` runs on the
same 16-bit limbs in the JAX package (once, in a module fixture) and in
the port (torch, CPU). A 16-bit-limb form of an integer is unique, so the
port's limbs must equal the reference's limb for limb (tolerance 0), not
only mod p. The values are seeded random ones plus the edges 0, 1, p - 1,
p, p + 1 .. 2^255 - 1 and lazy values up to 2^256 - 1; the pairs include
b > a for ``sub``, whose columns go negative in the reference's wrapping
u32 arithmetic. ``sc_reduce512`` is also held against Python's ``% L``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorx_tpu.field import field25519 as jfe
from vectorx_tpu.field import scalar25519 as jsc
from vectorx_tpu_torch.field import field25519 as fe
from vectorx_tpu_torch.field import scalar25519 as sc

torch.set_num_threads(1)

P = fe.P25519
L = sc.L_ORDER
EDGES = [0, 1, 2, 19, P - 1, P, P + 1, P + 2, P + 18, 2 * P - 1, 2 * P,
         2 * P + 37, (1 << 256) - 39, (1 << 256) - 38, (1 << 256) - 1,
         0xFFFF, (1 << 240) - 1, 1 << 255]


def _values():
    rng = np.random.default_rng(31)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(30)]
    a = EDGES + rand
    b = rand[::-1] + EDGES[::-1]
    return a, b[:len(a)]


def _limbs(values, n=16):
    return np.array([fe.int_limbs(v, n) for v in values], dtype=np.uint32)


A, B = _values()
UNARY = ("neg", "square", "canonicalize", "inv", "pow_p58", "is_zero",
         "_ge_p", "_sub_p")
BINARY = ("add", "sub", "mul", "eq")
SMALL = (2, 38, 32767, 1 << 15, 121666)
POW2K = (1, 5)


@pytest.fixture(scope="module")
def ref():
    ja, jb = jnp.asarray(_limbs(A)), jnp.asarray(_limbs(B))
    out = {name: np.asarray(getattr(jfe, name)(ja)) for name in UNARY}
    out.update({name: np.asarray(getattr(jfe, name)(ja, jb))
                for name in BINARY})
    out["eq_self"] = np.asarray(jfe.eq(ja, jfe.canonicalize(ja)))
    out.update({f"mul_small_{k}": np.asarray(jfe.mul_small(ja, k))
                for k in SMALL})
    out.update({f"pow2k_{k}": np.asarray(jfe.pow2k(ja, k)) for k in POW2K})
    mask = jnp.asarray(np.arange(len(A)) % 3 == 0)
    out["select"] = np.asarray(jfe.select(mask, ja, jb))
    return out


def _port(values):
    return torch.from_numpy(_limbs(values).astype(np.int64))


def _same(got: torch.Tensor, want: np.ndarray):
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want.astype(got.numpy().dtype))


@pytest.mark.parametrize("name", UNARY)
def test_unary_equals_reference(ref, name):
    _same(getattr(fe, name)(_port(A)), ref[name])


@pytest.mark.parametrize("name", BINARY)
def test_binary_equals_reference(ref, name):
    _same(getattr(fe, name)(_port(A), _port(B)), ref[name])


def test_eq_of_lazy_and_canonical_forms(ref):
    a = _port(A)
    _same(fe.eq(a, fe.canonicalize(a)), ref["eq_self"])
    assert bool(fe.eq(a, fe.canonicalize(a)).all())


@pytest.mark.parametrize("k", SMALL)
def test_mul_small_equals_reference(ref, k):
    _same(fe.mul_small(_port(A), k), ref[f"mul_small_{k}"])


@pytest.mark.parametrize("k", POW2K)
def test_pow2k_equals_reference(ref, k):
    _same(fe.pow2k(_port(A), k), ref[f"pow2k_{k}"])


def test_select_equals_reference(ref):
    mask = torch.from_numpy(np.arange(len(A)) % 3 == 0)
    _same(fe.select(mask, _port(A), _port(B)), ref["select"])


def test_ring_values_agree_with_python_ints():
    """The limbs hold the right residues (the oracle beside the limbs)."""
    a, b = _port(A), _port(B)
    got = fe.from_limbs(fe.mul(fe.sub(a, b), fe.add(a, b)))
    assert list(got) == [(x - y) * (x + y) % P for x, y in zip(A, B)]
    inv = fe.from_limbs(fe.mul(a, fe.inv(a)))
    assert list(inv) == [0 if x % P == 0 else 1 for x in A]


def test_sub_b_greater_than_a():
    """a - b for b > a: every column negative before the 4p offset."""
    a, b = [0, 1, 5, P - 1], [(1 << 256) - 1, P - 1, 6, P]
    got = fe.sub(_port(a), _port(b))
    want = jfe.sub(jnp.asarray(_limbs(a)), jnp.asarray(_limbs(b)))
    _same(got, np.asarray(want))
    assert list(fe.from_limbs(got)) == [(x - y) % P for x, y in zip(a, b)]


def test_conversions_equal_reference():
    vals = EDGES[:8]
    _same(fe.to_limbs(vals, "cpu"), np.asarray(jfe.to_limbs(vals)))
    assert list(fe.from_limbs(_port(A))) == list(
        jfe.from_limbs(jnp.asarray(_limbs(A))))
    _same(fe.const((2, 3), P + 7, "cpu"), np.asarray(jfe.const((2, 3), P + 7)))
    _same(fe.zeros((4,), "cpu"), np.asarray(jfe.zeros((4,))))


# ---------------------------------------------------------------------------
# scalar25519
# ---------------------------------------------------------------------------

SCALARS = [0, 1, L - 1, L, L + 1, 2 * L, (L << 259), (1 << 252),
           (1 << 512) - 1] + [
    int.from_bytes(np.random.default_rng(s).bytes(64), "little")
    for s in range(20)]


def _digests():
    return np.array([list(v.to_bytes(64, "little")) for v in SCALARS],
                    np.uint8)


@pytest.fixture(scope="module")
def sc_ref():
    d = jnp.asarray(_digests())
    lim = np.random.default_rng(37).integers(0, 1 << 16, (12, 33),
                                              dtype=np.uint32)
    return dict(reduce512=np.asarray(jsc.sc_reduce512(d)),
                limbs512=np.asarray(jsc.bytes_to_limbs512(d)),
                lim=lim, reduce_limbs=np.asarray(
                    jsc.sc_reduce_limbs(jnp.asarray(lim))),
                to_bytes=np.asarray(jsc.limbs_to_bytes32(jnp.asarray(lim))))


def test_sc_reduce512_equals_reference_and_python(sc_ref):
    got = sc.sc_reduce512(torch.from_numpy(_digests()))
    _same(got, sc_ref["reduce512"])
    assert [int.from_bytes(bytes(r), "little") for r in got.numpy()] == [
        v % L for v in SCALARS]


def test_sc_reduce_limbs_equals_reference(sc_ref):
    _same(sc.sc_reduce_limbs(torch.from_numpy(sc_ref["lim"].astype(np.int64))),
          sc_ref["reduce_limbs"])


def test_scalar_limb_helpers_equal_reference(sc_ref):
    _same(sc.bytes_to_limbs512(torch.from_numpy(_digests())),
          sc_ref["limbs512"])
    _same(sc.limbs_to_bytes32(torch.from_numpy(sc_ref["lim"].astype(np.int64))),
          sc_ref["to_bytes"])
