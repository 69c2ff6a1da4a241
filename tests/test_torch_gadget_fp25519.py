"""Port vs JAX package: the GF(2^255-19) limb gadgets (stark/
gadget_fp25519.py), the analogues of tests/test_gadget_fp25519.py.

The AIR is the JAX test's ``Fp25519OpsAir`` (per row m = a*b; d = m + a;
e = d - b; f = e * D_CONST, all mod p, in 8-bit limbs over 256 rows, 706
range-looked columns), as chip_smoke.py defines it over the port's
gadgets for its dsl-small phase. On the same seeded field elements the
port's witness equals the int oracle and the JAX package's trace; the
port's proof verifies and its payload equals the JAX package's (the
module's one JAX prove, ~4 min of eager JAX on this AIR's 393
constraints); a tampered product limb and a 9-bit limb are rejected.
Tolerance: exact equality throughout. The JAX package's trace, publics,
outputs and proof are recorded (tests/reference_data/
test_torch_gadget_fp25519.json, made by tests/reference_data/record.py).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from vectorx_tpu.stark import gadget_fp25519 as jgfp
from vectorx_tpu_torch.circuits.ed25519 import D_CONST
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import gadget_fp25519 as gfp
from vectorx_tpu_torch.stark import prover, serialize, verifier

import reference_data as rd
from reference_data import inputs
from test_gadget_fp25519 import Fp25519OpsAir as JFp25519OpsAir

torch.set_num_threads(1)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
AIR = SMOKE.Fp25519OpsAir()
CFG = SMOKE.FP_CFG
LOG_N = SMOKE.FP_LOG_N
N = 1 << LOG_N
INPUTS = SMOKE.fp25519_inputs()


def _port_case(inputs=INPUTS):
    cols, publics, outs = AIR.witness(*inputs)
    return gl.to_fp(cols, "cpu"), [gl.to_fp(p, "cpu") for p in publics], outs


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's trace, publics, outputs and proof, as recorded."""
    return rd.load("test_torch_gadget_fp25519",
                   inputs.test_torch_gadget_fp25519(INPUTS))


def test_helpers_equal_reference():
    for B in (8, 16):
        assert gfp.p_limbs(B) == jgfp.p_limbs(B)
        v = INPUTS[0][3]
        limbs = gfp._int_to_limbs(v, -(-255 // B), B)
        assert limbs == jgfp._int_to_limbs(v, -(-255 // B), B)
        assert gfp.limbs_to_int(limbs, B) == v == jgfp.limbs_to_int(limbs, B)
    assert (gfp.P25519, gfp.P_GOLDILOCKS) == (jgfp.P25519, jgfp.P_GOLDILOCKS)
    jair = JFp25519OpsAir()
    assert AIR.num_cols == jair.num_cols == 708
    assert AIR.lookup_range_columns() == jair.lookup_range_columns()
    for name in ("mul", "cmul"):
        got, want = getattr(AIR, name), getattr(jair, name)
        assert (got.c, got.q, got.LQ, got.n_coeffs) == (want.c, want.q,
                                                        want.LQ, want.n_coeffs)
        assert (got.chain.ul, got.chain.off_bits, got.chain.top_scale) == (
            want.chain.ul, want.chain.off_bits, want.chain.top_scale)
    for name in ("add", "sub"):
        got, want = getattr(AIR, name), getattr(jair, name)
        assert (got.d, got.s_bit, got.chain.ul) == (want.d, want.s_bit,
                                                   want.chain.ul)


def test_witness_matches_int_oracle():
    rng = np.random.default_rng(31)
    a_vals = [int.from_bytes(rng.bytes(32), "little") % gfp.P25519
              for _ in range(4)]
    b_vals = [int.from_bytes(rng.bytes(32), "little") % gfp.P25519
              for _ in range(4)]
    _, _, outs = AIR.witness(a_vals * (N // 4), b_vals * (N // 4))
    for i in range(4):
        a, b = a_vals[i], b_vals[i]
        expect = (((a * b) % gfp.P25519 + a) % gfp.P25519 - b) % gfp.P25519
        assert outs[i] == expect * D_CONST % gfp.P25519


def test_witness_equals_reference(jax_case):
    cols, publics, outs = AIR.witness(*INPUTS)
    assert outs == jax_case["outs"]
    assert publics == jax_case["publics"]
    assert rd.array(gl.to_u64(gl.to_fp(cols, "cpu"))) == jax_case["trace"]


def test_prove_verify_fp_ops_matches_reference(jax_case):
    trace, pubs, _ = _port_case()
    proof = prover.prove(AIR, trace, pubs, CFG)
    assert verifier.verify(AIR, proof, pubs, LOG_N, CFG)
    assert CFG == prover.StarkConfig(**inputs.FP_CFG)
    want = jax_case["payload"]
    assert rd.payload_fields(serialize.payload(proof), want) == want["fields"]
    # tampering one product limb must fail
    bad = trace.clone()
    bad[AIR.mul.c[3], 7] = (bad[AIR.mul.c[3], 7] + 1) % 256
    proof2 = prover.prove(AIR, bad, pubs, CFG)
    assert not verifier.verify(AIR, proof2, pubs, LOG_N, CFG)


def test_out_of_range_limb_rejected():
    """A 9-bit limb forged into the witness is caught by the lookup."""
    trace, pubs, _ = _port_case()
    bad = trace.clone()
    bad[AIR.mul.q[2], 5] += 256
    proof = prover.prove(AIR, bad, pubs, CFG)
    assert not verifier.verify(AIR, proof, pubs, LOG_N, CFG)
