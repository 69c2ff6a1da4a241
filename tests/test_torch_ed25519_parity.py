"""Port vs reference: the full Ed25519VerifyAir(B = 8) proof, payload for
payload (tolerance 0), for the signed lane of test_torch_ed25519_air.py at
rate_bits=1, num_queries=2, final_poly_len=4, pow_bits=0.

Marked slow: the JAX prove of this AIR takes about 11 minutes on a CPU,
so the tier-1 run leaves it out. What fixes the payload in tier-1 is held
there instead (trace, constants, publics and the constraint program equal,
the prover core at payload parity).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ed25519_parity.py -m slow
"""

import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.stark import air_ed25519 as jed
from vectorx_tpu.stark import prover as jprover
from vectorx_tpu.stark import serialize as jserialize
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import air_ed25519 as ped
from vectorx_tpu_torch.stark import prover, serialize, verifier

from test_torch_ed25519_air import LANES

torch.set_num_threads(1)

CFG = dict(rate_bits=1, num_queries=2, final_poly_len=4, pow_bits=0)


@pytest.mark.slow
def test_ed25519_payload_parity_with_reference():
    jair = jed.Ed25519VerifyAir([LANES["signed"]], B=8)
    jtrace, _ = jair.make_trace_vec()
    jpubs = [jgl.to_fp(p) for p in jair.publics_list()]
    jproof = jprover.prove(jair, jtrace, jpubs, jprover.StarkConfig(**CFG))
    want = serialize.split_payload(jserialize.serialize_proof(jproof))

    air = ped.Ed25519VerifyAir([LANES["signed"]], B=8)
    trace, publics = air.make_trace_vec("cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    proof = prover.prove(air, trace, pubs, prover.StarkConfig(**CFG))
    assert serialize.payload(proof) == want
    assert verifier.verify(air, proof, pubs, 8, prover.StarkConfig(**CFG))
