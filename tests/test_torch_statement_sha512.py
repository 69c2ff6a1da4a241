"""Port vs reference: Sha512ChallengeAir(B=8): one lane, 256 rows, the
LogUp aux phase.

The cases and the checks are in test_torch_statement_airs.py; this AIR has
a file of its own, so that its JAX prove runs on a worker of its own.
"""

import pytest

from vectorx_tpu.stark import air_sha512 as j512
from vectorx_tpu_torch.circuits.ed25519 import L_ORDER
from vectorx_tpu_torch.stark import air_ed25519
from vectorx_tpu_torch.stark import air_sha512 as a512
from vectorx_tpu_torch.stark.air import check_constraints

import test_torch_statement_airs as common

NAME = "sha512"


def test_trace_constants_publics_equal_reference():
    common.check_trace_constants_publics(NAME)


def test_check_constraints_accepts_honest_trace():
    common.check_honest_trace(NAME)


@pytest.mark.parametrize("tamper", common.TAMPERS[NAME])
def test_check_constraints_rejects_tampered_trace(tamper):
    common.check_tampered_trace(NAME, tamper)


def test_payload_parity_with_reference():
    common.check_payload_parity(NAME)


def test_sha512_wrong_h_has_no_witness():
    a, r, s, h = common._lane(10)
    air = a512.Sha512ChallengeAir([(a, r, s, (h + 1) % L_ORDER)], common.MSG,
                                  B=8)
    with pytest.raises(AssertionError):
        air.make_trace("cpu")


def test_sha512_dummy_lanes():
    """An all-dummy AIR holds, and a shard-padding lane (dummy_sig, h = 0)
    maps to the AIR's own hash-consistent dummy, as in the reference."""
    air = a512.Sha512ChallengeAir([], common.MSG, B=8)
    trace, publics = air.make_trace("cpu")
    assert publics[0] == 0
    assert check_constraints(air, trace, common._port_pubs(publics))
    lanes = [common._lane(11), air_ed25519.dummy_sig()]
    air2 = a512.Sha512ChallengeAir(lanes, common.MSG, B=9)
    jair2 = j512.Sha512ChallengeAir(lanes, common.MSG, B=9)
    assert air2.publics_list() == jair2.publics_list()
    assert air2.lanes == jair2.lanes
