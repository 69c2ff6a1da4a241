"""Port vs reference: MerkleSha256Air of 4 leaves, 1024 rows.

The cases and the checks are in test_torch_statement_airs.py; this AIR has
a file of its own, so that its JAX prove runs on a worker of its own.
"""

import pytest

from vectorx_tpu_torch.stark import air_sha256_merkle as merkle

import test_torch_statement_airs as common

NAME = "sha256_merkle"


def test_trace_constants_publics_equal_reference():
    common.check_trace_constants_publics(NAME)


def test_check_constraints_accepts_honest_trace():
    common.check_honest_trace(NAME)


@pytest.mark.parametrize("tamper", common.TAMPERS[NAME])
def test_check_constraints_rejects_tampered_trace(tamper):
    common.check_tampered_trace(NAME, tamper)


def test_payload_parity_with_reference():
    common.check_payload_parity(NAME)


def test_post_order_of_the_production_tree():
    assert len(merkle._post_order(256)) == 255
    assert merkle.MerkleSha256Air([[0] * 8] * 256).n_rows == 65536
