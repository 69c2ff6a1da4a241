"""A run with its timed path broken underneath must come out not correct:
the control (proofs at a weaker configuration than the cell states) and
each fault a cell can have. The runs skip the look for a card and work on
the CPU, at sizes a test run holds (``tiny.py``); the sound run of each
tiny cell comes out correct."""

import time

import pytest
import torch

from vxbench import faults, run
from vxbench.tests.tiny import make_cell

CPU = torch.device("cpu")


def measure(cell, seed=2 ** 31 + 17):
    torch.set_num_threads(2)
    return run.measure(cell, seed, 0.0, False, CPU, lambda: None,
                       time.perf_counter())


@pytest.fixture
def chains(tmp_path):
    return make_cell(tmp_path, "chains")


def test_sound_run_is_correct(chains):
    line = measure(chains)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    # a cell that no metric's ``workloads`` names: the metrics without one
    assert set(line["metrics"]) == {"prove_s", "setup_s"}


@pytest.mark.parametrize("fault,caught_by", [
    ("control", "config_mismatch"),
    ("answer_altered", "publics_mismatch"),
    ("half_batch_dropped", "publics_mismatch"),
    ("state_unchanged", "verify_rejected"),
    ("proof_altered", "verify_rejected"),
    ("verifier_accepts_all", "tampered_accepted"),
    ("verifier_skips_ali", "false_accepted"),
])
def test_fault_is_caught(chains, fault, caught_by):
    with faults.planted(fault, chains):
        line = measure(chains)
    assert not line["correct"]
    assert line["checks"][caught_by]["value"] > line["checks"][caught_by][
        "limit"]


@pytest.mark.parametrize("fault,caught_by", [
    (None, None), ("half_batch_dropped", "publics_mismatch"),
    ("verifier_skips_ali", "false_accepted")])
def test_signature_shards(tmp_path, fault, caught_by):
    """The Ed25519 job kind at B = 8 (one lane a shard): sound; with the
    first half of each shard's lanes kept (none of one lane); with a
    verifier that leaves out the constraints at ζ, which accepts the
    lane that claims h + 1."""
    cell = make_cell(tmp_path, "shards")
    if fault is None:
        line = measure(cell)
        assert line["correct"], line["checks"]
        return
    with faults.planted(fault, cell):
        line = measure(cell)
    assert line["checks"][caught_by]["value"] >= 1
    assert not line["correct"]
