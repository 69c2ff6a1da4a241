"""On the card, at each cell's own size: the control (proofs at a weaker
configuration than the cell states) over a window of the cell's length
comes out not correct, on three seeds. Each run prints its compared
numbers. Skips where there is no card.

    python3 -m pytest vxbench/tests -m cuda -s
"""

import json
import time

import pytest
import torch

from vxbench import faults, run, spec

pytestmark = pytest.mark.cuda

BENCH = spec.load_benchmark()
SEEDS = (3141592653, 2718281828, 1414213562)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(card, name, seed):
    cell = spec.Cell(BENCH, name)
    with faults.planted("control", cell):
        line = run.measure(cell, seed, BENCH["run_seconds"], False, card,
                           torch.cuda.synchronize, time.perf_counter())
    print(json.dumps({"control": name, "seed": seed,
                      "attempted": line["attempted"],
                      "checks": line["checks"]}))
    assert not line["correct"]
