"""The port prover's memory tiling gives the same proof bytes.

The quotient's constraint evaluation runs over row windows of the LDE
domain (``prover._row_window``), and the LDE, the ζ openings and the DEEP
composition over blocks of columns (``prover._col_tile``); both sizes
follow from the shapes and the device's free memory. Field sums are exact,
so every tiling must give the payload of one whole pass (here on the CPU,
where the small shapes below fit in one window). The analogue of
tests/test_quotient_rowtile.py, for a plain AIR (FibonacciAir), a LogUp
AIR, a RAM AIR and a constant-column AIR (the three of
test_torch_lookup.py), each at window sizes from 8 rows (every window
wraps its next-row reach at the last) to half the domain, with one
column a block. Tolerance: byte equality.
"""

import numpy as np
import pytest
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.poly import ntt
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import Air, FibonacciAir

from oracle import P
from test_torch_lookup import CASES, CFG

torch.set_num_threads(1)

AIRS = ["fib"] + list(CASES)


def _prove(name):
    if name == "fib":
        air = FibonacciAir()
        trace, publics = FibonacciAir.make_trace(32, device="cpu")
        log_n = 5
    else:
        make, (vals, publics), log_n = CASES[name]
        air = make(Air)
        trace = gl.to_fp(vals, "cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    cfg = prover.StarkConfig(**CFG)
    return air, prover.prove(air, trace, pubs, cfg), pubs, log_n, cfg


@pytest.fixture(scope="module")
def whole():
    """Each AIR's payload with the default sizes (one window, one block)."""
    return {name: serialize.payload(_prove(name)[1]) for name in AIRS}


@pytest.mark.parametrize("window", [8, 32, 64])
@pytest.mark.parametrize("name", AIRS)
def test_tiled_proof_bytes_equal_whole_pass(name, window, whole, monkeypatch):
    n_lde = 32 << CFG["rate_bits"]
    assert window < n_lde
    monkeypatch.setattr(prover, "_row_window",
                        lambda n_lde, width, kk2, device: window)
    monkeypatch.setattr(prover, "_col_tile",
                        lambda n_cols, n, temps, device: 1)
    air, proof, pubs, log_n, cfg = _prove(name)
    assert serialize.payload(proof) == whole[name]
    assert verifier.verify(air, proof, pubs, log_n, cfg)


def test_window_and_tile_sizes():
    """A window is a power of two dividing the domain, at least 1024 rows
    where the domain has them, and shrinks as the working set per row
    grows; a block is at least one column."""
    cpu = torch.device("cpu")
    for n_lde in (64, 1 << 12, 1 << 21):
        for width, kk2 in ((2, 0), (1072, 0), (6524, 1591)):
            b = prover._row_window(n_lde, width, kk2, cpu)
            assert b & (b - 1) == 0 and n_lde % b == 0
            assert b >= min(n_lde, 1024)
    assert (prover._row_window(1 << 21, 6524, 1591, cpu)
            < prover._row_window(1 << 21, 2, 0, cpu))
    assert prover._row_window(64, 2, 0, cpu) == 64
    assert prover._col_tile(5000, 1 << 21, 32, cpu) >= 1
    assert prover._col_tile(3, 64, 32, cpu) == 3


def test_lde_cols_equals_coset_lde(monkeypatch):
    rng = np.random.default_rng(3)
    x = gl.to_fp(rng.integers(0, P, (5, 64), dtype=np.uint64), "cpu")
    want = ntt.coset_lde(x, 2)
    monkeypatch.setattr(prover, "_col_tile", lambda n_cols, n, temps, device: 2)
    assert torch.equal(prover.lde_cols(x, 2), want)
