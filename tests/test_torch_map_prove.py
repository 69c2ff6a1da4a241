"""The port's map layer (parallel/map_prove.py, parallel/map_worker.py) on
the CPU, and the ``procs`` argument of the statements.

- ``prove_many`` / ``verify_many`` on a list of devices (here the CPU),
  as tests/test_map_prove.py: every instance proves and verifies;
  cross-wired publics are refused.
- ``prove_headers_procs`` with 2 CPU worker processes fills a checkpoint
  with one ``HeaderAir(2)`` proof per header, under the key
  ``prove_header_range`` looks up (its unit lookup hits without
  proving); a worker's proof equals the same header proved in process.
- Workers write their output to log files: two workers that each print
  600 KiB finish (a pipe holds 64 KiB), and a failing worker is reported
  with its exit code and the end of its log.
"""

import os
import sys

import numpy as np
import pytest
import torch

from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.parallel import map_prove
from vectorx_tpu_torch.stark import prover, serialize, statements, verifier
from vectorx_tpu_torch.stark.air import FibonacciAir
from vectorx_tpu_torch.stark.air_header import HeaderAir
from vectorx_tpu_torch.stark.checkpoint import Checkpoint

torch.set_num_threads(1)

LOG_N = 5
CFG = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4)
HDR_CFG = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
MAX_CHUNKS = 2


def _headers(k):
    """k SCALE headers: parent | compact(block number) | body | data root."""
    rng = np.random.default_rng(31)
    out = []
    for i in range(k):
        body = rng.bytes(32) + scale.encode_compact_u32(77 + i)
        out.append(body + rng.bytes(150 + 10 * i - len(body)))
    return out


def test_prove_many_and_verify_many():
    traces, pubs = [], []
    for i in range(3):
        t, p = FibonacciAir.make_trace(1 << LOG_N, a0=i, b0=i + 1,
                                       device="cpu")
        traces.append(t)
        pubs.append([gl.to_fp(x, "cpu") for x in p])
    proofs = map_prove.prove_many(FibonacciAir(), traces, pubs, CFG, ["cpu"])
    assert len(proofs) == 3
    assert all(p.trace_cap.device.type == "cpu" for p in proofs)
    assert map_prove.verify_many(FibonacciAir(), proofs, pubs, LOG_N, CFG)
    assert not map_prove.verify_many(FibonacciAir(), proofs,
                                     pubs[1:] + pubs[:1], LOG_N, CFG)


def test_prove_headers_procs_fills_the_checkpoint(tmp_path):
    headers = _headers(3)
    ckpt = str(tmp_path / "ckpt")
    map_prove.prove_headers_procs(headers, MAX_CHUNKS, HDR_CFG, ckpt, 2,
                                  timeout_s=600, device="cpu")
    cp = Checkpoint(ckpt)
    air = HeaderAir(MAX_CHUNKS)

    def no_prove():
        raise AssertionError("the checkpoint missed a worker's proof")

    for i, hdr in enumerate(headers):
        parts = (hdr, str(MAX_CHUNKS).encode())
        # prove_header_range's own unit lookup: a hit, no prove
        proof, publics = statements._prove_unit(cp, "hdr", HDR_CFG, parts,
                                                air, no_prove, "cpu")
        pubs = [gl.to_fp(int(p), "cpu") for p in publics]
        assert verifier.verify(air, proof, pubs, air.n_rows.bit_length() - 1,
                               HDR_CFG)
        if i == 0:
            trace, want_pubs, _ = air.make_trace(hdr, "cpu")
            assert [int(p) for p in want_pubs] == publics
            here = prover.prove(air, trace, pubs, HDR_CFG)
            assert serialize.payload(here) == serialize.payload(proof)


def test_chatty_workers_do_not_stall(tmp_path):
    chatty = [sys.executable, "-c",
              "import sys; sys.stdout.write('x' * 614400); "
              "sys.stderr.write('y' * 614400)"]
    env = dict(os.environ)
    assert map_prove._run_workers([chatty, chatty], env, str(tmp_path),
                                  timeout_s=120) == []
    assert os.path.getsize(tmp_path / "worker0.log") == 2 * 614400
    failing = [sys.executable, "-c",
               "import sys; print('the end of the log'); sys.exit(3)"]
    errs = map_prove._run_workers([chatty, failing], env, str(tmp_path),
                                  timeout_s=120)
    assert len(errs) == 1 and "worker 1: rc=3" in errs[0]
    assert "the end of the log" in errs[0]


def test_header_range_procs_needs_a_checkpoint():
    """As the JAX package: procs > 1 hands the map proofs over through a
    checkpoint, so it refuses to run without one."""
    with pytest.raises(AssertionError, match="checkpoint"):
        statements.prove_header_range(
            0, 1, _headers(1), [bytes(32)], [None], 1, 1, HDR_CFG,
            tree_size=2, max_chunks=MAX_CHUNKS, max_authorities=2,
            device="cpu", procs=2)
