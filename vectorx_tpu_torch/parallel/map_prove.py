"""Data-parallel proving — the MapReduce dispatch layer.

VectorX distributes its MapReduce leaf proofs (8-header map jobs) across
machines and joins them with reduce circuits that recursively verify
pairs. Here:

- **map** (``prove_many``): one proof instance per device (round-robin
  over a list of torch devices; on one card every instance goes to it);
  ``prove_headers_procs`` scatters the per-header proofs of a
  ``header_range`` bundle over worker PROCESSES;
- **reduce** (``map_reduce_prove``): the shard proofs collapse to ONE
  proof through an in-AIR reduce node (stark/recursion_air.py via
  parallel/aggregate.py) that verifies every child and links their
  boundary publics.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from .. import default_device
from ..stark import prover, verifier
from ..stark.air import Air


def prove_many(air: Air, traces: Sequence, publics: Sequence,
               config: prover.StarkConfig,
               devices: Optional[List] = None) -> List[prover.StarkProof]:
    """Prove k independent instances, one per device (round-robin; the
    current CUDA device when ``devices`` is None).

    traces[i]: (num_cols, N) Fp; publics[i]: list of scalar Fp.
    """
    devices = [default_device(d) for d in (devices or [None])]
    proofs = []
    for i, (trace, pubs) in enumerate(zip(traces, publics)):
        dev = devices[i % len(devices)]
        proofs.append(prover.prove(air, trace.to(dev),
                                   [p.to(dev) for p in pubs], config))
    return proofs


def _run_workers(commands: Sequence[Sequence[str]], env: dict, log_dir: str,
                 timeout_s: float) -> List[str]:
    """Run worker processes side by side, each writing its stdout and
    stderr to a log file of its own (so no worker waits on a full pipe),
    until all exit or ``timeout_s`` passes. -> one error line per failed
    worker (its exit code and the end of its log)."""
    workers = []
    for p, cmd in enumerate(commands):
        path = os.path.join(log_dir, f"worker{p}.log")
        with open(path, "wb") as log:
            workers.append((subprocess.Popen(
                list(cmd), env=env, stdout=log, stderr=subprocess.STDOUT),
                path))
    deadline = time.monotonic() + timeout_s
    errs = []
    for p, (w, path) in enumerate(workers):
        try:
            w.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            w.kill()
            w.wait()
            errs.append(f"worker {p}: timeout after {timeout_s}s")
            continue
        if w.returncode != 0:
            with open(path, "rb") as log:
                tail = log.read()[-500:].decode(errors="replace")
            errs.append(f"worker {p}: rc={w.returncode}: {tail}")
    return errs


def prove_headers_procs(headers: Sequence[bytes], max_chunks: int,
                        config: prover.StarkConfig, checkpoint_dir: str,
                        procs: int, timeout_s: float = 3600.0,
                        device=None) -> None:
    """Scatter the per-header map proofs across worker PROCESSES.

    Each worker process (``python -m vectorx_tpu_torch.parallel.map_worker
    job.json``) proves a round-robin shard of the headers on ``device``
    (the current CUDA device unless named: the workers share the card)
    and hands the artifacts back through the content-addressed checkpoint
    store — after this returns, ``statements.prove_header_range`` with the
    same checkpoint dir hits every header proof. Coordination is process
    exit codes (a non-zero worker raises with the end of its log), not
    sentinel files. The job-file + checkpoint format is the seam where a
    multi-host deployment would dispatch remotely.
    """
    import binascii
    import json
    import tempfile

    from ..stark import serialize

    device = default_device(device)
    procs = max(1, min(procs, len(headers)))
    cfg_hex = binascii.hexlify(serialize.serialize_config(config)).decode()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    if device.type == "cpu" and "OMP_NUM_THREADS" not in env:
        # the workers prove side by side: share the host's cores
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // procs))
    with tempfile.TemporaryDirectory(prefix="vx_map_") as td:
        commands = []
        for p in range(procs):
            shard = [binascii.hexlify(h).decode()
                     for h in headers[p::procs]]
            job = {"kind": "header", "headers": shard,
                   "max_chunks": max_chunks, "config": cfg_hex,
                   "checkpoint": checkpoint_dir, "device": str(device)}
            jf = os.path.join(td, f"job{p}.json")
            with open(jf, "w") as f:
                json.dump(job, f)
            commands.append([sys.executable, "-m",
                             "vectorx_tpu_torch.parallel.map_worker", jf])
        errs = _run_workers(commands, env, td, timeout_s)
        if errs:
            raise RuntimeError("map-proof dispatch failed: "
                               + "; ".join(errs))


def verify_many(air: Air, proofs: Sequence, publics: Sequence, log_n: int,
                config: prover.StarkConfig) -> bool:
    return all(bool(verifier.verify(air, pf, pubs, log_n, config))
               for pf, pubs in zip(proofs, publics))


def map_reduce_prove(air: Air, traces: Sequence, publics: Sequence,
                     layout, config: prover.StarkConfig,
                     outer_config: Optional[prover.StarkConfig] = None,
                     devices: Optional[List] = None):
    """Map-prove every shard, then REDUCE to one proof.

    ``layout``: aggregate.ChainLayout naming each shard claim's start/end
    public slots; adjacent shards are linked end_i == start_{i+1} inside
    the reduce node, which is proved on the first device. Returns an
    aggregate.Node whose single proof verifies every shard and the chain
    adjacency (check with aggregate.verify_aggregate)."""
    from . import aggregate as agg
    proofs = prove_many(air, traces, publics, config, devices)
    log_n = traces[0].shape[-1].bit_length() - 1
    nodes = [agg.Node(air=air, proof=p, publics=list(pu), log_n=log_n,
                      config=config, layout=layout)
             for p, pu in zip(proofs, publics)]
    return agg.aggregate_chain(nodes, outer_config or config,
                               device=proofs[0].trace_cap.device)
