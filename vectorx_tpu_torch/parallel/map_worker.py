"""Map-proof worker process — one shard of a statement's map phase.

The parent (parallel.map_prove.prove_headers_procs) writes a JSON job file
naming the units to prove, spawns ``python -m
vectorx_tpu_torch.parallel.map_worker job.json`` per shard, and the
finished proofs return through the content-addressed proof checkpoint
store (stark/checkpoint.py) — the same artifact format the CLI's
--checkpoint flag uses, so a re-run of the statement prover hits every
worker-produced proof.

Job file schema (the JAX package's, plus ``device``):
    {"kind": "header", "headers": [hex, ...], "max_chunks": N,
     "config": hex(serialize_config), "checkpoint": dir,
     "device": "cuda:0" | "cpu" | ...}

Exit code 0 = every unit proven and stored (or already present).
"""

from __future__ import annotations

import binascii
import json
import sys


def run_job(path: str) -> None:
    with open(path) as f:
        job = json.load(f)
    from .. import default_device
    from ..field import goldilocks as gl
    from ..stark import prover, serialize
    from ..stark.checkpoint import Checkpoint

    device = default_device(job.get("device"))
    cfg = serialize.deserialize_config(
        binascii.unhexlify(job["config"]), prover.StarkConfig)
    cp = Checkpoint(job["checkpoint"])
    kind = job["kind"]
    if kind == "header":
        from ..stark.air_header import HeaderAir
        max_chunks = int(job["max_chunks"])
        air = HeaderAir(max_chunks)
        for hex_h in job["headers"]:
            hdr = binascii.unhexlify(hex_h)
            parts = (hdr, str(max_chunks).encode())
            if cp.load("hdr", cfg, parts, air, device) is not None:
                continue                      # another worker got it first
            trace, publics, _ = air.make_trace(hdr, device)
            pubs = [gl.to_fp(int(p), device) for p in publics]
            proof = prover.prove(air, trace, pubs, cfg)
            cp.store("hdr", cfg, parts, proof, publics)
    else:
        raise SystemExit(f"unknown map-worker job kind: {kind!r}")


if __name__ == "__main__":
    run_job(sys.argv[1])
