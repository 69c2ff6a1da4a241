"""Two-process demo of the multi-host tier (torch.distributed).

    python -m vectorx_tpu_torch.parallel.dcn_demo <port> <pid> [<handoff_dir>]
        [--device DEV] [--backend gloo|nccl] [--processes N]

Each process holds a local mesh of 4 shards of one device (``--device``,
the card by default); the global mesh is (dcn=N, batch=4), N processes
(default 2) joined over ``tcp://localhost:<port>``.

1. A 16-header chain, sharded host-first over both tiers: each process
   verifies its 16/N headers on its local shards, and one ``all_gather``
   of a 164-byte record per process completes the links across the
   process boundary and the two range trees. Process 0 prints
   ``DCN_DEMO_OK <state_root_hex>`` (the root's u32 words, each little
   endian, as the JAX package's demo prints them).
2. With a handoff directory (two processes): each process proves its
   ``FibonacciAir(16)`` shard of a two-shard chain with
   ``map_prove.prove_many`` on its local devices and writes the proof
   through the directory; process 0 reduces both into one proof
   (``aggregate.aggregate_chain``), checks it with ``verify_aggregate``
   and prints ``DCN_MAP_OK``. Process 1 waits for ``reduce.done``.

Every process prints ``DCN_BACKEND <backend>``. Any failure exits
non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..circuits import scale
from . import multihost, subchain
from .mesh import Mesh

N_HEADERS = 16
LOCAL_SHARDS = 4
SLOT_BYTES = 256
FIB_ROWS = 16
WAIT_S = 600


def demo_chain():
    """The deterministic 16-header chain every process builds: (headers,
    trusted hash)."""
    rng = np.random.default_rng(0)
    trusted = bytes(32)
    headers, parent = [], trusted
    for i in range(N_HEADERS):
        body = parent + scale.encode_compact_u32(1 + i) + bytes(32)
        header = body + bytes(rng.integers(0, 256, 96, dtype=np.uint8)) \
            + bytes(32)
        headers.append(header)
        parent = hashlib.blake2b(header, digest_size=32).digest()
    return headers, trusted


def root_hex(words: torch.Tensor) -> str:
    return np.asarray(words.cpu().numpy(), dtype="<u4").tobytes().hex()


def phase_chain(mesh, dev) -> tuple:
    """-> (ok, the state root's hex) of the sharded 16-header check."""
    headers, trusted = demo_chain()
    buf, sizes = subchain.pack_headers(headers, N_HEADERS, SLOT_BYTES)
    res = subchain.verify_subchain(
        torch.from_numpy(buf).to(dev), torch.from_numpy(sizes).to(dev),
        N_HEADERS, torch.frombuffer(bytearray(trusted), dtype=torch.uint8),
        0, mesh=mesh)
    ok = bool(res.links_ok) and bool(res.blocks_sequential)
    return ok, root_hex(res.state_root_words)


def fib_shards(dev):
    """Two chained FibonacciAir(16) traces (B starts where A ends) and
    their publics."""
    from ..field import goldilocks as gl
    from ..stark.air import FibonacciAir
    trace_a, pub_a = FibonacciAir.make_trace(FIB_ROWS, device=dev)
    a_last, b_last = (int(v) for v in gl.from_fp(trace_a[:, -1].cpu()))
    trace_b, pub_b = FibonacciAir.make_trace(FIB_ROWS, a_last, b_last,
                                             device=dev)
    return [trace_a, trace_b], [pub_a, pub_b]


def wait_for(path: str, seconds: float) -> bool:
    deadline = time.time() + seconds
    while not os.path.exists(path):
        if time.time() > deadline:
            return False
        time.sleep(0.2)
    return True


def phase_map(mesh, dev, handoff: str) -> bool:
    """Prove this process's shard, hand it over; process 0 reduces and
    verifies. -> whether this process's part held."""
    from ..field import goldilocks as gl
    from ..stark import prover, serialize
    from ..stark.air import FibonacciAir
    from . import aggregate as agg
    from . import map_prove

    air = FibonacciAir()
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
    log_n = FIB_ROWS.bit_length() - 1
    traces, pubs = fib_shards(dev)
    mine = mesh.rank
    pubs_fp = [gl.to_fp(p, dev) for p in pubs[mine]]
    proof = map_prove.prove_many(air, [traces[mine]], [pubs_fp], cfg,
                                 devices=list(mesh.local.devices))[0]
    tmp = os.path.join(handoff, f"shard{mine}.bin.tmp")
    with open(tmp, "wb") as f:
        f.write(serialize.serialize_proof(proof))
    os.replace(tmp, os.path.join(handoff, f"shard{mine}.bin"))
    done = os.path.join(handoff, "reduce.done")
    if mine != 0:
        # stay in the group until process 0 has reduced
        return wait_for(done, WAIT_S)
    if not wait_for(os.path.join(handoff, "shard1.bin"), WAIT_S):
        print("DCN_MAP_FAIL timeout", flush=True)
        return False
    like = serialize.empty_proof_like_shapes(air, cfg, log_n)
    with open(os.path.join(handoff, "shard1.bin"), "rb") as f:
        proof_b = serialize.deserialize_proof(f.read(), like, dev)
    layout = agg.ChainLayout(start=(0,), end=(2,))
    nodes = [agg.Node(air=air, proof=p, publics=list(pu), log_n=log_n,
                      config=cfg, layout=layout)
             for p, pu in ((proof, pubs[0]), (proof_b, pubs[1]))]
    node = agg.aggregate_chain(nodes, cfg, device=dev)
    shapes = [(air, log_n, cfg, 3), (air, log_n, cfg, 3)]
    ok = agg.verify_aggregate(node, shapes, [(0, 2, 1, 0)], [(0, 0), (1, 2)])
    print("DCN_MAP_OK" if ok else "DCN_MAP_FAIL", flush=True)
    with open(done, "w") as f:
        f.write("1")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vectorx_tpu_torch.parallel.dcn_demo")
    ap.add_argument("port", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("handoff", nargs="?")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--processes", type=int, default=2)
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = multihost.init_distributed(
        f"localhost:{args.port}", args.processes, args.pid, args.backend, dev)
    print(f"DCN_BACKEND {backend}", flush=True)
    try:
        mesh = multihost.dcn_mesh(Mesh([dev] * LOCAL_SHARDS))
        ok, root = phase_chain(mesh, dev)
        if args.pid == 0:
            print(("DCN_DEMO_OK " + root) if ok else "DCN_DEMO_FAIL",
                  flush=True)
        if args.handoff is not None:
            if args.processes != 2:
                raise SystemExit("the map phase runs on two processes")
            ok = phase_map(mesh, dev, args.handoff) and ok
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
