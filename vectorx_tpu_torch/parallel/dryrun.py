"""A dry run of the collective layer on a mesh of one device's shards.

``dryrun_multichip(n)`` runs three phases on ``Mesh([device] * n)`` (the
card by default) and raises if one fails:

1. the sharded subchain check of a 2n-header chain: its links hold and
   every field equals the single-device check's;
2. the batched sharded NTT of four random 2^8-point polynomials, equal to
   ``poly/ntt.ntt``;
3. a ``FibonacciAir(2^6)`` proof with ``ntt_ops=ShardedNttOps(mesh)`` at
   rate 1, 2 queries: verified, and the same bytes as the unsharded
   proof.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import default_device
from ..circuits import scale
from ..field import goldilocks as gl
from ..poly import ntt as pntt
from . import ntt_dist, subchain
from .mesh import Mesh

SLOT_BYTES = 256


def dryrun_chain(n: int):
    """n chained headers of 128 bytes or more (random filler, a zero state
    root, the data root in the last 32 bytes)."""
    rng = np.random.default_rng(0)
    headers, parent = [], bytes(32)
    for i in range(n):
        body = parent + scale.encode_compact_u32(1 + i) + bytes(32)
        filler = bytes(rng.integers(0, 256, 128 - len(body) % 128,
                                    dtype=np.uint8))
        header = (body + filler)[:max(len(body) + 32, 128)]
        headers.append(header)
        parent = hashlib.blake2b(header, digest_size=32).digest()
    return headers


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """-> {"subchain": SubchainResult, "ntt": the sharded NTT's output,
    "proof": the sharded-NTT proof}. Prints one line per phase."""
    from ..stark import prover, serialize, verifier
    from ..stark.air import FibonacciAir
    dev = default_device(device)
    mesh = Mesh([dev] * n_devices)

    tree_size = 2 * n_devices
    buf, sizes = subchain.pack_headers(dryrun_chain(tree_size), tree_size,
                                       SLOT_BYTES)
    args = (torch.from_numpy(buf).to(dev), torch.from_numpy(sizes).to(dev),
            tree_size, torch.zeros(32, dtype=torch.uint8, device=dev), 0)
    res = subchain.verify_subchain(*args, mesh=mesh)
    if not bool(res.links_ok):
        raise AssertionError("multichip dry run: link check failed")
    if not all(torch.equal(a, b) for a, b in
               zip(res, subchain.verify_subchain(*args))):
        raise AssertionError("multichip dry run: sharded subchain != one device")
    print(f"dryrun phase 1 OK: sharded subchain verification "
          f"({tree_size} headers over {n_devices} shards)", flush=True)

    rng = np.random.default_rng(1)
    x = gl.to_fp(rng.integers(0, gl.MODULUS, (4, 1 << 8),
                              dtype=np.uint64).astype(object), dev)
    got = ntt_dist.ntt_sharded(x, mesh)
    if not torch.equal(got, pntt.ntt(x)):
        raise AssertionError("multichip dry run: NTT mismatch")
    print("dryrun phase 2 OK: batched sharded NTT parity", flush=True)

    log_n = 6
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
    air = FibonacciAir()
    trace, publics = FibonacciAir.make_trace(1 << log_n, device=dev)
    pubs = [gl.to_fp(p, dev) for p in publics]
    ops = ntt_dist.ShardedNttOps(mesh)
    proof = prover.prove(air, trace, pubs, cfg, ntt_ops=ops)
    if not verifier.verify(air, proof, pubs, log_n, cfg):
        raise AssertionError("multichip dry run: the sharded-NTT proof "
                             "failed to verify")
    if serialize.serialize_proof(proof) != serialize.serialize_proof(
            prover.prove(air, trace, pubs, cfg)):
        raise AssertionError("multichip dry run: the sharded-NTT proof != "
                             "the unsharded one")
    print("dryrun phase 3 OK: sharded-NTT prove (trace and quotient) "
          "verified, equal to the unsharded proof", flush=True)
    return {"subchain": res, "ntt": got, "proof": proof}
