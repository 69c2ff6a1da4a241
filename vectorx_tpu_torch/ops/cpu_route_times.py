"""CPU seconds of one prove through Poseidon's two CPU routes.

On a CPU tensor the port's Poseidon entries take a host route: numpy
rounds for ``permute`` and ``hash_many`` (``permute_np``,
``hash_many_np``) and Python ints for a transcript's one state
(``duplex_ints``); the torch rounds (``permute_plain``,
``hash_many_plain``, ``duplex_plain``) stay the reference the CUDA
kernels are held against. This script proves ``HeaderAir(max_chunks=2)``
(rate 2, 6 queries, final polynomial 4, pow 8: the small proof of
``chip_smoke.py``) on the CPU through each route, in the order host,
torch, torch, host, checks that the payloads are equal and prints the
seconds of each prove. It is a CPU measurement, not a device one:

    python -m vectorx_tpu_torch.ops.cpu_route_times
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..field import goldilocks as gl
from ..hashes import poseidon as ps
from ..stark import air_header as ah
from ..stark import prover, serialize

HOST = {"permute": ps.permute, "hash_many": ps.hash_many, "duplex": ps.duplex}
TORCH = {"permute": ps.permute_plain, "hash_many": ps.hash_many_plain,
         "duplex": ps.duplex_plain}


def prove_seconds(routes: dict, air, trace, publics, cfg):
    """-> (payload, seconds) of one CPU prove with Poseidon's entries
    taken from `routes`."""
    saved = {name: getattr(ps, name) for name in routes}
    for name, fn in routes.items():
        setattr(ps, name, fn)
    try:
        t0 = time.perf_counter()
        payload = serialize.payload(prover.prove(air, trace, publics, cfg))
        return payload, time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(ps, name, fn)


def main() -> None:
    torch.set_num_threads(1)
    air = ah.HeaderAir(max_chunks=2)
    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
    rng = np.random.default_rng(7)
    msg = bytes(rng.integers(0, 256, 200, dtype=np.uint8))
    trace, publics, _ = air.make_trace(msg, "cpu")
    pubs = [gl.to_fp(int(v), "cpu") for v in publics]
    runs = []
    for name, routes in (("host", HOST), ("torch", TORCH), ("torch", TORCH),
                         ("host", HOST)):
        payload, seconds = prove_seconds(routes, air, trace, pubs, cfg)
        runs.append((name, payload, seconds))
        print(f"[cpu-route] air=HeaderAir(2) route={name} prove_s={seconds:.3f}",
              flush=True)
    if len({payload for _, payload, _ in runs}) != 1:
        raise AssertionError("the two routes gave different payloads")
    best = {name: min(s for n, _, s in runs if n == name)
            for name in ("host", "torch")}
    print(f"[cpu-route] threads=1 host_s={best['host']:.3f} "
          f"torch_s={best['torch']:.3f} "
          f"torch_over_host={best['torch'] / best['host']:.2f}")


if __name__ == "__main__":
    main()
