"""Occupancy variants of the thread-per-state Poseidon kernels, timed.

Builds csrc/poseidon.cu with ``-DVX_PERMUTE_MIN_BLOCKS=k
-DVX_SPONGE_MIN_BLOCKS=k`` for k = 1..4 (the second argument of
``__launch_bounds__(128, k)``: the compiler caps the registers per thread
so that k blocks of 128 fit on an SM), prints ptxas'
register and spill lines for ``permute_kernel`` and ``sponge_rows_kernel``,
checks each build against the default one bit for bit, and times by CUDA
events ``permute`` at 131072 and 16384 states and ``sponge_rows`` on a
(799, 16384) column-major matrix. The variants are timed in the order
1, 2, 3, 4, 4, 3, 2, 1 within one process, so they share a card.

Run on a card, from the root of a checkout:

    python -m vectorx_tpu_torch.ops.poseidon_variants

The values kept in the source are the defaults of the two macros there.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..field import goldilocks as gl
from . import poseidon_cuda as pc

VARIANTS = (1, 2, 3, 4)
SHAPES = (131072, 16384)
SPONGE_SHAPE = (799, 16384)


def _event_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_lines(log: str):
    """(kernel, registers/spill text) for the two thread-per-state kernels."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in ("sponge_rows_kernel", "permute_kernel")
                         if k in line), None)
        elif name and ("spill" in line or "registers" in line):
            out.append((name, line.strip()))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("poseidon_variants: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(5)
    states = torch.from_numpy(rng.integers(
        0, gl.MODULUS, (max(SHAPES), 12), dtype=np.uint64).view(np.int64)).to(dev)
    cols = torch.from_numpy(rng.integers(
        0, gl.MODULUS, SPONGE_SHAPE, dtype=np.uint64).view(np.int64)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    want_perm = pc._permute(states, False)
    want_leaf = pc._sponge_rows(cols.t(), False)

    libs = {}
    for k in VARIANTS:
        libs[k] = pc.bind(pc.build([f"-DVX_PERMUTE_MIN_BLOCKS={k}",
                                    f"-DVX_SPONGE_MIN_BLOCKS={k}"]))
        if libs[k].vx_poseidon_min_blocks() != 101 * k:
            raise RuntimeError(f"variant {k} was not built with its flag")
        pc.upload_constants(libs[k], dev)
        for name, text in _ptxas_lines(pc.build_log):
            print(f"min_blocks={k} {name}: {text}")

    def permute(lib, x):
        out = torch.empty_like(x)
        pc.check(lib.vx_poseidon_permute(x.data_ptr(), out.data_ptr(),
                                          x.shape[0], stream), "permute")
        return out

    def sponge(lib):
        w, n = cols.shape
        out = torch.empty((n, 4), dtype=torch.int64, device=dev)
        pc.check(lib.vx_poseidon_sponge_rows(cols.data_ptr(), n, w, 1, n,
                                              out.data_ptr(), stream), "sponge")
        return out

    for k in VARIANTS:
        if not (torch.equal(permute(libs[k], states), want_perm)
                and torch.equal(sponge(libs[k]), want_leaf)):
            raise AssertionError(f"variant {k} differs from the default build")
    for k in VARIANTS + VARIANTS[::-1]:
        lib = libs[k]
        times = {f"permute_{n}_ms": _event_ms(
            lambda: permute(lib, states[:n]), 50) for n in SHAPES}
        times["sponge_rows_799x16384_ms"] = _event_ms(lambda: sponge(lib), 5)
        print(f"min_blocks={k} " + " ".join(
            f"{name}={ms:.4f}" for name, ms in times.items()), flush=True)


if __name__ == "__main__":
    main()
