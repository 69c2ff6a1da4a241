"""Smoke run of the PyTorch/CUDA port (vectorx_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure raises (non-zero exit, no final line):
  1. device   — a CUDA card, its name and power limit (nvidia-smi)
  2. build    — compile the Poseidon kernel from csrc/ (nvcc, sm_90a)
  3. poseidon — kernel == plain torch version on the card, bit for bit,
                at the main path's batch shapes (boundary rows included);
                kernel == permute_ints on 512 rows; kernel and plain rates
  4. small    — HeaderAir(max_chunks=2) proved on the card and on the CPU
                (plain path): identical proof payloads
  5. slice    — the Avail-header proof at full width: HeaderAir(16), a
                1990-byte header, rate 8, 28 queries, pow 16; one cold and
                three warm proves with a per-phase split, verify on the
                card, a tampered proof rejected
Then one JSON line of the kernels, the card's name and power limit, and
the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.ops import poseidon_cuda as pc
from vectorx_tpu_torch.stark import air_header as ah
from vectorx_tpu_torch.stark import fri, prover, serialize, verifier

HEADER_CHUNKS = 16
HEADER_BYTES = 1990
POSEIDON_BATCH = 131072          # bench.py's Poseidon batch
# the batch shapes the slice gives the kernel: the pow-16 grind batch, the
# bench batch, one absorb of leaf hashing at LDE 2^14, a tree level, the
# verifier's 28-query paths, one transcript state
PATH_SHAPES = ((fri._grind_batch(prover.PRODUCTION_POW_BITS), 12),
               (POSEIDON_BATCH, 12), (16384, 12), (8192, 12), (28, 12), (12,))


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def event_ms(fn, reps: int) -> float:
    """Device milliseconds per call (CUDA events, after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def boundary_states(rng, b: int, p: int) -> np.ndarray:
    """Random canonical states with rows biased to carry boundaries:
    p-1-k, k*(2^32-1), zero and [p-2^32, p) rows."""
    s = rng.integers(0, p, (b, 12), dtype=np.uint64)
    s[0::17] = np.uint64(p - 1) - rng.integers(0, 8, (len(s[0::17]), 12),
                                               dtype=np.uint64)
    s[1::29] = (rng.integers(0, 5, (len(s[1::29]), 12)).astype(np.uint64)
                * np.uint64(0xFFFFFFFF)) % np.uint64(p)
    s[2::31] = 0
    s[3::37] = np.uint64(p) - rng.integers(1, 1 << 32, (len(s[3::37]), 12),
                                           dtype=np.uint64)
    return s


def phase_poseidon(rng, dev):
    """Kernel against the plain torch rounds (bit for bit, max |diff| = 0
    is the tolerance) at every shape the slice launches it with."""
    rows = PATH_SHAPES[0][0]
    states_np = boundary_states(rng, rows, gl.MODULUS)
    states = torch.from_numpy(states_np.view(np.int64)).to(dev)
    max_err = 0
    for shape in PATH_SHAPES:
        n = int(np.prod(shape)) // 12
        x = states[:n].reshape(shape).contiguous()
        got = pc.permute(x)
        want = ps.permute_plain(x)
        diff = (gl.to_u64(got).astype(object) - gl.to_u64(want).astype(object))
        max_err = max(max_err, int(np.max(np.abs(diff))))
        if not torch.equal(got, want):
            bad = int((got != want).any(-1).sum()) if got.dim() > 1 else 1
            raise AssertionError(f"kernel != plain on {bad} of {n} rows, shape {shape}")
    got = gl.to_u64(pc.permute(states[:512]))
    for i in range(512):
        want = ps.permute_ints([int(v) for v in states_np[i]])
        if [int(v) for v in got[i]] != want:
            raise AssertionError(f"kernel != permute_ints on row {i}")
    bench = states[:POSEIDON_BATCH]
    leaf = states[:16384]
    ms = event_ms(lambda: pc.permute(bench), 50)
    plain_ms = event_ms(lambda: ps.permute_plain(bench), 3)
    leaf_ms = event_ms(lambda: pc.permute(leaf), 200)
    leaf_plain_ms = event_ms(lambda: ps.permute_plain(leaf), 5)
    log("poseidon", bit_equal_rows=rows,
        shapes="|".join("x".join(map(str, s)) for s in PATH_SHAPES),
        permute_ints_rows=512, max_abs_err=max_err,
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        kernel_perms_s=f"{POSEIDON_BATCH / ms * 1e3:.6g}",
        plain_perms_s=f"{POSEIDON_BATCH / plain_ms * 1e3:.6g}",
        leaf16384_kernel_ms=f"{leaf_ms:.4f}",
        leaf16384_plain_ms=f"{leaf_plain_ms:.4f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def make_header(rng, bn: int, size: int) -> bytes:
    """A random SCALE header: parent | compact(bn) | body | data root
    (the bench's header_proof generator)."""
    parent = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    body = parent + scale.encode_compact_u32(bn)
    body += bytes(rng.integers(0, 256, size - len(body) - 32, dtype=np.uint8))
    return body + bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def header_case(air, msg: bytes, dev):
    trace, publics, digest = air.make_trace(msg)
    if digest != hashlib.blake2b(msg, digest_size=32).digest():
        raise AssertionError("HeaderAir trace digest != hashlib blake2b")
    return trace.to(dev), [gl.to_fp(int(v), dev) for v in publics]


def phase_small(dev):
    air = ah.HeaderAir(max_chunks=2)
    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
    msg = make_header(np.random.default_rng(7), 77, 200)
    cuda_case = header_case(air, msg, dev)
    before = pc.launches
    t0 = time.perf_counter()
    on_card = serialize.payload(prover.prove(air, *cuda_case, cfg))
    t_card = time.perf_counter() - t0
    launched = pc.launches - before
    t0 = time.perf_counter()
    on_cpu = serialize.payload(prover.prove(air, *header_case(air, msg, "cpu"), cfg))
    t_cpu = time.perf_counter() - t0
    if on_card != on_cpu:
        raise AssertionError("HeaderAir(2) payloads differ between CUDA and CPU")
    if launched <= 0:
        raise AssertionError("the CUDA prove launched no Poseidon kernel")
    log("small", air="HeaderAir(2)", payload_bytes=len(on_card),
        identical=True, kernel_launches=launched, cuda_s=f"{t_card:.3f}",
        cpu_s=f"{t_cpu:.3f}")


def phase_slice(dev):
    rng = np.random.default_rng(3)
    air = ah.HeaderAir(max_chunks=HEADER_CHUNKS)
    log_n = air.n_rows.bit_length() - 1
    cfg = prover.StarkConfig(rate_bits=3, num_queries=28, final_poly_len=8,
                             pow_bits=prover.PRODUCTION_POW_BITS)
    cases = [header_case(air, make_header(rng, 1000 + i, HEADER_BYTES), dev)
             for i in range(3)]

    def timed_prove(case):
        split = {}
        last = [time.perf_counter()]

        def mark(phase):
            torch.cuda.synchronize()
            now = time.perf_counter()
            split[phase] = now - last[0]
            last[0] = now

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prover.prove(air, *case, cfg, timer=mark)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0, split

    _, cold, _ = timed_prove(cases[0])
    warm = [timed_prove(c) for c in cases]
    best = min(range(3), key=lambda i: warm[i][1])
    proof, best_s, split = warm[best]
    log("slice", air=f"HeaderAir({HEADER_CHUNKS})", rows=air.n_rows,
        cols=air.num_cols, header_bytes=HEADER_BYTES, cold_s=f"{cold:.4f}",
        warm_s=",".join(f"{w[1]:.4f}" for w in warm), warm_min_s=f"{best_s:.4f}")
    log("slice-split", **{k: f"{v:.4f}" for k, v in split.items()})

    t0 = time.perf_counter()
    ok = verifier.verify(air, proof, cases[best][1], log_n, cfg)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the port verifier rejected an honest proof")
    proof.trace_rows_a = proof.trace_rows_a.clone()
    proof.trace_rows_a[0, 0] ^= 1
    if verifier.verify(air, proof, cases[best][1], log_n, cfg):
        raise AssertionError("the port verifier accepted a tampered proof")
    log("slice-verify", accepted=True, tampered_rejected=True,
        verify_s=f"{verify_s:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log("device", name=torch.cuda.get_device_name(0), smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    pc.build()
    pc._load()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for line in pc.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    stats = phase_poseidon(np.random.default_rng(11), dev)
    phase_small(dev)

    pc.reset_launches()
    phase_slice(dev)
    launches = pc.launches
    if launches <= 0:
        raise AssertionError("the main path launched no Poseidon kernel")

    print(json.dumps({"kernels": [{
        "name": "poseidon_permute", "route": "cuda",
        "source": "vectorx_tpu_torch/csrc/poseidon.cu",
        "replaces": "vectorx_tpu/ops/poseidon_pallas.py:191",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
