"""Smoke run of the PyTorch/CUDA port (vectorx_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, a few lines each; any failure raises (non-zero exit, no final line):
  1. device   — a CUDA card, its name, power limit and SM clock (nvidia-smi)
  2. build    — compile the Poseidon kernels from csrc/ (nvcc, sm_90a)
  3. poseidon — every entry against its plain torch version on the card,
                bit for bit (max |diff| = 0 is the tolerance):
                permute at the main path's batch shapes (boundary rows
                included), on both of its routes, and against permute_ints;
                duplex for chains of 1..497 chunks with tails, and squeezes;
                sponge_rows for widths 4..987 at 16384 and 28 rows, column-
                and row-major. Then times by CUDA events, each beside its
                bound, and the measured crossover of permute's two routes
  4. small    — HeaderAir(max_chunks=2) proved on the card and on the CPU
                (plain path): identical proof payloads
  5. slice    — the Avail-header proof at full width: HeaderAir(16), a
                1990-byte header, rate 8, 28 queries, pow 16; one cold and
                three warm proves with a per-phase split, verify on the
                card, a tampered proof rejected; kernel launches per entry
                for one warm prove and one verify
Then one JSON line of the kernels, the card's name and power limit, and
the result line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

runs phases 1 and 2 and then, in place of the others, one warm prove and one
verify of the slice under torch.profiler (CUDA activity only): the span, the
device-busy time, the kernel count and the Poseidon kernels' time and count
of each. It prints no result line.
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
# the batch shapes the slice gives `permute`: the pow-16 grind batch, the
# bench batch, a tree level under 16384 leaves and smaller ones, the
# verifier's 56- and 28-query paths, one state
PATH_SHAPES = ((fri._grind_batch(prover.PRODUCTION_POW_BITS), 12),
               (POSEIDON_BATCH, 12), (16384, 12), (8192, 12), (56, 12),
               (33, 12), (28, 12), (3, 12), (2, 12), (1, 12), (12,))
CHAIN_CHUNKS = (1, 2, 7, 100, 497)   # 497: the ζ openings of HeaderAir(16)
CHAIN_TAILS = (0, 1, 7)
SQUEEZES = (1, 2, 8, 9, 28)
SPONGE_WIDTHS = (4, 8, 9, 135, 799, 987)   # FRI leaf ... trace ... trace+VK
SPONGE_ROWS = (16384, 28)                  # the LDE domain, the query rows
CROSSOVER_SWEEP = (256, 1024, 2048, 4096, 8192, 16384, 32768)

SOURCE = "vectorx_tpu_torch/csrc/poseidon.cu"
REPLACES = "vectorx_tpu/ops/poseidon_pallas.py:191"

# The bound of a permutation, in INT32 operations the card must execute: a
# 64x64 -> 128-bit product is four 32x32 -> 64 multiply-adds, an MDS term
# one shift-add per 32-bit half.
PRODUCTS_PER_PERM = 8 * 12 * 4 + 22 * 4 + 22 * 23 + 144     # 1,122
MDS_TERMS_PER_PERM = 8 * 144                                # 1,152
INT32_OPS_PER_PERM = 4 * PRODUCTS_PER_PERM + 2 * MDS_TERMS_PER_PERM
SMS = 132
INT32_LANES_PER_SM = 64          # INT32 results per SM per clock (sm_90)
HBM_BYTES_PER_S = 3.35e12
# A single chain cannot use the card's width: its floor is the depth of one
# permutation. 143 modular products in series (4 per S-box, 8 + 22 of
# them; the 22 row-dot products; the D product), each at least 9 dependent
# INT32 instructions (two levels of wide multiply-add, a carry, the
# epsilon fold) of at least 4 clocks; 22 * 4 + 8 + 1 shuffle stages of
# about 20 clocks.
CHAIN_CLOCKS_PER_PERM = 143 * 9 * 4 + (22 * 4 + 8 + 1) * 20


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


def nvidia_smi(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound_ms(perms: int, nbytes: int, sm_mhz: float):
    """The least time for `perms` permutations moving `nbytes`: the larger
    of operations over the INT32 instruction rate at the card's highest SM clock
    and bytes over the memory rate."""
    ops = perms * INT32_OPS_PER_PERM / (SMS * INT32_LANES_PER_SM * sm_mhz * 1e6)
    mem = nbytes / HBM_BYTES_PER_S
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


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


#: largest |kernel - plain| seen per entry (as unsigned 64-bit values)
max_abs_err = {"permute": 0, "duplex": 0, "sponge_rows": 0}


def must_equal(entry: str, got, want, what: str) -> None:
    """Hold a kernel's result against its plain version: record the largest
    absolute difference under `entry`, raise unless it is 0."""
    if got.shape != want.shape:
        raise AssertionError(f"kernel != plain: {what}: shape {got.shape}")
    diff = torch.where(gl.ltu(got, want), want - got, got - want)
    worst = int(gl.to_u64((diff ^ gl.MIN).max() ^ gl.MIN)) if diff.numel() else 0
    max_abs_err[entry] = max(max_abs_err[entry], worst)
    if worst:
        raise AssertionError(f"kernel != plain: {what} (max |diff| {worst})")


def check_permute(states, states_np) -> None:
    for shape in PATH_SHAPES:
        n = int(np.prod(shape)) // 12
        x = states[:n].reshape(shape).contiguous()
        want = ps.permute_plain(x)
        must_equal("permute", pc.permute(x), want, f"permute {shape}")
        if n <= 16384:       # both routes, whatever the dispatch picks
            for coop in (False, True):
                must_equal("permute", pc._permute(x, coop), want,
                           f"permute {shape} coop={coop}")
    got = gl.to_u64(pc.permute(states[:512]))
    for i in range(512):
        if [int(v) for v in got[i]] != ps.permute_ints(
                [int(v) for v in states_np[i]]):
            raise AssertionError(f"kernel != permute_ints on row {i}")


def check_duplex(states):
    """Chains of k chunks with a tail of r, absorbed with and without the
    flush, and squeezes; the plain chain runs the three tails as a batch.
    Returns the seconds of the plain 497-chunk chain on that batch."""
    flat = states.reshape(-1)
    state0 = states[:len(CHAIN_TAILS)].contiguous()              # (3, 12)
    kmax = max(CHAIN_CHUNKS)
    width = kmax * 8 + 7
    data = flat[36:36 + 3 * width].reshape(3, width)
    plain_s = 0.0
    for k in CHAIN_CHUNKS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _ = ps.duplex_plain(state0, data[:, :k * 8].contiguous())
        torch.cuda.synchronize()
        if k == kmax:
            plain_s = time.perf_counter() - t0
        for row, r in enumerate(CHAIN_TAILS):
            d = data[row, :k * 8 + r].contiguous()
            got, _ = pc.duplex(state0[row], d, False, 0)
            must_equal("duplex", got, full[row], f"duplex k={k} r={r}")
            want, _ = ps.duplex_plain(full[row], d[k * 8:], flush=True)
            got, none = pc.duplex(state0[row], d, True, 0)
            must_equal("duplex", got, want, f"duplex k={k} r={r} flushed")
            if none.numel():
                raise AssertionError("duplex squeezed without being asked")
    pending = flat[5:8].contiguous()
    for n in SQUEEZES:
        want = ps.duplex_plain(state0[1], pending, True, n)
        got = pc.duplex(state0[1], pending, True, n)
        must_equal("duplex", got[0], want[0], f"squeeze {n} state")
        must_equal("duplex", got[1], want[1], f"squeeze {n} output")
        got = pc.duplex(state0[2], pending[:0], True, n)     # nothing pending
        want = ps.duplex_plain(state0[2], pending[:0], True, n)
        must_equal("duplex", got[0], want[0], f"squeeze {n} state, no pending")
        must_equal("duplex", got[1], want[1], f"squeeze {n} output, no pending")
    return plain_s


def old_leaf_loop(rows: torch.Tensor) -> torch.Tensor:
    """Leaf hashing as it ran before sponge_rows: a permute launch and a
    concatenation per chunk (timed beside the fused kernel)."""
    n_pad = (-rows.shape[-1]) % 8
    if n_pad:
        rows = torch.nn.functional.pad(rows, (0, n_pad))
    state = torch.zeros((rows.shape[0], 12), dtype=torch.int64,
                        device=rows.device)
    for i in range(0, rows.shape[-1], 8):
        state = pc._permute(torch.cat([rows[:, i:i + 8], state[:, 8:]], dim=-1),
                            False)
    return state[:, :4]


def check_sponge(rng, dev, p: int):
    """Returns (plain seconds for (799, 16384), that matrix)."""
    wmax, nmax = max(SPONGE_WIDTHS), max(SPONGE_ROWS)
    cols = torch.from_numpy(rng.integers(0, p, (wmax, nmax), dtype=np.uint64)
                            .view(np.int64)).to(dev)
    edge = min(4096, nmax)
    cols[:12, :edge] = torch.from_numpy(
        boundary_states(rng, edge, p).T.copy().view(np.int64)).to(dev)
    plain_s, trace_cols = 0.0, None
    for n in SPONGE_ROWS:
        for w in SPONGE_WIDTHS:
            col_major = cols[:w, :n].contiguous()          # (w, n) storage
            row_major = col_major.t().contiguous()         # (n, w) storage
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ps.hash_many_plain(row_major)
            torch.cuda.synchronize()
            if (w, n) == (799, 16384):
                plain_s, trace_cols = time.perf_counter() - t0, col_major
            for name, x in (("column-major", col_major.t()),
                            ("row-major", row_major)):
                must_equal("sponge_rows", ps.hash_many(x), want,
                           f"sponge_rows {n}x{w} {name}")
                for coop in (False, True):
                    must_equal("sponge_rows", pc._sponge_rows(x, coop), want,
                               f"sponge_rows {n}x{w} {name} coop={coop}")
            must_equal("permute", old_leaf_loop(row_major), want, "old leaf loop")
    return plain_s, trace_cols


def phase_poseidon(rng, dev, sm_mhz: float):
    """Every entry against its plain version, then the times."""
    p = gl.MODULUS
    rows = PATH_SHAPES[0][0]
    states_np = boundary_states(rng, rows, p)
    states = torch.from_numpy(states_np.view(np.int64)).to(dev)

    check_permute(states, states_np)
    chain_plain_s = check_duplex(states)
    sponge_plain_s, trace_cols = check_sponge(rng, dev, p)
    log("poseidon", bit_equal="permute|duplex|sponge_rows",
        permute_shapes="|".join("x".join(map(str, s)) for s in PATH_SHAPES),
        permute_ints_rows=512, chains="|".join(map(str, CHAIN_CHUNKS)),
        tails="|".join(map(str, CHAIN_TAILS)),
        squeezes="|".join(map(str, SQUEEZES)),
        sponge_widths="|".join(map(str, SPONGE_WIDTHS)),
        sponge_rows="|".join(map(str, SPONGE_ROWS)),
        max_abs_err=max(max_abs_err.values()))

    # -- permute -----------------------------------------------------------
    t = {}
    for n, reps in ((1, 200), (28, 200), (16384, 200), (POSEIDON_BATCH, 50),
                    (262144, 30)):
        x = states[:n]
        t[n] = event_ms(lambda: pc.permute(x), reps)
    one = states[:1]
    one_thread_ms = event_ms(lambda: pc._permute(one, False), 200)
    bench = states[:POSEIDON_BATCH]
    plain_ms = event_ms(lambda: ps.permute_plain(bench), 3)
    b_ms, b_by = bound_ms(POSEIDON_BATCH, POSEIDON_BATCH * 192, sm_mhz)
    log("poseidon-permute",
        **{f"n{n}_ms": f"{ms:.4f}" for n, ms in t.items()},
        single_state_thread_route_ms=f"{one_thread_ms:.4f}",
        plain_131072_ms=f"{plain_ms:.4f}",
        perms_s_131072=f"{POSEIDON_BATCH / t[POSEIDON_BATCH] * 1e3:.6g}",
        bound_131072_ms=f"{b_ms:.4f}", bound_by=b_by,
        share_of_bound=f"{b_ms / t[POSEIDON_BATCH]:.3f}")
    sweep = []
    for n in CROSSOVER_SWEEP:
        x = states[:n]
        sweep.append((n, event_ms(lambda: pc._permute(x, True), 50),
                      event_ms(lambda: pc._permute(x, False), 50)))
    coop_wins = [n for n, coop_ms, thread_ms in sweep if coop_ms <= thread_ms]
    log("poseidon-crossover",
        **{f"n{n}_coop/thread_ms": f"{c:.4f}/{th:.4f}" for n, c, th in sweep},
        largest_n_where_coop_wins=max(coop_wins, default=0),
        dispatch_constant=pc.COOP_MAX_STATES)
    permute = dict(max_abs_err=max_abs_err["permute"], ms=t[POSEIDON_BATCH],
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # -- duplex: the ζ openings' 497-chunk absorb in one launch ---------------
    kmax = max(CHAIN_CHUNKS)
    state0 = states[0].contiguous()
    data = states.reshape(-1)[12:12 + kmax * 8].contiguous()
    chain_ms = event_ms(lambda: pc.duplex(state0, data, False, 0), 5)
    squeeze_ms = event_ms(lambda: pc.duplex(state0, data[:3], True, 2), 100)
    d_ms, d_by = bound_ms(kmax, kmax * 64 + 192, sm_mhz)
    latency_ms = kmax * CHAIN_CLOCKS_PER_PERM / (sm_mhz * 1e3)
    log("poseidon-duplex", chunks=kmax, chain_ms=f"{chain_ms:.4f}",
        per_permutation_us=f"{chain_ms / kmax * 1e3:.3f}",
        flush_and_squeeze2_ms=f"{squeeze_ms:.4f}",
        plain_chain_ms=f"{chain_plain_s * 1e3:.1f}",
        bound_ms=f"{d_ms:.6f}", bound_by=d_by,
        chain_latency_floor_ms=f"{latency_ms:.4f}",
        share_of_latency_floor=f"{latency_ms / chain_ms:.3f}")
    duplex = dict(max_abs_err=max_abs_err["duplex"], ms=chain_ms,
                  plain_ms=chain_plain_s * 1e3, bound_ms=d_ms, bound_by=d_by,
                  chain_latency_floor_ms=latency_ms)

    # -- sponge_rows: the trace commit's leaves, (799, 16384) column-major ---
    w, n = trace_cols.shape
    view = trace_cols.t()
    fused_ms = event_ms(lambda: pc.sponge_rows(view), 10)
    thread_ms = event_ms(lambda: pc._sponge_rows(view, False), 10)
    coop_ms = event_ms(lambda: pc._sponge_rows(view, True), 10)
    loop_ms = event_ms(lambda: old_leaf_loop(view), 10)
    few = trace_cols[:, :28].t()
    few_ms = event_ms(lambda: pc.sponge_rows(few), 20)
    few_thread_ms = event_ms(lambda: pc._sponge_rows(few, False), 5)
    s_ms, s_by = bound_ms(n * -(-w // 8), (n * w + n * 4) * 8, sm_mhz)
    log("poseidon-sponge", shape=f"{w}x{n} column-major",
        fused_ms=f"{fused_ms:.4f}", thread_route_ms=f"{thread_ms:.4f}",
        coop_route_ms=f"{coop_ms:.4f}", old_100_launch_loop_ms=f"{loop_ms:.4f}",
        rows28_ms=f"{few_ms:.4f}", rows28_thread_route_ms=f"{few_thread_ms:.4f}",
        plain_ms=f"{sponge_plain_s * 1e3:.1f}", bound_ms=f"{s_ms:.4f}",
        bound_by=s_by, share_of_bound=f"{s_ms / fused_ms:.3f}")
    sponge = dict(max_abs_err=max_abs_err["sponge_rows"], ms=fused_ms,
                  plain_ms=sponge_plain_s * 1e3, bound_ms=s_ms, bound_by=s_by)
    return {"permute": permute, "duplex": duplex, "sponge_rows": sponge}


def make_header(rng, bn: int, size: int) -> bytes:
    """A random SCALE header: parent | compact(bn) | body | data root
    (the bench's header_proof generator)."""
    parent = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    body = parent + scale.encode_compact_u32(bn)
    body += bytes(rng.integers(0, 256, size - len(body) - 32, dtype=np.uint8))
    return body + bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def header_case(air, msg: bytes, dev=None):
    """(trace, publics) on `dev` (the card unless named)."""
    trace, publics, digest = air.make_trace(msg, dev)
    if digest != hashlib.blake2b(msg, digest_size=32).digest():
        raise AssertionError("HeaderAir trace digest != hashlib blake2b")
    return trace, [gl.to_fp(int(v), dev) for v in publics]


def phase_small():
    air = ah.HeaderAir(max_chunks=2)
    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
    msg = make_header(np.random.default_rng(7), 77, 200)
    cuda_case = header_case(air, msg)
    if not cuda_case[0].is_cuda:
        raise AssertionError("the default device is not the card")
    before = dict(pc.launches)
    t0 = time.perf_counter()
    on_card = serialize.payload(prover.prove(air, *cuda_case, cfg))
    t_card = time.perf_counter() - t0
    launched = {k: pc.launches[k] - before[k] for k in before}
    t0 = time.perf_counter()
    on_cpu = serialize.payload(prover.prove(air, *header_case(air, msg, "cpu"), cfg))
    t_cpu = time.perf_counter() - t0
    if on_card != on_cpu:
        raise AssertionError("HeaderAir(2) payloads differ between CUDA and CPU")
    if min(launched.values()) <= 0:
        raise AssertionError(f"the CUDA prove skipped a kernel: {launched}")
    log("small", air="HeaderAir(2)", payload_bytes=len(on_card),
        identical=True, cuda_s=f"{t_card:.3f}", cpu_s=f"{t_cpu:.3f}",
        **{f"{k}_launches": v for k, v in launched.items()})


def phase_slice():
    rng = np.random.default_rng(3)
    air, log_n, cfg = slice_setup()
    cases = [header_case(air, make_header(rng, 1000 + i, HEADER_BYTES))
             for i in range(3)]

    def timed_prove(case):
        split = {}
        last = [time.perf_counter()]

        def mark(phase):
            torch.cuda.synchronize()
            now = time.perf_counter()
            split[phase] = now - last[0]
            last[0] = now

        before = dict(pc.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prover.prove(air, *case, cfg, timer=mark)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return proof, seconds, split, {k: pc.launches[k] - before[k]
                                       for k in before}

    _, cold, _, _ = timed_prove(cases[0])
    warm = [timed_prove(c) for c in cases]
    best = min(range(3), key=lambda i: warm[i][1])
    proof, best_s, split, per_prove = warm[best]
    log("slice", air=f"HeaderAir({HEADER_CHUNKS})", rows=air.n_rows,
        cols=air.num_cols, header_bytes=HEADER_BYTES, cold_s=f"{cold:.4f}",
        warm_s=",".join(f"{w[1]:.4f}" for w in warm), warm_min_s=f"{best_s:.4f}")
    log("slice-split", **{k: f"{v:.4f}" for k, v in split.items()})

    before = dict(pc.launches)
    t0 = time.perf_counter()
    ok = verifier.verify(air, proof, cases[best][1], log_n, cfg)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    per_verify = {k: pc.launches[k] - before[k] for k in before}
    if not ok:
        raise AssertionError("the port verifier rejected an honest proof")
    proof.trace_rows_a = proof.trace_rows_a.clone()
    proof.trace_rows_a[0, 0] ^= 1
    if verifier.verify(air, proof, cases[best][1], log_n, cfg):
        raise AssertionError("the port verifier accepted a tampered proof")
    log("slice-verify", accepted=True, tampered_rejected=True,
        verify_s=f"{verify_s:.4f}")
    log("slice-launches",
        **{f"{k}_per_warm_prove": v for k, v in per_prove.items()},
        **{f"{k}_per_verify": v for k, v in per_verify.items()},
        per_warm_prove=sum(per_prove.values()),
        per_verify=sum(per_verify.values()))


def slice_setup():
    air = ah.HeaderAir(max_chunks=HEADER_CHUNKS)
    cfg = prover.StarkConfig(rate_bits=3, num_queries=28, final_poly_len=8,
                             pow_bits=prover.PRODUCTION_POW_BITS)
    return air, air.n_rows.bit_length() - 1, cfg


def phase_profile():
    """Where the device time of one warm prove and one verify goes."""
    from torch.profiler import ProfilerActivity, profile
    air, log_n, cfg = slice_setup()
    case = header_case(air, make_header(np.random.default_rng(3), 1000,
                                        HEADER_BYTES))
    proof = prover.prove(air, *case, cfg)                     # cold: VK, tables
    if not verifier.verify(air, proof, case[1], log_n, cfg):
        raise AssertionError("the port verifier rejected an honest proof")

    def traced(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        busy_us = poseidon_us = kernels = poseidon_kernels = 0
        by_name = {}
        for row in prof.key_averages():
            us = getattr(row, "self_device_time_total", None)
            if us is None:
                us = row.self_cuda_time_total
            if not us:
                continue
            busy_us += us
            kernels += row.count
            for kernel in ("sponge_rows_coop_kernel", "sponge_rows_kernel",
                           "permute_coop_kernel", "permute_kernel",
                           "duplex_kernel"):
                if kernel in row.key:
                    poseidon_us += us
                    poseidon_kernels += row.count
                    by_name[kernel] = f"{us / 1e3:.3f}ms/{row.count}"
                    break
        if busy_us == 0:
            raise AssertionError("the profiler saw no device time")
        log(f"profile-{name}", span_ms=f"{span * 1e3:.1f}",
            device_busy_ms=f"{busy_us / 1e3:.1f}",
            busy_share=f"{busy_us / 1e6 / span:.3f}", kernels=kernels,
            poseidon_ms=f"{poseidon_us / 1e3:.3f}",
            poseidon_share_of_busy=f"{poseidon_us / busy_us:.4f}",
            poseidon_kernels=poseidon_kernels, **by_name)

    traced("prove", lambda: prover.prove(air, *case, cfg))
    traced("verify", lambda: verifier.verify(air, proof, case[1], log_n, cfg))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log("device", name=torch.cuda.get_device_name(0), smi=repr(smi),
        max_sm_mhz=sm_mhz, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    pc._load()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for line in pc.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())

    if sys.argv[1:] == ["--profile"]:
        phase_profile()
        print(smi)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")

    stats = phase_poseidon(np.random.default_rng(11), dev, sm_mhz)
    phase_small()

    pc.reset_launches()
    phase_slice()
    launches = dict(pc.launches)
    log("slice-launches-total", **launches, total=sum(launches.values()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"the main path skipped a kernel: {launches}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[name], "library_ms": None, **stats[name]}
        for name in ("permute", "duplex", "sponge_rows")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
