"""Smoke run of the PyTorch/CUDA port (vectorx_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, a few lines each; any failure raises (non-zero exit, no final line):
  1. device   — a CUDA card, its name, power limit and SM clock (nvidia-smi)
  2. build    — compile the Poseidon kernels from csrc/ (nvcc, sm_90a)
  3. poseidon — every entry against its plain torch version on the card,
                bit for bit (max |diff| = 0 is the tolerance):
                permute at the main path's batch shapes (boundary rows
                included), on both of its routes, and against permute_ints;
                duplex for chains of 1..497 chunks with tails, and squeezes
                of 1..84; after the main paths also every (length, flush,
                squeeze) the transcripts of those runs gave it;
                sponge_rows for widths 4..987 at 16384 and 28 rows, column-
                and row-major; after the main paths also at every shape and
                memory layout those runs gave it (up to (314, 524288) and
                (3336, 32768) column-major), all rows up to 4096 and a
                seeded sample of rows above, the statements' commits timed
                beside their bounds.
                Then times by CUDA events, each beside its bound, and the
                measured crossover of permute's two routes
  4. small    — HeaderAir(max_chunks=2) proved on the card and on the CPU
                (plain path): identical proof payloads
  5. aux-small — a two-column LogUp range AIR and a RAM-multiset AIR proved
                on the card and on the CPU: identical payloads, the honest
                proof accepted, an out-of-range value rejected
  6. slice    — the Avail-header proof at full width: HeaderAir(16), a
                1990-byte header, rate 8, 28 queries, pow 16; one cold and
                three warm proves with a per-phase split, verify on the
                card, a tampered proof rejected; kernel launches per entry
                for one warm prove and one verify
  7. statement — the sub-proofs of the header_range bundle at full width
                (rate 4, 42 queries, pow 16): MerkleSha256Air over 256
                leaves (65536 x 368), ChainedSha256Air(300) (131072 x 314),
                Sha512ChallengeAir of 32 lanes (8192 x 685 + 82 aux
                columns) and the Ed25519VerifyAir shard of 32 signed lanes
                (B = 13: 8192 x 3336 + 3188 aux columns). For each: witness
                seconds, public output against hashlib, one cold and one
                warm prove with the per-phase split, peak device memory,
                verify, a tampered proof rejected, kernel launches
  8. bundle-header-range — prove_header_range and verify_header_range at
                production width: 2 chained 1990-byte headers
                (HeaderAir(16)), 256-leaf range trees, the 300-key chain,
                one Ed25519 and one SHA-512 shard of 32 signers; a
                serialization round trip, then the verify of what came
                back: outputs against hashlib, forged claims refused;
                seconds by kind of sub-proof
  9. bundle-rotate — prove_rotate and verify_rotate: an epoch-end header
                scheduling 300 new keys (RotateHeaderAir(128), 16384 x
                803), the two 300-key chains, 32 signers; the same checks
 10. recursion-small — FibonacciAir(8) recursed at rate 1, 2 queries:
                prove_recursive plain and streamed, a two-child reduce with
                a link and three exposed publics, map_reduce_prove over two
                shards (verify_aggregate), and the two-level case (the
                level-1 outer proof recursed, the level-2 machine proved
                and verified); every outer proof verified against the
                verifier's claim-shape rebuild, a tampered claim refused
 11. reduce-streamed — scripts/prove_reduce_streamed.py with the inner
                proofs cut from 21 to 15 queries: two PoseidonChainAir
                proofs (inner rate 4, 15 queries, pow 16) linked A.out ==
                B.in, reduced through the streamed recorder into one outer
                proof (rate 2, 42 queries, pow 16) of 2^18 rows, K = 750,
                789 + 274 constant columns (the JAX package's shape for
                that claim); verified against reduce_air_for,
                the claim A.in ‖ B.out checked, a tampered claim refused;
                record, constants, witness, per-phase prove and verify
                seconds and peak memory
 12. recursion-leaf — scripts/prove_recursion_leaf.py: a real 120-byte
                header proved through HeaderAir(1) (128 x 799 + 188
                constant columns) at inner rate 10, 9 queries, pow 16,
                recorded streamed into one outer machine of 2^19 rows, K =
                725, 764 + 336 constant columns (the JAX package's claim
                shape), proved at outer rate 1, 84 queries, pow 16 and
                verified against the outer_air_for rebuild (same schedule
                digest); a tampered public refused; seconds by stage and the
                peak memory of the outer prove and of the verify
 13. dsl-small — the DSL's Poseidon chain AIR and the GF(2^255-19) gadgets'
                fp-ops AIR (tests/test_gadget_fp25519.py's, 256 x 708 with
                706 looked-up columns) proved and verified on the card; a
                process of its own proves both on the CPU and refuses
                their tampered publics, and its payloads must be identical
 14. cli       — the CLI, python -m vectorx_tpu_torch, on fixture
                directories written under build/chip_smoke_cli/, each run
                a process of its own: the witness-level header_range at
                production width (180 chained 1990-byte headers in 256
                slots of 35,840 bytes, 300 authorities with 240 signed;
                output against the host's) alone; then side by side: a
                wrong authority-set hash, a broken link and 200 of 300
                signed, at 20 headers (each must exit non-zero), rotate
                with 300 and with 120 new keys
                (output against the host's authority_set_hash), the --stark
                route on 2 headers and 4 authorities (its process reports
                its kernel launches; the bundle file reads back to its
                bytes here),
                the same with --procs 2 --checkpoint (its header proofs in
                worker processes; the same output), rotate --stark --procs
                2 on 2 new keys and 4 authorities, and build of each
                program
 15. service   — the service loop on the card over the [cli-header-range]
                fixture: the indexer's verify_justification (one 300-lane
                verify_batch: its record equal to the fixture's, a forged
                lane dropped, two thirds signed refused), genesis_params
                and the contract simulator with its mock gateway at the
                trusted block, the Operator's header_range request (one,
                80 bytes, the CLI's input), run_program in process (output
                equal to the CLI's), fulfil and commit, poll_once reading
                the commitments back (equal to compute_block_range_data's),
                and the operator's rotate request on a chain one set
                ahead; seconds by stage ([service-split], the port's
                PhaseTimer). No Poseidon kernel on its path
 16. collective — the collective layer of parallel/ on meshes of 4 shards
                of the one card (NCCL refuses two ranks on one card):
                the [cli-header-range] chain sharded over the mesh, every
                field equal to the single-device check's, a parent hash
                forged at slot 128 (shard 2's first header) refused
                ([collective-subchain]); the [slice] proof with
                ShardedNttOps, its payload equal to the unsharded proof's,
                verified, a tampered copy refused, its Poseidon launches a
                main path of their own ([collective-prove]);
                dryrun_multichip(4) ([collective-dryrun]); the two-process
                demo on gloo (DCN_DEMO_OK with the single-device root,
                DCN_MAP_OK) and phase 1 alone on NCCL at world size 1,
                in processes of their own beside the subchain check
                ([collective-dcn])
The main paths (6-14, 16) each run with the launch counts set to 0 just before
and read just after (the --stark process counts its own); the
witness-level programs launch no Poseidon kernel. Processes of their own
prove on the CPU what the card proves, at the lowest priority: the
recursion-small proofs (two processes) and the dsl-small proofs beside
the main paths, then
Ed25519VerifyAir(B=8) beside the kernel checks at the main paths' shapes
(above); then
 17. ed25519-small — Ed25519VerifyAir(B=8), one signed lane: identical
                payloads;
 18. recursion-small and dsl-small on the CPU — every payload identical,
                and the same level-2 recording.
The signatures come from an RFC 8032 signer on Python ints in this file
(ed25519_sign), so no signing library is needed. Then one JSON line of the kernels, the total seconds, the card's name and
power limit, and the result line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [header|merkle|chain|sha512|ed25519|witness]

runs phases 1 and 2 and then, in place of the others, one warm prove and one
verify of the named proof (header when none is named) under torch.profiler
(CUDA activity only): the span, the device-busy time, the kernel count and
the Poseidon kernels' time and count of each; `witness` instead traces one
warm witness-level header_range of the [cli-header-range] request, and
alone its Blake2b, its authority-set chain and its verify_batch. It prints
no result line.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import copy
import dataclasses
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from vectorx_tpu_torch import default_device
from vectorx_tpu_torch.circuits import abi, commitments, consts, scale
from vectorx_tpu_torch.circuits.ed25519 import D_CONST, L_ORDER, _BX, _BY
from vectorx_tpu_torch.circuits.ed25519 import P as ED_P
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.ops import poseidon_cuda as pc
from vectorx_tpu_torch.stark import air_header as ah
from vectorx_tpu_torch.parallel import map_prove
from vectorx_tpu_torch.stark import (fri, prover, serialize, statements,
                                     verifier)
from vectorx_tpu_torch.stark import gadget_fp25519 as gfp
from vectorx_tpu_torch.stark import recursion_air as ra
from vectorx_tpu_torch.stark import recursion_leaf as rl
from vectorx_tpu_torch.stark.air import Air, FibonacciAir
from vectorx_tpu_torch.stark.air_poseidon_dsl import build_poseidon_chain_air
from vectorx_tpu_torch.stark.air_poseidon import WIDTH as PWIDTH
from vectorx_tpu_torch.stark.air_poseidon import PoseidonChainAir
from vectorx_tpu_torch.stark.air_ed25519 import (Ed25519VerifyAir,
                                                 compress_host, dummy_sig)
from vectorx_tpu_torch.stark.air_sha256_chain import ChainedSha256Air
from vectorx_tpu_torch.stark.air_sha256_merkle import MerkleSha256Air
from vectorx_tpu_torch.stark.air_sha512 import Sha512ChallengeAir
from vectorx_tpu_torch.stark.ed25519_prove import sigs_from_justification

HEADER_CHUNKS = 16
HEADER_BYTES = 1990
POSEIDON_BATCH = 131072          # bench.py's Poseidon batch
# the batch shapes the main paths give `permute`: the pow-16 grind batch
# (also the first tree level under the statements' 524288 leaves), the
# bench batch, a tree level under 16384 leaves and smaller ones, the
# verifiers' 84-, 56-, 42- and 28-query paths, one state
PATH_SHAPES = ((fri._grind_batch(prover.PRODUCTION_POW_BITS), 12),
               (POSEIDON_BATCH, 12), (16384, 12), (8192, 12), (84, 12),
               (56, 12), (42, 12), (33, 12), (28, 12), (3, 12), (2, 12),
               (1, 12), (12,))
CHAIN_CHUNKS = (1, 2, 7, 100, 497)   # 497: the ζ openings of HeaderAir(16)
CHAIN_TAILS = (0, 1, 7)
SQUEEZES = (1, 2, 8, 9, 28, 42, 84)   # 28 and 42: the query indices
SPONGE_WIDTHS = (4, 8, 9, 135, 799, 987)   # FRI leaf ... trace ... trace+VK
SPONGE_ROWS = (16384, 28)                  # the LDE domain, the query rows
# (width, rows) of column-major matrices the statement proofs commit:
# trace, aux, constants; each is timed beside its bound after the main
# paths, and compared at QUERY_ROWS contiguous rows of its width too.
# Every shape the main paths give sponge_rows is bit-compared (recorded
# during those runs, these included): all rows up to FULL_ROWS, else the
# kernel's digests on SAMPLE_ROWS seeded rows (first and last included),
# since the plain sponge takes ~0.3 us a cell on the card.
SPONGE_LARGE = ((314, 524288), (10, 524288), (4, 524288), (368, 262144),
                (48, 262144), (685, 32768), (82, 32768), (75, 32768),
                (3336, 32768), (3188, 32768), (30, 32768),  # Ed25519, B = 13
                (803, 65536), (188, 65536),                 # RotateHeaderAir(128)
                (789, 1048576), (274, 1048576),   # the streamed reduce's outer
                (799, 131072), (188, 131072),     # the leaf's inner HeaderAir(1)
                (764, 1048576), (336, 1048576))   # the leaf's outer
SAMPLE_ROWS = 2048
FULL_ROWS = 4096
QUERY_ROWS = 84                  # the opened rows of a 42-query verify
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
    flush, and squeezes; the plain chain runs the three tails as a batch,
    one chain read after each k (an absorb without the flush permutes
    once a chunk, so the state after k chunks is a prefix of the longest
    chain). Returns the seconds of the plain 497-chunk chain on that
    batch, the sum of its segments."""
    flat = states.reshape(-1)
    state0 = states[:len(CHAIN_TAILS)].contiguous()              # (3, 12)
    kmax = max(CHAIN_CHUNKS)
    width = kmax * 8 + 7
    data = flat[36:36 + 3 * width].reshape(3, width)
    plain_s, full, done = 0.0, state0, 0
    for k in sorted(CHAIN_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _ = ps.duplex_plain(full, data[:, done * 8:k * 8].contiguous())
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        done = k
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


def record_duplex_shapes(seen: set) -> None:
    """From here on note the (data length, flush, squeezes) of every
    `duplex` launch in `seen`; the launch and its count are unchanged."""
    launch = pc.duplex

    def duplex(state, data, flush, n_squeeze):
        seen.add((data.shape[0], bool(flush), int(n_squeeze)))
        return launch(state, data, flush, n_squeeze)

    pc.duplex = duplex


def check_duplex_shapes(rng, dev, shapes) -> None:
    """`duplex` against `duplex_plain` at every shape the main paths'
    transcripts gave it, on seeded data biased to the carry boundaries.
    Every absorb starts from one state on a prefix of one data vector, so a
    single plain chain, read after each absorbed length, gives them all.
    The plain chain runs on copies of the inputs on the CPU: a plain
    permutation of one state is ~5,200 torch operations, each a launch on
    the card (~40-55 ms a permutation there, ~13 ms on the CPU), and the
    longest chain has ~1,700."""
    longest = max(m for m, _, _ in shapes)
    flat_cpu = torch.from_numpy(
        boundary_states(rng, longest // 12 + 2, gl.MODULUS).view(np.int64)
    ).reshape(-1)
    flat = flat_cpu.to(dev)
    state0, state0_cpu = flat[:12].contiguous(), flat_cpu[:12].contiguous()
    after, state, done = {}, state0_cpu, 0
    for k in sorted({m // ps.RATE for m, flush, _ in shapes if not flush}):
        state, _ = ps.duplex_plain(
            state, flat_cpu[12 + done * ps.RATE:12 + k * ps.RATE])
        after[k], done = state, k
    for m, flush, n in sorted(shapes):
        data = flat[12:12 + m].contiguous()
        want = (ps.duplex_plain(state0_cpu, flat_cpu[12:12 + m], flush, n)
                if flush else (after[m // ps.RATE], flat_cpu[:0]))
        got = pc.duplex(state0, data, flush, n)
        what = f"duplex len={m} flush={flush} squeeze={n}"
        must_equal("duplex", got[0].cpu(), want[0], what + " state")
        must_equal("duplex", got[1].cpu(), want[1], what + " output")
    absorbs = sorted({m // 8 for m, flush, _ in shapes if not flush})
    squeezes = sorted({(m, n) for m, flush, n in shapes if flush})
    log("poseidon-duplex-path", bit_equal=True, shapes=len(shapes),
        absorb_chunks="|".join(map(str, absorbs)),
        flush_pending_x_squeeze="|".join(f"{m}x{n}" for m, n in squeezes),
        max_abs_err=max_abs_err["duplex"])


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


def random_cols(gen, w: int, n: int) -> torch.Tensor:
    """(w, n) canonical values on the generator's device (the hi word below
    2^32 - 1)."""
    return ((torch.randint(0, (1 << 32) - 1, (w, n), generator=gen,
                           device=gen.device) << 32)
            | torch.randint(0, 1 << 32, (w, n), generator=gen, device=gen.device))


def record_sponge_shapes(seen: set) -> None:
    """From here on note the (rows, width, strides, storage offset mod 4)
    of every `sponge_rows` launch in `seen`; the launch and its count are
    unchanged."""
    launch = pc.sponge_rows

    def sponge_rows(rows):
        seen.add((*rows.shape, *rows.stride(), rows.storage_offset() % 4))
        return launch(rows)

    pc.sponge_rows = sponge_rows


def plain_sponge_widths(blocks):
    """hash_many_plain of each (rows, width) block, all blocks at once:
    hash_many_plain's loop (zero padding to a multiple of RATE, one
    overwrite absorb and one permute_plain per chunk) over every row that
    still has a chunk to absorb. permute_plain acts on each state alone,
    so each row's digest is hash_many_plain's, and the blocks cost as
    many plain permutations as the widest one has chunks, not their sum
    (a plain permutation is ~5,200 launch-bound torch operations)."""
    rate = ps.RATE
    chunks = [-(-b.shape[1] // rate) for b in blocks]
    rows = torch.cat([torch.nn.functional.pad(b, (0, max(chunks) * rate
                                                   - b.shape[1]))
                      for b in blocks])
    left = torch.cat([torch.full((b.shape[0],), c, device=rows.device)
                      for b, c in zip(blocks, chunks)])
    state = torch.zeros((rows.shape[0], ps.WIDTH), dtype=torch.int64,
                        device=rows.device)
    for i in range(max(chunks)):
        live = torch.nonzero(left > i).flatten()
        state[live] = ps.permute_plain(torch.cat(
            [rows[live, i * rate:(i + 1) * rate], state[live, rate:]], dim=-1))
    return list(torch.split(state[:, :ps.DIGEST_WIDTH],
                            [b.shape[0] for b in blocks]))


def check_sponge_shapes(dev, p: int, sm_mhz: float, seen):
    """sponge_rows against hash_many_plain at every shape the main paths
    gave it (`seen`) and at SPONGE_LARGE, each laid out in memory as it was
    (strides and alignment), on seeded values with carry-boundary rows
    first and last: all rows up to FULL_ROWS, a seeded sample of rows
    above. The plain sponge costs a launch-bound permutation per 8 columns
    whatever the rows, so it runs once over the rows of every shape
    (plain_sponge_widths). SPONGE_LARGE's kernel times beside their bounds.
    Returns {"WxN": (ms, bound_ms, bound_by)}."""
    gen = torch.Generator(device=dev).manual_seed(13)
    rng = np.random.default_rng(13)
    path = set(seen)                # the checks' own launches add to `seen`
    named = {(n, w, 1, n, 0) for w, n in SPONGE_LARGE}
    queries = {(QUERY_ROWS, w, w, 1, 0) for w, _ in SPONGE_LARGE}
    shapes = sorted(path | named | queries)
    times, by_width = {}, {}
    for key in shapes:
        n, w, s_n, s_w, offset = key
        if n == 0 or w == 0:
            continue
        flat = random_cols(gen, 1, offset + 1 + (n - 1) * s_n + (w - 1) * s_w)[0]
        rows = flat.as_strided((n, w), (s_n, s_w), offset)
        edge, k = min(4096, n), min(w, 12)
        ends = torch.from_numpy(boundary_states(rng, edge, p)[:, :k]
                                .copy().view(np.int64)).to(dev)
        rows[:edge, :k] = ends
        rows[n - edge:, :k] = ends
        got = pc.sponge_rows(rows)
        if n <= FULL_ROWS:
            idx = torch.arange(n, device=dev)
        else:
            idx = torch.from_numpy(np.unique(np.concatenate([
                [0, 1, edge - 1, edge, n - edge - 1, n - 2, n - 1],
                rng.integers(0, n, SAMPLE_ROWS)]))).to(dev)
        by_width.setdefault(w, []).append((key, rows[idx].contiguous(),
                                           got[idx]))
        if key in named:
            ms = event_ms(lambda: pc.sponge_rows(rows), 3)
            b_ms, b_by = bound_ms(n * -(-w // 8), (n * w + n * 4) * 8, sm_mhz)
            times[f"{w}x{n}"] = (ms, b_ms, b_by)
            log("poseidon-sponge-shape", shape=f"{w}x{n} column-major",
                ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                share_of_bound=f"{b_ms / ms:.3f}")
        del flat, rows, got
    widths = sorted(by_width)
    want = plain_sponge_widths([torch.cat([x for _, x, _ in by_width[w]])
                                for w in widths])
    for w, want_w in zip(widths, want):
        start = 0
        for (n, _, s_n, s_w, offset), x, got in by_width[w]:
            must_equal("sponge_rows", got, want_w[start:start + len(x)],
                       f"sponge_rows {n}x{w} strides ({s_n}, {s_w}) "
                       f"offset {offset}")
            start += len(x)
    log("poseidon-sponge-path", bit_equal=True, shapes=len(shapes),
        recorded_on_paths=len(path),
        named_seen_on_paths=f"{len(named & path)}/{len(named)}",
        widths=len(by_width),
        rows_x_width="|".join(sorted({f"{n}x{w}" for n, w, *_ in path},
                                     key=lambda t: tuple(map(int, t.split("x"))))),
        full_rows_up_to=FULL_ROWS, sampled_rows=SAMPLE_ROWS,
        max_abs_err=max_abs_err["sponge_rows"])
    return times


def phase_poseidon(rng, dev, sm_mhz: float):
    """Every entry against its plain version, then the times."""
    p = gl.MODULUS
    rows = PATH_SHAPES[0][0]
    states_np = boundary_states(rng, rows, p)
    states = torch.from_numpy(states_np.view(np.int64)).to(dev)

    check_permute(states, states_np)
    chain_plain_s = check_duplex(states)
    sponge_plain_s, trace_cols = check_sponge(rng, dev, p)
    big_cols = random_cols(torch.Generator(device=dev).manual_seed(13),
                           *SPONGE_LARGE[0])
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

    # -- sponge_rows at the chain statement's trace commit, (314, 524288) ----
    bw, bn = big_cols.shape
    big_view = big_cols.t()
    big_ms = event_ms(lambda: pc.sponge_rows(big_view), 5)
    g_ms, g_by = bound_ms(bn * -(-bw // 8), (bn * bw + bn * 4) * 8, sm_mhz)
    sample = big_cols[:, :SAMPLE_ROWS].t().contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps.hash_many_plain(sample)
    torch.cuda.synchronize()
    plain_sample_ms = (time.perf_counter() - t0) * 1e3
    log("poseidon-sponge-large", shape=f"{bw}x{bn} column-major",
        ms=f"{big_ms:.4f}", bound_ms=f"{g_ms:.4f}", bound_by=g_by,
        share_of_bound=f"{g_ms / big_ms:.3f}",
        ns_per_permutation=f"{big_ms * 1e6 / (bn * -(-bw // 8)):.3f}",
        plain_ms_for_2048_rows=f"{plain_sample_ms:.1f}",
        first_tree_level_262144_pairs_ms=f"{t[262144]:.4f}")
    sponge.update(ms_314x524288=big_ms, bound_ms_314x524288=g_ms,
                  plain_ms_2048_rows_of_314=plain_sample_ms)
    permute.update(ms_262144=t[262144])
    return {"permute": permute, "duplex": duplex, "sponge_rows": sponge}


# -- an RFC 8032 Ed25519 signer on Python ints (test support) ----------------
# The bundles need valid signatures; this signer needs nothing beyond
# hashlib. Points are extended twisted-Edwards coordinates (X, Y, Z, T),
# a = -1, with the unified add-2008-hwcd-3 formulas.

_ED_BASE = (_BX, _BY, 1, _BX * _BY % ED_P)
_ED_ID = (0, 1, 1, 0)


def _ed_add(p1, p2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % ED_P
    b = (y1 + x1) * (y2 + x2) % ED_P
    c = 2 * D_CONST * t1 * t2 % ED_P
    d = 2 * z1 * z2 % ED_P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % ED_P, g * h % ED_P, f * g % ED_P, e * h % ED_P


def _ed_mul(k: int, pt):
    acc = _ED_ID
    while k:
        if k & 1:
            acc = _ed_add(acc, pt)
        pt = _ed_add(pt, pt)
        k >>= 1
    return acc


def _ed_encode(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, ED_P - 2, ED_P)
    return compress_host(x * zi % ED_P, y * zi % ED_P)


def _sha512_int(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def _ed_secret(seed: bytes):
    """-> (clamped secret scalar, nonce prefix) of a 32-byte seed."""
    digest = hashlib.sha512(seed).digest()
    a = int.from_bytes(digest[:32], "little")
    return (a & ((1 << 254) - 8)) | (1 << 254), digest[32:]


def ed25519_public_key(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte secret seed (RFC 8032 5.1.5)."""
    return _ed_encode(_ed_mul(_ed_secret(seed)[0], _ED_BASE))


def ed25519_sign(seed: bytes, msg: bytes):
    """-> (public key, 64-byte signature R | S) of `msg` (RFC 8032 5.1.6)."""
    a, prefix = _ed_secret(seed)
    pub = _ed_encode(_ed_mul(a, _ED_BASE))
    r = _sha512_int(prefix, msg) % L_ORDER
    r_enc = _ed_encode(_ed_mul(r, _ED_BASE))
    k = _sha512_int(r_enc, pub, msg) % L_ORDER
    return pub, r_enc + ((r + k * a) % L_ORDER).to_bytes(32, "little")


def make_header(rng, bn: int, size: int, parent: bytes | None = None) -> bytes:
    """A random SCALE header: parent | compact(bn) | body | data root
    (the bench's header_proof generator); a random parent unless named."""
    if parent is None:
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


def timed_prove(air, case, cfg):
    """-> (proof, seconds, per-phase seconds, launches per entry); a
    synchronize at each phase end."""
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


def timed_verify(air, proof, pubs, log_n, cfg):
    """-> (accepted, seconds, launches per entry)."""
    before = dict(pc.launches)
    t0 = time.perf_counter()
    ok = verifier.verify(air, proof, pubs, log_n, cfg)
    torch.cuda.synchronize()
    return ok, time.perf_counter() - t0, {k: pc.launches[k] - before[k]
                                          for k in before}


def flipped(proof, field: str):
    """A copy of the proof with one bit of one opened row flipped."""
    bad = copy.copy(proof)
    rows = getattr(proof, field).clone()
    rows[0, 0] ^= 1
    setattr(bad, field, rows)
    return bad


def phase_slice():
    rng = np.random.default_rng(3)
    air, log_n, cfg = slice_setup()
    cases = [header_case(air, make_header(rng, 1000 + i, HEADER_BYTES))
             for i in range(3)]

    _, cold, _, _ = timed_prove(air, cases[0], cfg)
    warm = [timed_prove(air, c, cfg) for c in cases]
    best = min(range(3), key=lambda i: warm[i][1])
    proof, best_s, split, per_prove = warm[best]
    log("slice", air=f"HeaderAir({HEADER_CHUNKS})", rows=air.n_rows,
        cols=air.num_cols, header_bytes=HEADER_BYTES, cold_s=f"{cold:.4f}",
        warm_s=",".join(f"{w[1]:.4f}" for w in warm), warm_min_s=f"{best_s:.4f}")
    log("slice-split", **{k: f"{v:.4f}" for k, v in split.items()})

    ok, verify_s, per_verify = timed_verify(air, proof, cases[best][1], log_n,
                                            cfg)
    if not ok:
        raise AssertionError("the port verifier rejected an honest proof")
    if verifier.verify(air, flipped(proof, "trace_rows_a"), cases[best][1],
                       log_n, cfg):
        raise AssertionError("the port verifier accepted a tampered proof")
    log("slice-verify", accepted=True, tampered_rejected=True,
        verify_s=f"{verify_s:.4f}")
    log("slice-launches",
        **{f"{k}_per_warm_prove": v for k, v in per_prove.items()},
        **{f"{k}_per_verify": v for k, v in per_verify.items()},
        per_warm_prove=sum(per_prove.values()),
        per_verify=sum(per_verify.values()))


class RangeAir(Air):
    """Two committed columns, both range-checked to [0, n_rows) via LogUp;
    one public pins the first row of column 0."""
    num_cols = 2
    num_publics = 1

    def lookup_range_columns(self):
        return [0, 1]

    def first_row(self, alg, local, publics, consts=()):
        return [alg.sub(local[0], alg.lift(publics[0]))]


class RamAir(Air):
    """One committed value column; mult/load/addr/active flags in constant
    columns. Rows 0-7 store addresses 100..107, rows 12-19 load them
    reversed, row 24 loads 100 again, row 25 is a store nobody loads."""
    num_cols = 1
    num_publics = 1

    def ram_multiset(self):
        return (0, 1, 2, 3, 0)          # mult, load, addr, active; value column

    def constant_columns(self, n_rows):
        out = np.zeros((4, n_rows), dtype=np.uint64)
        for i in range(8):
            out[:, i] = (2 if i == 0 else 1, 0, 100 + i, 1)
            out[:, 12 + i] = (0, 1, 107 - i, 1)
        out[:, 24] = (0, 1, 100, 1)
        out[:, 25] = (0, 0, 200, 1)
        return out

    @staticmethod
    def values():
        vals = np.zeros(32, dtype=np.uint64)
        vals[:8] = 1000 + 7 * np.arange(8)
        vals[12:20] = vals[:8][::-1]
        vals[24], vals[25] = vals[0], 424242
        return vals[None, :]


def phase_aux_small():
    """The LogUp and RAM aux phases on the card against the CPU."""
    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
    rng = np.random.default_rng(11)
    in_range = rng.integers(0, 64, (2, 64), dtype=np.uint64)
    out_of_range = in_range.copy()
    out_of_range[1, 17] = 64 + 3
    for name, air, log_n, good, bad in (
            ("range", RangeAir(), 6, in_range, out_of_range),
            ("ram", RamAir(), 5, RamAir.values(), None)):
        pub = int(good[0, 0])
        on_card = prover.prove(air, gl.to_fp(good), [gl.to_fp(pub)], cfg)
        on_cpu = prover.prove(air, gl.to_fp(good, "cpu"),
                              [gl.to_fp(pub, "cpu")], cfg)
        if serialize.payload(on_card) != serialize.payload(on_cpu):
            raise AssertionError(f"{name}: payloads differ between CUDA and CPU")
        if not verifier.verify(air, on_card, [gl.to_fp(pub)], log_n, cfg):
            raise AssertionError(f"{name}: honest proof rejected")
        if verifier.verify(air, flipped(on_card, "aux_rows_a"),
                           [gl.to_fp(pub)], log_n, cfg):
            raise AssertionError(f"{name}: forged aux row accepted")
        rejected = "n/a"
        if bad is not None:
            forged = prover.prove(air, gl.to_fp(bad), [gl.to_fp(pub)], cfg)
            if verifier.verify(air, forged, [gl.to_fp(pub)], log_n, cfg):
                raise AssertionError(f"{name}: out-of-range value accepted")
            rejected = True
        log("aux-small", air=name, aux_cols=prover.total_aux_cols(air),
            payload_bytes=len(serialize.payload(on_card)), identical=True,
            accepted=True, forged_aux_row_rejected=True,
            out_of_range_rejected=rejected)


STATEMENT_CFG = prover.StarkConfig(rate_bits=2, num_queries=42,
                                   final_poly_len=8,
                                   pow_bits=prover.PRODUCTION_POW_BITS)
STATEMENTS = ("merkle", "chain", "sha512", "ed25519")
ED_B = 13                        # the production shard: 8192 rows, 32 lanes
ED_LANES = 1 << (ED_B - 8)


def _random_bytes32(rng, count: int):
    return [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(count)]


def _be_words(raw: bytes):
    return [int.from_bytes(raw[4 * i:4 * i + 4], "big") for i in range(8)]


def _digest(words) -> bytes:
    return b"".join(int(w).to_bytes(4, "big") for w in words)


def precommit(rng) -> bytes:
    """A seeded 53-byte GRANDPA precommit message."""
    return scale.encode_precommit_bytes(
        bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
        int(rng.integers(1, 1 << 32)), int(rng.integers(1, 1 << 16)),
        int(rng.integers(1, 1 << 16)))


def signed_lanes(rng, count: int, message: bytes):
    """-> (public keys, signatures, (A, R, s, h) lanes) of `count` seeded
    keys, every one signing `message`."""
    pubs, sigs = [], []
    for _ in range(count):
        pub, sig = ed25519_sign(bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                                message)
        pubs.append(pub)
        sigs.append(sig)
    return pubs, sigs, sigs_from_justification(pubs, sigs, [True] * count,
                                               message)


def statement_case(name: str):
    """-> (air, (trace, publics) on the card, log_n, witness seconds, the
    field of the proof to tamper with). Inputs come from seeds; the public
    output is held against hashlib."""
    t0 = time.perf_counter()
    if name == "merkle":
        # a header_range_256 range commitment: 200 roots, zero-padded
        tree = consts.HEADER_RANGE_TREE_SIZE_SMALL
        roots = _random_bytes32(np.random.default_rng(21), 200)
        leaves = roots + [bytes(32)] * (tree - len(roots))
        air = MerkleSha256Air([_be_words(leaf) for leaf in leaves])
        trace, publics, root = air.make_trace()
        if _digest(root) != commitments.range_commitments(roots, roots, tree)[0]:
            raise AssertionError("MerkleSha256Air root != hashlib Merkle root")
        field = "trace_rows_b"
    elif name == "chain":
        n_max = consts.MAX_AUTHORITY_SET_SIZE
        keys = _random_bytes32(np.random.default_rng(22), n_max)
        air = ChainedSha256Air(n_max)
        trace, publics, out = air.make_trace(air.pubkeys_to_words(keys, n_max),
                                             n_max)
        if _digest(out) != commitments.authority_set_hash(keys):
            raise AssertionError("ChainedSha256Air digest != hashlib chain")
        field = "const_rows_a"
    elif name == "sha512":
        # 30 lanes (a, r, s, h) with h = SHA-512(r|a|M) mod L, all the AIR
        # binds, and 2 disabled lanes
        rng = np.random.default_rng(23)
        message = bytes(rng.integers(0, 256, consts.ENCODED_PRECOMMIT_LENGTH,
                                     dtype=np.uint8))
        lanes = []
        for _ in range(30):
            a, r, s = _random_bytes32(rng, 3)
            h = int.from_bytes(hashlib.sha512(r + a + message).digest(),
                               "little") % L_ORDER
            lanes.append((a, r, int.from_bytes(s, "little") >> 4, h))
        air = Sha512ChallengeAir(lanes + [dummy_sig()] * 2, message, B=13)
        trace, publics = air.make_trace()      # checks each digest (hashlib)
        if publics[0] != 32:
            raise AssertionError("Sha512ChallengeAir lane count")
        field = "aux_rows_a"
    elif name == "ed25519":
        # one production shard: 32 lanes signed by 32 seeded keys over a
        # seeded precommit (signing is not witness time)
        message = precommit(np.random.default_rng(24))
        lanes = signed_lanes(np.random.default_rng(25), ED_LANES, message)[2]
        t0 = time.perf_counter()
        air = Ed25519VerifyAir(lanes, B=ED_B)
        trace, publics = air.make_trace_vec()  # checks [s]B == R + [h]A
        if publics != air.publics_list() or publics[0] != ED_LANES:
            raise AssertionError("Ed25519VerifyAir publics")
        field = "aux_rows_a"
    else:
        raise SystemExit(f"chip_smoke: unknown statement {name!r}")
    witness_s = time.perf_counter() - t0
    if (trace.shape != (air.num_cols, air.n_rows)
            or trace.device != default_device()):
        raise AssertionError(f"{name}: trace {tuple(trace.shape)} on {trace.device}")
    case = (trace, [gl.to_fp(int(v)) for v in publics])
    return air, case, air.n_rows.bit_length() - 1, witness_s, field


def phase_statement(name: str):
    cfg = STATEMENT_CFG
    air, case, log_n, witness_s, field = statement_case(name)
    torch.cuda.reset_peak_memory_stats()
    _, cold, _, _ = timed_prove(air, case, cfg)
    proof, warm, split, per_prove = timed_prove(air, case, cfg)
    peak = torch.cuda.max_memory_allocated()
    ok, verify_s, per_verify = timed_verify(air, proof, case[1], log_n, cfg)
    if not ok:
        raise AssertionError(f"{name}: the port verifier rejected an honest proof")
    if verifier.verify(air, flipped(proof, field), case[1], log_n, cfg):
        raise AssertionError(f"{name}: the port verifier accepted a tampered proof")
    log("statement", air=type(air).__name__, rows=air.n_rows,
        cols=air.num_cols, aux_cols=prover.total_aux_cols(air),
        consts=air.constant_columns(2).shape[0],
        lde=air.n_rows << cfg.rate_bits, public_output="hashlib",
        witness_s=f"{witness_s:.3f}", cold_s=f"{cold:.4f}",
        warm_s=f"{warm:.4f}", verify_s=f"{verify_s:.4f}", accepted=True,
        tampered_rejected=field, payload_bytes=len(serialize.payload(proof)),
        peak_memory_bytes=peak)
    log("statement-split", air=type(air).__name__,
        **{k: f"{v:.4f}" for k, v in split.items()})
    log("statement-launches", air=type(air).__name__,
        **{f"{k}_per_warm_prove": v for k, v in per_prove.items()},
        **{f"{k}_per_verify": v for k, v in per_verify.items()})
    del air, proof, case        # with the air goes its cached constant LDE
    torch.cuda.empty_cache()


def ed25519_small_payload(dev=None):
    """-> (payload, prove seconds) of Ed25519VerifyAir(B=8) with one signed
    lane, proved on `dev` (the card when None)."""
    message = precommit(np.random.default_rng(26))
    lanes = signed_lanes(np.random.default_rng(27), 1, message)[2]
    air = Ed25519VerifyAir(lanes, B=8)
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4,
                             pow_bits=8)
    trace, publics = air.make_trace_vec(dev)
    t0 = time.perf_counter()
    proof = prover.prove(air, trace, [gl.to_fp(v, dev) for v in publics], cfg)
    return serialize.payload(proof), time.perf_counter() - t0


def ed25519_small_payload_on_cpu():
    """ed25519_small_payload on the CPU with half its cores, for a process
    of its own (its ~1 minute then runs beside the card's checks, at the
    lowest priority)."""
    os.nice(19)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    return ed25519_small_payload("cpu")


def phase_ed25519_small(on_cpu):
    """Ed25519VerifyAir(B=8) proved on the card against `on_cpu`, the same
    proof from the CPU path (what the CPU tests hold against the JAX
    package): identical payloads."""
    on_card, cuda_s = ed25519_small_payload()
    if on_card != on_cpu[0]:
        raise AssertionError("Ed25519VerifyAir(8) payloads differ between "
                             "CUDA and CPU")
    log("ed25519-small", air="Ed25519VerifyAir(B=8)", rows=256,
        payload_bytes=len(on_card), identical=True, cuda_s=f"{cuda_s:.3f}",
        cpu_s=f"{on_cpu[1]:.3f}")


# -- recursion and the reduce ---------------------------------------------------

REC_LOG_N = 3                    # the inner FibonacciAir: 8 rows
REC_CFG = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
# the level-1 proof that the two-level case recurses: a longer final
# polynomial keeps the level-2 machine small (tests/test_recursion_air.py)
REC_CFG1 = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=32)
REC_LINKS = [(0, 2, 1, 0)]       # res_A == a0_B
REC_EXPOSE = [(0, 0), (0, 1), (1, 2)]    # the claim: a0_A, b0_A, res_B
# scripts/prove_reduce_streamed.py: two PoseidonChainAir proofs of 2
# permutations, inner rate 4, outer rate 2 / 42 queries; the inner proofs
# at 15 queries (the script's 21 give 2^19 rows: a depth cut, so that the
# leaf fits the run's time)
RED_INNER = prover.StarkConfig(rate_bits=4, num_queries=15, final_poly_len=8,
                               pow_bits=prover.PRODUCTION_POW_BITS)
RED_OUTER = prover.StarkConfig(rate_bits=2, num_queries=42, final_poly_len=8,
                               pow_bits=prover.PRODUCTION_POW_BITS)
RED_PERMS, RED_LOG_N = 2, 6
# the outer machine the JAX package's reduce_air_for gives for that claim
RED_SHAPE = dict(recorded_rows=247718, n_rows=1 << 18, K=750, cols=789,
                 consts=274)


def fib_children(dev):
    """Two chained FibonacciAir(8) claims proved on `dev`: B starts where A
    ends. -> [(air, proof, publics, log_n, config)] x 2."""
    air = FibonacciAir()
    n = 1 << REC_LOG_N
    trace_a, pub_a = FibonacciAir.make_trace(n, device=dev)
    a_last, b_last = (int(v) for v in gl.from_fp(trace_a[:, -1]))
    trace_b, pub_b = FibonacciAir.make_trace(n, a_last, b_last, device=dev)
    children = []
    for trace, pub in ((trace_a, pub_a), (trace_b, pub_b)):
        pubs = [gl.to_fp(p, dev) for p in pub]
        children.append((air, prover.prove(air, trace, pubs, REC_CFG), pubs,
                         REC_LOG_N, REC_CFG))
    return children, (trace_a, trace_b), (pub_a, pub_b)


REC_PROOFS = ("recursive", "streamed", "reduce", "map_reduce", "level1")


def recursion_small(dev, names=REC_PROOFS):
    """The recursion-small proofs named in `names`, on `dev`: -> ({name:
    payload}, {name: (outer air, proof, publics)}, (the level-2 machine's
    recording of the level-1 proof and its trace digest, when level1 is
    named))."""
    from vectorx_tpu_torch.parallel import aggregate as agg
    children, traces, pubs = fib_children(dev)
    air, inner, inner_pubs, _, _ = children[0]

    def map_reduce():
        node = map_prove.map_reduce_prove(
            air, list(traces), [[gl.to_fp(p, dev) for p in pu] for pu in pubs],
            agg.ChainLayout(start=(0,), end=(2,)), REC_CFG, devices=[dev])
        return node.air, node.proof, node.publics

    make = {
        "recursive": lambda: ra.prove_recursive(
            air, inner, inner_pubs, REC_LOG_N, REC_CFG, REC_CFG, device=dev),
        "streamed": lambda: ra.prove_recursive(
            air, inner, inner_pubs, REC_LOG_N, REC_CFG, REC_CFG, stream=True,
            device=dev),
        "reduce": lambda: ra.prove_reduce(children, REC_LINKS, REC_EXPOSE,
                                          REC_CFG, device=dev),
        "map_reduce": map_reduce,
        "level1": lambda: ra.prove_recursive(
            air, inner, inner_pubs, REC_LOG_N, REC_CFG, REC_CFG1, device=dev),
    }
    out = {name: make[name]() for name in names}
    level2 = (None, None)
    if "level1" in out:
        # the two-level machine's recording of the level-1 proof
        l1_air, l1_proof, l1_pubs = out["level1"]
        mb = ra.MachineBuilder()
        cells = [mb.pin_public(v) for v in l1_pubs]
        ra.record_stark_verify(mb, l1_air, l1_proof, cells,
                               l1_air.n_rows.bit_length() - 1, REC_CFG1)
        l2_trace, _ = ra.RecursionAir(mb).make_trace("cpu")
        level2 = (mb, hashlib.sha256(gl.to_u64(l2_trace).tobytes())
                  .hexdigest())
    payloads = {k: serialize.payload(v[1]) for k, v in out.items()}
    return payloads, out, level2


def recursion_small_on_cpu(names):
    """recursion_small's payloads (and level-2 digest) for `names` on the
    CPU, for a process of its own that runs beside the card's paths at the
    lowest priority, on one thread (the CPU route's Poseidon is numpy on
    one core): the host work of the card's paths goes first."""
    os.nice(19)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    payloads, _, (_, digest) = recursion_small(torch.device("cpu"), names)
    return payloads, digest, time.perf_counter() - t0


def verify_outer(name, vair, proof, pubs, cfg):
    """The standard verifier on an outer proof against the claim-shape
    rebuild `vair`; a claim with one public changed is refused."""
    dev = proof.trace_cap.device
    log_n = vair.n_rows.bit_length() - 1
    fp = [gl.to_fp(int(p), dev) for p in pubs]
    if not verifier.verify(vair, proof, fp, log_n, cfg):
        raise AssertionError(f"{name}: the outer proof was rejected")
    bad = list(pubs)
    bad[-1] = (int(bad[-1]) + 1) % gl.MODULUS
    if verifier.verify(vair, proof, [gl.to_fp(p, dev) for p in bad], log_n,
                       cfg):
        raise AssertionError(f"{name}: a tampered claim was accepted")


def phase_recursion_small():
    """FibonacciAir(8) recursed on the card: prove_recursive, the streamed
    record, a two-child reduce with links and expose, map_reduce_prove over
    two shards, and a RecursionAir proof recursed (the two-level case).
    Each outer proof verifies against the verifier's claim-shape rebuild
    and refuses a tampered claim; the level-2 machine is proved and
    verified here. -> (payloads, level-2 trace digest, seconds), which
    compare_recursion_small holds against the CPU's."""
    from vectorx_tpu_torch.parallel import aggregate as agg
    dev = default_device()
    t0 = time.perf_counter()
    payloads, out, (mb2, digest2) = recursion_small(dev)
    cuda_s = time.perf_counter() - t0
    air = FibonacciAir()
    shape = [(air, REC_LOG_N, REC_CFG, 3)] * 2
    for name, vair in (
            ("recursive", ra.outer_air_for(air, REC_LOG_N, REC_CFG, 3)),
            ("streamed", ra.outer_air_for(air, REC_LOG_N, REC_CFG, 3,
                                          stream=True)),
            ("reduce", ra.reduce_air_for(shape, REC_LINKS, REC_EXPOSE)),
            ("level1", ra.outer_air_for(air, REC_LOG_N, REC_CFG, 3))):
        oair, proof, pubs = out[name]
        if vair.schedule_digest() != oair.schedule_digest():
            raise AssertionError(f"{name}: the claim-shape rebuild differs")
        verify_outer(name, vair, proof, pubs,
                     REC_CFG1 if name == "level1" else REC_CFG)
    node = agg.Node(*out["map_reduce"], log_n=out["map_reduce"][0].n_rows
                    .bit_length() - 1, config=REC_CFG,
                    layout=agg.ChainLayout(start=(0,), end=(1,)))
    if not agg.verify_aggregate(node, shape, REC_LINKS, [(0, 0), (1, 2)]):
        raise AssertionError("verify_aggregate rejected map_reduce_prove's node")
    # the two-level case: the level-2 machine proved and verified here
    l1_air = out["level1"][0]
    l2 = ra.RecursionAir(mb2)
    trace2, pubs2 = l2.make_trace(dev)
    t1 = time.perf_counter()
    proof2 = prover.prove(l2, trace2, [gl.to_fp(p, dev) for p in pubs2],
                          REC_CFG)
    l2_s = time.perf_counter() - t1
    vair2 = ra.outer_air_for(l1_air, l1_air.n_rows.bit_length() - 1,
                             REC_CFG1, len(pubs2))
    if vair2.schedule_digest() != l2.schedule_digest():
        raise AssertionError("level 2: the claim-shape rebuild differs")
    verify_outer("level2", vair2, proof2, pubs2, REC_CFG)
    log("recursion-small", inner=f"FibonacciAir({1 << REC_LOG_N})",
        verified_and_tampered_refused="|".join(list(out) + ["level2"]),
        **{f"{k}_outer": f"{v[0].n_rows}x{v[0].num_cols}+{v[0].num_consts}"
           for k, v in out.items()},
        level2=f"{l2.n_rows}x{l2.num_cols}+{l2.num_consts}",
        level2_prove_s=f"{l2_s:.3f}", cuda_s=f"{cuda_s:.3f}")
    return payloads, digest2, cuda_s


def compare_recursion_small(on_card, on_cpu) -> None:
    """Every recursion-small payload from the card equals the CPU's (a
    process of its own proved them), and the level-2 machine records the
    same trace from either level-1 proof."""
    payloads, digest2, cuda_s = on_card
    cpu_payloads, cpu_digest, cpu_s = {}, None, []
    for part_payloads, part_digest, part_s in on_cpu:
        cpu_payloads.update(part_payloads)
        cpu_digest = cpu_digest or part_digest
        cpu_s.append(f"{part_s:.3f}")
    if set(cpu_payloads) != set(payloads):
        raise AssertionError(f"recursion-small: the CPU proved {cpu_payloads}")
    for name, pay in payloads.items():
        if pay != cpu_payloads[name]:
            raise AssertionError(f"recursion-small {name}: payloads differ "
                                 "between CUDA and CPU")
    if digest2 != cpu_digest:
        raise AssertionError("level 2: the recorded traces differ between "
                             "the card's and the CPU's level-1 proofs")
    log("recursion-small-cpu", identical="|".join(payloads),
        level2_trace_equal=True, cuda_s=f"{cuda_s:.3f}",
        cpu_s_by_process=",".join(cpu_s))


def phase_reduce_streamed():
    """scripts/prove_reduce_streamed.py on the card: two PoseidonChainAir
    proofs linked A.out == B.in, reduced to ONE outer proof through the
    streamed recorder (value RAM on) at outer rate 2, 42 queries, pow 16;
    the outer machine's shape against the JAX package's; verified against
    the reduce_air_for rebuild; the combined claim A.in ‖ B.out checked and
    a tampered claim refused. Seconds by stage and peak memory."""
    dev = default_device()
    air = PoseidonChainAir()
    x0 = list(range(1, PWIDTH + 1))
    tr_a, pub_a, mid = PoseidonChainAir.make_trace(x0, RED_PERMS, dev)
    tr_b, pub_b, out = PoseidonChainAir.make_trace(mid, RED_PERMS, dev)
    children, inner_s = [], []
    for tr, pub in ((tr_a, pub_a), (tr_b, pub_b)):
        pubs = [gl.to_fp(int(p), dev) for p in pub]
        t0 = time.perf_counter()
        proof = prover.prove(air, tr, pubs, RED_INNER)
        torch.cuda.synchronize()
        inner_s.append(time.perf_counter() - t0)
        if not verifier.verify(air, proof, pubs, RED_LOG_N, RED_INNER):
            raise AssertionError("an inner PoseidonChainAir proof was rejected")
        children.append((air, proof, list(pub), RED_LOG_N, RED_INNER))
    links = [(0, PWIDTH + i, 1, i) for i in range(PWIDTH)]
    expose = ([(0, i) for i in range(PWIDTH)]
              + [(1, PWIDTH + i) for i in range(PWIDTH)])

    split = {}
    last = [time.perf_counter()]

    def mark(phase):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[phase] = now - last[0]
        last[0] = now

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    last[0] = t0
    oair, oproof, opubs = ra.prove_reduce(children, links, expose, RED_OUTER,
                                          stream=True, device=dev, timer=mark)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    prove_peak = torch.cuda.max_memory_allocated()
    if not oair.has_ram:
        raise AssertionError("stream=True did not engage the value RAM")
    got = dict(recorded_rows=len(oair.mb.rows), n_rows=oair.n_rows, K=oair.K,
               cols=oair.num_cols, consts=oair.num_consts)
    if got != RED_SHAPE:
        raise AssertionError(f"outer machine {got} != {RED_SHAPE}")
    olog = oair.n_rows.bit_length() - 1
    shapes = [(air, RED_LOG_N, RED_INNER, len(pub_a)),
              (air, RED_LOG_N, RED_INNER, len(pub_b))]
    t0 = time.perf_counter()
    vair = ra.reduce_air_for(shapes, links, expose, stream=True)
    rebuild_s = time.perf_counter() - t0
    if vair.schedule_digest() != oair.schedule_digest():
        raise AssertionError("reduce_air_for's schedule differs")
    del oair
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opubs_fp = [gl.to_fp(int(p), dev) for p in opubs]
    t0 = time.perf_counter()
    ok = verifier.verify(vair, oproof, opubs_fp, olog, RED_OUTER)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    verify_peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise AssertionError("the reduce proof was rejected")
    if ([int(p) for p in opubs[:PWIDTH]] != x0
            or [int(p) for p in opubs[PWIDTH:2 * PWIDTH]] != list(out)):
        raise AssertionError("the combined claim is not A.in ‖ B.out")
    bad = list(opubs)
    bad[PWIDTH] = (bad[PWIDTH] + 1) % gl.MODULUS
    if verifier.verify(vair, oproof, [gl.to_fp(p, dev) for p in bad], olog,
                       RED_OUTER):
        raise AssertionError("a tampered combined claim was accepted")
    log("reduce-streamed", children=2, inner=f"PoseidonChainAir({RED_PERMS})",
        inner_rows=1 << RED_LOG_N, **got,
        lde=got["n_rows"] << RED_OUTER.rate_bits,
        inner_prove_s=",".join(f"{s:.3f}" for s in inner_s),
        rebuild_s=f"{rebuild_s:.3f}", verify_s=f"{verify_s:.3f}",
        accepted=True, claim="A.in|B.out", tampered_rejected=True,
        payload_bytes=len(serialize.payload(oproof)))
    log("reduce-streamed-split", prove_s=f"{total_s:.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in split.items()})
    log("reduce-streamed-memory", resident_before_bytes=base,
        prove_peak_bytes=prove_peak, verify_peak_bytes=verify_peak,
        card=repr(nvidia_smi()))
    del vair, oproof, children
    torch.cuda.empty_cache()


# the outer machine the JAX package's outer_air_for gives for the leaf's
# claim (HeaderAir(1), log_n 7, the leaf's inner config, 89 publics, streamed)
LEAF_SHAPE = dict(recorded_rows=519571, n_rows=1 << 19, K=725, cols=764,
                  consts=336)


def phase_recursion_leaf():
    """The JAX package's scripts/prove_recursion_leaf.py on the card: a
    real 120-byte header proved through HeaderAir(1) at inner rate 10, 9
    queries, pow 16, recorded streamed into one outer machine (its shape
    against the JAX package's), proved at outer rate 1, 84 queries, pow
    16, verified against the claim-shape rebuild (same schedule digest) and
    refused under a tampered public. Seconds by stage and the peak memory
    of the outer prove and of the verify."""
    dev = default_device()
    split = {}
    last = [time.perf_counter()]

    def mark(phase):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[phase] = now - last[0]
        last[0] = now
        if phase == "witness":           # the outer prove starts here
            torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    t0 = last[0] = time.perf_counter()
    leaf = rl.prove_leaf(device=dev, timer=mark)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    prove_peak = torch.cuda.max_memory_allocated()
    oair = leaf.outer_air
    if not oair.has_ram:
        raise AssertionError("the leaf's record did not engage the value RAM")
    got = dict(recorded_rows=len(oair.mb.rows), n_rows=oair.n_rows, K=oair.K,
               cols=oair.num_cols, consts=oair.num_consts)
    if got != LEAF_SHAPE:
        raise AssertionError(f"outer machine {got} != {LEAF_SHAPE}")
    if leaf.outer_publics != leaf.inner_publics:
        raise AssertionError("the leaf's outer publics are not the header's")
    digest = oair.schedule_digest()
    del oair, leaf.outer_air
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vair = rl.leaf_verifier_air(device=dev)
    rebuild_s = time.perf_counter() - t0
    if vair.schedule_digest() != digest:
        raise AssertionError("the leaf's claim-shape rebuild differs")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ok = rl.verify_leaf(vair, leaf.outer_proof, leaf.outer_publics)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    verify_peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise AssertionError("the leaf proof was rejected")
    bad = list(leaf.outer_publics)
    bad[0] = (bad[0] + 1) % gl.MODULUS
    if rl.verify_leaf(vair, leaf.outer_proof, bad):
        raise AssertionError("the leaf proof was accepted under a tampered "
                             "public")
    log("recursion-leaf", inner="HeaderAir(1)", inner_rows=128,
        inner_cols=leaf.inner_air.num_cols, inner_lde=128 << 10, **got,
        lde=got["n_rows"] << rl.LEAF_OUTER.rate_bits,
        rebuild_s=f"{rebuild_s:.3f}", verify_s=f"{verify_s:.3f}",
        accepted=True, tampered_rejected=True,
        payload_bytes=len(serialize.payload(leaf.outer_proof)))
    log("recursion-leaf-split", prove_s=f"{total_s:.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in split.items()})
    log("recursion-leaf-memory", prove_peak_bytes=prove_peak,
        verify_peak_bytes=verify_peak, card=repr(nvidia_smi()))
    del vair, leaf
    torch.cuda.empty_cache()


# -- the DSL and the GF(2^255-19) gadgets ---------------------------------------

DSL_CFG = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
FP_B, FP_L, FP_LOG_N = 8, 32, 8         # tests/test_gadget_fp25519.py's sizes
FP_CFG = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4)


class Fp25519OpsAir(Air):
    """tests/test_gadget_fp25519.py's AIR over the port's gadgets. Per
    row: m = a*b; d = m + a; e = d - b; f = e * D_CONST (all mod p), in
    8-bit limbs over 256 rows. Publics: [f mod 2^8 of row 0]."""

    num_publics = 1
    max_constraint_degree = 3

    def __init__(self):
        alloc = gfp.Allocator()
        self.a = alloc.take(FP_L)
        self.b = alloc.take(FP_L)
        self.mul = gfp.FpMul(alloc, FP_B)
        self.add = gfp.FpAddSub(alloc, FP_B, +1)
        self.sub = gfp.FpAddSub(alloc, FP_B, -1)
        self.cmul = gfp.FpMul(alloc, FP_B, b_const=D_CONST)
        self.num_cols = alloc.n
        self._lookups = alloc.lookups

    def lookup_range_columns(self):
        return self._lookups

    def _row_constraints(self, alg, local):
        a = [local[i] for i in self.a]
        b = [local[i] for i in self.b]
        cs = list(self.mul.constraints(alg, local, a, b))
        m = self.mul.c_limbs(local)
        cs += self.add.constraints(alg, local, m, a)
        d = self.add.d_limbs(local)
        cs += self.sub.constraints(alg, local, d, b)
        e = self.sub.d_limbs(local)
        cs += self.cmul.constraints(alg, local, e)
        return cs

    def transition(self, alg, local, next_row, publics, consts=(),
                   consts_next=()):
        return self._row_constraints(alg, local)

    def first_row(self, alg, local, publics, consts=()):
        return [alg.sub(local[self.cmul.c[0]], alg.lift(publics[0]))]

    def last_row(self, alg, local, publics, consts=()):
        return self._row_constraints(alg, local)

    def witness(self, a_vals, b_vals):
        """-> ((num_cols, 256) exact ints, publics, the f of each row)."""
        cols = np.zeros((self.num_cols, 1 << FP_LOG_N), dtype=np.object_)
        outs = []
        for r in range(1 << FP_LOG_N):
            a, bb = int(a_vals[r]), int(b_vals[r])
            for i in range(FP_L):
                cols[self.a[i], r] = (a >> (FP_B * i)) & 0xFF
                cols[self.b[i], r] = (bb >> (FP_B * i)) & 0xFF
            m = self.mul.fill(cols, r, a, bb)
            d = self.add.fill(cols, r, m, a)
            e = self.sub.fill(cols, r, d, bb)
            f = self.cmul.fill(cols, r, e)
            outs.append(f)
        return cols, [outs[0] & 0xFF], outs


def fp25519_inputs(seed: int = 31):
    """256 seeded pairs (a, b) of field elements, a first."""
    rng = np.random.default_rng(seed)
    draw = [int.from_bytes(rng.bytes(32), "little") % gfp.P25519
            for _ in range(2 << FP_LOG_N)]
    return draw[:1 << FP_LOG_N], draw[1 << FP_LOG_N:]


DSL_PROOFS = ("poseidon_dsl", "fp25519_ops")


def dsl_small(dev, tamper=DSL_PROOFS):
    """The DSL Poseidon chain AIR on PoseidonChainAir.make_trace(0..11, 1)
    and the GF(2^255-19) gadgets' fp-ops AIR, proved and verified on `dev`,
    and for those named in `tamper` a tampered public refused -> ({name:
    payload}, {name_stage: seconds})."""
    out, secs = {}, {}
    air, _ = build_poseidon_chain_air()
    trace, publics, _ = PoseidonChainAir.make_trace(list(range(12)), 1, dev)
    fp_air = Fp25519OpsAir()
    cols, fp_publics, _ = fp_air.witness(*fp25519_inputs())
    for name, a, tr, pub, log_n, cfg, k in (
            ("poseidon_dsl", air, trace, publics, 5, DSL_CFG, PWIDTH),
            ("fp25519_ops", fp_air, gl.to_fp(cols, dev), fp_publics,
             FP_LOG_N, FP_CFG, 0)):
        pubs = [gl.to_fp(int(p), dev) for p in pub]
        t0 = time.perf_counter()
        proof = prover.prove(a, tr, pubs, cfg)
        t1 = time.perf_counter()
        if not verifier.verify(a, proof, pubs, log_n, cfg):
            raise AssertionError(f"{name}: the proof was rejected")
        secs[f"{name}_prove"] = t1 - t0
        secs[f"{name}_verify"] = time.perf_counter() - t1
        if name in tamper:
            bad = list(pubs)
            bad[k] = gl.to_fp((int(pub[k]) + 1) % gl.MODULUS, dev)
            if verifier.verify(a, proof, bad, log_n, cfg):
                raise AssertionError(f"{name}: a tampered public was accepted")
        out[name] = serialize.payload(proof)
    return out, secs


def dsl_small_on_cpu():
    """dsl_small's payloads on the CPU, for a process of its own at the
    lowest priority (as recursion_small_on_cpu); the tampered publics of
    both proofs are refused here."""
    os.nice(19)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    payloads, _ = dsl_small(torch.device("cpu"))
    return payloads, time.perf_counter() - t0


def phase_dsl_small():
    """dsl_small on the card -> (payloads, seconds), which compare_dsl_small
    holds against the CPU's. The tampered publics are refused in the
    CPU's process, on the same bytes: a verify at ζ of these AIRs is
    launch-bound on the card (the fp-ops AIR's ~2.7M torch operations,
    20–27 s a verify on the card's host)."""
    t0 = time.perf_counter()
    on_card, secs = dsl_small(default_device(), tamper=())
    cuda_s = time.perf_counter() - t0
    log("dsl-small", proved="|".join(on_card), verified=True,
        fp25519_cols=Fp25519OpsAir().num_cols,
        cuda_s=f"{cuda_s:.3f}", **{f"{k}_s": f"{v:.3f}" for k, v in secs.items()})
    return on_card, cuda_s


def compare_dsl_small(on_card, on_cpu) -> None:
    """Every dsl-small payload from the card equals the CPU's."""
    (payloads, cuda_s), (cpu_payloads, cpu_s) = on_card, on_cpu
    if list(cpu_payloads) != list(payloads):
        raise AssertionError(f"dsl-small: the CPU proved {list(cpu_payloads)}")
    for name, payload in payloads.items():
        if payload != cpu_payloads[name]:
            raise AssertionError(f"dsl-small {name}: payloads differ between "
                                 "CUDA and CPU")
    log("dsl-small-cpu", identical="|".join(payloads),
        tampered_rejected="|".join(payloads),
        payload_bytes="|".join(str(len(p)) for p in payloads.values()),
        cuda_s=f"{cuda_s:.3f}", cpu_s=f"{cpu_s:.3f}")


class KindTimes:
    """While active: seconds and count of every prove and verify, by AIR
    class (the bundles call prover.prove and verifier.verify per proof)."""

    def __enter__(self):
        self.seconds, self.count = {}, {}
        self._saved = prover.prove, verifier.verify

        def timed(fn, what):
            def run(air, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(air, *args, **kwargs)
                torch.cuda.synchronize()
                key = f"{what}_{type(air).__name__}"
                self.seconds[key] = (self.seconds.get(key, 0.0)
                                     + time.perf_counter() - t0)
                self.count[key] = self.count.get(key, 0) + 1
                return out
            return run

        prover.prove = timed(self._saved[0], "prove")
        verifier.verify = timed(self._saved[1], "verify")
        return self

    def __exit__(self, *exc):
        prover.prove, verifier.verify = self._saved

    def fields(self):
        return {f"{k}_s": f"{v:.4f}x{self.count[k]}"
                for k, v in sorted(self.seconds.items())}


def must_refuse(what: str, fn) -> None:
    try:
        fn()
    except statements.VerificationError:
        return
    raise AssertionError(f"the bundle verifier accepted {what}")


BUNDLE_HEADERS = 2               # the depth cut of header_range (256 in use)


def phase_bundle_header_range():
    """One header_range bundle at production width: 2 chained 1990-byte
    headers (HeaderAir(16)), 256-leaf range trees, the 300-key authority
    chain, one Ed25519 shard and one SHA-512 shard of 32 signing lanes;
    verified after a serialization round trip."""
    cfg = STATEMENT_CFG
    rng = np.random.default_rng(41)
    trusted_block, set_id, round_ = 4000, 7, 2
    trusted_hash = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    headers, parent = [], trusted_hash
    for i in range(BUNDLE_HEADERS):
        headers.append(make_header(rng, trusted_block + 1 + i, HEADER_BYTES,
                                   parent))
        parent = hashlib.blake2b(headers[-1], digest_size=32).digest()
    target_block = trusted_block + BUNDLE_HEADERS
    message = scale.encode_precommit_bytes(parent, target_block, round_, set_id)
    pubs, sigs, _ = signed_lanes(np.random.default_rng(42), ED_LANES, message)
    set_hash = commitments.authority_set_hash(pubs)
    tree = consts.HEADER_RANGE_TREE_SIZE_SMALL

    def verify(bundle, target=target_block, set_hash=set_hash):
        return statements.verify_header_range(
            bundle, trusted_block, trusted_hash, set_id, set_hash, target, cfg)

    with KindTimes() as kinds:
        t0 = time.perf_counter()
        bundle = statements.prove_header_range(
            trusted_block, target_block, headers, pubs, sigs, set_id, round_,
            cfg, tree_size=tree, max_chunks=HEADER_CHUNKS,
            max_authorities=consts.MAX_AUTHORITY_SET_SIZE, ed_B=ED_B)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        # the serialization round trip, then the verify of what came back
        blob = statements.serialize_header_range(bundle, cfg)
        back, back_cfg = statements.deserialize_header_range(blob)
        if (back_cfg != cfg
                or statements.serialize_header_range(back, cfg) != blob):
            raise AssertionError("the header_range round trip differs")
        t0 = time.perf_counter()
        out = verify(back)
        verify_s = time.perf_counter() - t0
    fields = [scale.decode_header_bytes(h) for h in headers]
    want = (parent,) + tuple(commitments.range_commitments(
        [f["state_root"] for f in fields], [f["data_root"] for f in fields],
        tree))
    if out != want:
        raise AssertionError("verify_header_range outputs != hashlib's")
    must_refuse("a wrong target block", lambda: verify(back, target_block + 1))
    must_refuse("a wrong authority set",
                lambda: verify(back, set_hash=hashlib.sha256(b"x").digest()))
    log("bundle-header-range", headers=BUNDLE_HEADERS,
        header_bytes=HEADER_BYTES, tree_size=tree,
        max_authorities=consts.MAX_AUTHORITY_SET_SIZE, signers=ED_LANES,
        ed_B=ED_B, sig_shards=len(bundle.sig_proofs),
        sha512_shards=len(bundle.sha512_proofs), outputs="hashlib",
        prove_s=f"{prove_s:.4f}", round_trip_verify_s=f"{verify_s:.4f}",
        wrong_target_and_set_rejected=True, bundle_bytes=len(blob))
    log("bundle-header-range-kinds", **kinds.fields())
    del bundle, back
    torch.cuda.empty_cache()


ROTATE_CHUNKS = 128              # a 300-key ScheduledChange: 12,004 bytes


def epoch_end_header(rng, block_number: int, new_pubkeys) -> bytes:
    """A SCALE header whose digest holds one GRANDPA ScheduledChange log."""
    parent, state_root, extrinsics_root, data_root = (
        bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(4))
    records = b"".join(pk + b"\x01" + bytes(7) for pk in new_pubkeys)
    change = (b"\x01" + scale.encode_compact_u32(len(new_pubkeys)) + records
              + bytes(4))
    item = b"\x04" + b"FRNK" + scale.encode_compact_u32(len(change)) + change
    return (parent + scale.encode_compact_u32(block_number) + state_root
            + extrinsics_root + b"\x04" + item + data_root)


def phase_bundle_rotate():
    """One rotate bundle at production width: an epoch-end header that
    schedules 300 new keys (RotateHeaderAir(128)), the two 300-key chains,
    one Ed25519 and one SHA-512 shard of 32 current signers; verified after
    a serialization round trip."""
    cfg = STATEMENT_CFG
    rng = np.random.default_rng(51)
    block, set_id, round_ = 9000, 8, 3
    n_new = consts.MAX_AUTHORITY_SET_SIZE
    new_pubs = [ed25519_public_key(bytes(rng.integers(0, 256, 32,
                                                      dtype=np.uint8)))
                for _ in range(n_new)]
    header = epoch_end_header(rng, block, new_pubs)
    message = scale.encode_precommit_bytes(
        hashlib.blake2b(header, digest_size=32).digest(), block, round_, set_id)
    pubs, sigs, _ = signed_lanes(np.random.default_rng(52), ED_LANES, message)
    set_hash = commitments.authority_set_hash(pubs)

    def verify(bundle, set_hash=set_hash):
        return statements.verify_rotate(bundle, set_id, set_hash, cfg)

    with KindTimes() as kinds:
        t0 = time.perf_counter()
        bundle = statements.prove_rotate(
            block, header, pubs, sigs, set_id, round_, cfg,
            max_chunks=ROTATE_CHUNKS, max_authorities=n_new, ed_B=ED_B)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        # the serialization round trip, then the verify of what came back
        blob = statements.serialize_rotate(bundle, cfg)
        back, back_cfg = statements.deserialize_rotate(blob)
        if back_cfg != cfg or statements.serialize_rotate(back, cfg) != blob:
            raise AssertionError("the rotate round trip differs")
        t0 = time.perf_counter()
        out = verify(back)
        verify_s = time.perf_counter() - t0
    want = commitments.authority_set_hash(new_pubs)
    if out != want:
        raise AssertionError("verify_rotate output != the new set's hash")
    must_refuse("a wrong current set",
                lambda: verify(back, hashlib.sha256(b"x").digest()))
    log("bundle-rotate", header_bytes=len(header),
        window_bytes=len(bundle.window), new_keys=n_new, signers=ED_LANES,
        max_chunks=ROTATE_CHUNKS, ed_B=ED_B, output="authority_set_hash",
        prove_s=f"{prove_s:.4f}", round_trip_verify_s=f"{verify_s:.4f}",
        wrong_set_rejected=True, bundle_bytes=len(blob))
    log("bundle-rotate-kinds", **kinds.fields())
    del bundle, back
    torch.cuda.empty_cache()


# -- the CLI: python -m vectorx_tpu_torch on fixture directories ------------

CLI_TRUSTED = 246150             # the golden request's span, 246150 -> 246330
CLI_HEADERS = 180
CLI_FORGED_HEADERS = 20          # the refused requests' depth cut
CLI_SET_ID = 0x75
CLI_AUTHORITIES = consts.MAX_AUTHORITY_SET_SIZE
CLI_SIGNED = 240                 # 240 * 3 > 300 * 2; 200 * 3 is not
CLI_DIR = os.path.join("build", "chip_smoke_cli")
# runs the module as `python -m` does, recording the shapes of its
# duplex and sponge_rows launches as the main paths here do, and at exit
# writes its kernel launch counts and those shapes
CLI_COUNTED = ("import atexit, json, runpy, sys\n"
               "import chip_smoke as cs\n"
               "out = sys.argv.pop(1)\n"
               "duplex, sponge_rows = set(), set()\n"
               "cs.record_duplex_shapes(duplex)\n"
               "cs.record_sponge_shapes(sponge_rows)\n"
               "atexit.register(lambda: json.dump({'launches': dict(cs.pc.launches),"
               " 'duplex': sorted(duplex), 'sponge_rows': sorted(sponge_rows)},"
               " open(out, 'w')))\n"
               "runpy.run_module('vectorx_tpu_torch', run_name='__main__',"
               " alter_sys=True)\n")


def write_fixture(path: str, headers: dict, meta: dict, justifications: dict,
                  inputs: dict) -> str:
    """A FixtureSource directory: {block}.header hex files, meta.json,
    justifications.json and one {name}.json input file per entry."""
    os.makedirs(path, exist_ok=True)
    for block, header in headers.items():
        with open(os.path.join(path, f"{block}.header"), "w") as f:
            f.write(header.hex())
    for name, blob in (("meta", meta), ("justifications", justifications)):
        with open(os.path.join(path, f"{name}.json"), "w") as f:
            json.dump(blob, f)
    for name, raw in inputs.items():
        with open(os.path.join(path, f"{name}.json"), "w") as f:
            json.dump({"input": "0x" + raw.hex()}, f)
    return path


def justification_record(block: int, message: bytes, pubs, sigs, n_signed: int):
    """The indexer's record: the first n_signed lanes signed, the rest
    dummy."""
    return dict(block_number=block, signed_message=message.hex(),
                pubkeys=[p.hex() for p in pubs],
                signatures=[(s if i < n_signed else bytes(64)).hex()
                            for i, s in enumerate(sigs)],
                num_authorities=len(pubs),
                validator_signed=[i < n_signed for i in range(len(pubs))])


def authority_set(rng, message: bytes, count: int, n_signing: int):
    """-> (public keys, signatures) of `count` seeded keys, the first
    n_signing signing `message` (the others' signatures are dummies)."""
    pubs, sigs = [], []
    for i in range(count):
        seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        if i < n_signing:
            pub, sig = ed25519_sign(seed, message)
        else:
            pub, sig = ed25519_public_key(seed), bytes(64)
        pubs.append(pub)
        sigs.append(sig)
    return pubs, sigs


def start_cli(args, counts=None) -> tuple:
    """Start python3 -m vectorx_tpu_torch ARGS in a process of its own ->
    (process, start time). With `counts`, the module runs as `python -m`
    runs it and the process writes there its kernel launch counts and the
    shapes it gave duplex and sponge_rows."""
    cmd = ([sys.executable, "-c", CLI_COUNTED, counts] if counts
           else [sys.executable, "-m", "vectorx_tpu_torch"]) + list(args)
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def finish_cli(started) -> tuple:
    """-> (exit code, the JSON line it printed or its last error line,
    seconds from its start)."""
    proc, t0 = started
    out, err = proc.communicate(timeout=900)
    lines = (out if proc.returncode == 0 else err).strip()
    return (proc.returncode, (lines.splitlines() or [""])[-1],
            time.perf_counter() - t0)


def run_cli(args, counts=None) -> tuple:
    return finish_cli(start_cli(args, counts))


def cli_output(args, counts=None) -> tuple:
    """-> (output bytes, seconds) of a prove that must succeed."""
    rc, line, seconds = run_cli(args, counts)
    if rc != 0:
        raise AssertionError(f"vectorx_tpu_torch {' '.join(args)} failed: {line}")
    result = json.loads(line)
    if result.get("ok") is not True:
        raise AssertionError(f"no ok in {line}")
    return bytes.fromhex(result["output"][2:]), seconds


def header_range_fixture(root: str, n_headers: int, n_authorities: int,
                         n_signed: int, seed: int):
    """-> (fixture dir, headers, authorities) of a header_range request:
    a trusted block and n_headers chained 1990-byte headers after it, the
    justification at the target by n_authorities keys, n_signed signing.
    Also writes a second input with a wrong authority-set hash."""
    rng = np.random.default_rng(seed)
    headers = {CLI_TRUSTED: make_header(rng, CLI_TRUSTED, HEADER_BYTES)}
    parent = hashlib.blake2b(headers[CLI_TRUSTED], digest_size=32).digest()
    trusted_hash = parent
    for block in range(CLI_TRUSTED + 1, CLI_TRUSTED + 1 + n_headers):
        headers[block] = make_header(rng, block, HEADER_BYTES, parent)
        parent = hashlib.blake2b(headers[block], digest_size=32).digest()
    target = CLI_TRUSTED + n_headers
    message = scale.encode_precommit_bytes(parent, target, 3, CLI_SET_ID)
    pubs, sigs = authority_set(rng, message, n_authorities, n_signed)
    set_hash = commitments.authority_set_hash(pubs)
    write_fixture(root, headers,
                  {"authority_set_id": {str(CLI_TRUSTED): CLI_SET_ID},
                   "authorities": {str(CLI_TRUSTED): [p.hex() for p in pubs]},
                   "last_justified": {}},
                  {str(target): justification_record(target, message, pubs,
                                                     sigs, n_signed)},
                  {"input": abi.HeaderRangeInput(
                      CLI_TRUSTED, trusted_hash, CLI_SET_ID, set_hash,
                      target).encode(),
                   "input_wrong_set": abi.HeaderRangeInput(
                      CLI_TRUSTED, trusted_hash, CLI_SET_ID,
                      hashlib.sha256(b"x").digest(), target).encode()})
    return root, headers, pubs, sigs, message


def header_range_want(headers: dict, tree_size: int) -> bytes:
    """The host's 96-byte output: Blake2b of the last header, the range
    commitments over the state and data roots after the trusted block."""
    blocks = sorted(headers)[1:]
    fields = [scale.decode_header_bytes(headers[b]) for b in blocks]
    return hashlib.blake2b(headers[blocks[-1]], digest_size=32).digest() + \
        b"".join(commitments.range_commitments(
            [f["state_root"] for f in fields], [f["data_root"] for f in fields],
            tree_size))


def rotate_fixture(root: str, n_new: int, seed: int,
                   n_authorities: int = CLI_AUTHORITIES,
                   n_signed: int = CLI_SIGNED):
    """-> (fixture dir, the new keys) of a rotate request: an epoch-end
    header scheduling n_new keys, justified by n_authorities current keys
    (300 unless named) with n_signed signing (240)."""
    rng = np.random.default_rng(seed)
    block, set_id = 246400, CLI_SET_ID + 1
    new_pubs = [ed25519_public_key(bytes(rng.integers(0, 256, 32,
                                                      dtype=np.uint8)))
                for _ in range(n_new)]
    header = epoch_end_header(rng, block, new_pubs)
    message = scale.encode_precommit_bytes(
        hashlib.blake2b(header, digest_size=32).digest(), block, 3, set_id)
    pubs, sigs = authority_set(rng, message, n_authorities, n_signed)
    write_fixture(root, {block: header},
                  {"last_justified": {str(set_id): block},
                   "authority_set_id": {str(block): set_id},
                   "authorities": {str(block): [p.hex() for p in new_pubs]}},
                  {str(block): justification_record(block, message, pubs, sigs,
                                                    n_signed)},
                  {"input": abi.RotateInput(
                      set_id, commitments.authority_set_hash(pubs)).encode()})
    return root, new_pubs, header


def forged_fixtures(d: str, headers: dict, pubs, sigs, message) -> dict:
    """-> name: CLI arguments of the refused header_range requests: a wrong
    authority-set hash, a broken parent link, two thirds signed (200 of
    300: 200 * 3 is not > 300 * 2)."""
    prove = ["header_range", "prove", os.path.join(d, "input.json"),
             "--fixtures", d, "--output", os.path.join(d, "refused.json")]
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(d, "justifications.json")) as f:
        justifications = json.load(f)
    bad = dict(headers)
    block = CLI_TRUSTED + (len(headers) - 1) // 2 + 1
    bad[block] = bytes([bad[block][0] ^ 1]) + bad[block][1:]
    broken = write_fixture(os.path.join(CLI_DIR, "broken_link"), bad, meta,
                           justifications, {})
    target = max(headers)
    minority = write_fixture(
        os.path.join(CLI_DIR, "minority"), headers, meta,
        {str(target): justification_record(target, message, pubs, sigs,
                                           CLI_AUTHORITIES * 2 // 3)}, {})
    return {"wrong_set_hash": prove[:2] + [os.path.join(d, "input_wrong_set.json")]
            + prove[3:],
            "broken_link": prove[:4] + [broken] + prove[5:],
            "two_thirds_signed": prove[:4] + [minority] + prove[5:]}


def cli_result(what: str, done) -> bytes:
    """The output bytes of a finished prove that must have succeeded."""
    rc, line, _ = done
    if rc != 0:
        raise AssertionError(f"vectorx_tpu_torch {what} failed: {line}")
    result = json.loads(line)
    if result.get("ok") is not True:
        raise AssertionError(f"no ok in {line}")
    return bytes.fromhex(result["output"][2:])


def phase_cli(duplex_shapes: set, sponge_shapes: set):
    """-> (launches per kernel of the --stark process, whose duplex and
    sponge_rows shapes join the main paths' in the two sets; the output
    the [cli-header-range] command printed). The CLI, `python -m
    vectorx_tpu_torch`, on fixture directories, each run a process of its
    own: first the witness-level header_range at production width alone
    (180 chained 1990-byte headers in the 256 slots of 35,840 bytes, 300
    authorities with 240 signed); then side by side: the three forged requests (each must exit
    non-zero), rotate with 300 new keys and with 120 (whose 12,004-byte
    record window runs past the padded header: the bytes read there are
    255, as in the JAX package), the --stark route on a small request (2
    headers, tree size 16, 4 authorities with 3 signed; the CLI fixes the
    300-key chain and ed_B = 8), the same with --procs 2, rotate --stark
    on 2 new keys and 4 authorities, and `build` of each program. The bundle
    file the --stark route wrote (after its own verify) reads back to the
    same bytes here."""
    t0 = time.perf_counter()
    d, headers, pubs, sigs, message = header_range_fixture(
        os.path.join(CLI_DIR, "header_range"), CLI_HEADERS, CLI_AUTHORITIES,
        CLI_SIGNED, 61)
    # the refused requests at a cut depth: 20 headers (the honest one
    # keeps 180)
    fd, f_headers, f_pubs, f_sigs, f_message = header_range_fixture(
        os.path.join(CLI_DIR, "header_range_forged"), CLI_FORGED_HEADERS,
        CLI_AUTHORITIES, CLI_SIGNED, 62)
    jobs = {k: (v,) for k, v in forged_fixtures(fd, f_headers, f_pubs, f_sigs,
                                                f_message).items()}
    rotations = {}
    for n_new in (consts.MAX_AUTHORITY_SET_SIZE, 120):
        rd, new_pubs, header = rotate_fixture(
            os.path.join(CLI_DIR, f"rotate_{n_new}"), n_new, 70 + n_new)
        rotations[n_new] = new_pubs, header
        jobs[f"rotate_{n_new}"] = (["rotate", "prove",
                                    os.path.join(rd, "input.json"),
                                    "--fixtures", rd, "--output",
                                    os.path.join(rd, "output.json")],)
    sd, stark_headers, _, _, _ = header_range_fixture(
        os.path.join(CLI_DIR, "stark"), 2, 4, 3, 91)
    proof = os.path.join(sd, "bundle.bin")
    counts = os.path.join(sd, "launches.json")
    jobs["stark"] = (["header_range", "prove", os.path.join(sd, "input.json"),
                      "--fixtures", sd, "--tree-size", "16", "--stark",
                      "--proof", proof, "--output",
                      os.path.join(sd, "output.json")], counts)
    # the same request with its header proofs in two worker processes,
    # handed back through a checkpoint; and rotate --stark with --procs 2
    # (accepted and dropped) on a small request: 2 new keys, 4 current
    # authorities with 3 signed
    jobs["stark_procs"] = (["header_range", "prove",
                            os.path.join(sd, "input.json"), "--fixtures", sd,
                            "--tree-size", "16", "--stark", "--procs", "2",
                            "--checkpoint", os.path.join(sd, "checkpoint"),
                            "--proof", os.path.join(sd, "bundle_procs.bin"),
                            "--output", os.path.join(sd, "output_procs.json")],)
    rsd, rot_new, _ = rotate_fixture(os.path.join(CLI_DIR, "rotate_stark"), 2,
                                     93, 4, 3)
    jobs["rotate_stark_procs"] = (["rotate", "prove",
                                   os.path.join(rsd, "input.json"),
                                   "--fixtures", rsd, "--stark", "--procs",
                                   "2", "--output",
                                   os.path.join(rsd, "output.json")],)
    for program in ("header_range", "rotate"):
        jobs[f"build_{program}"] = ([program, "build", "--artifacts",
                                     os.path.join(CLI_DIR, f"build_{program}")],)
    fixture_s = time.perf_counter() - t0

    out, seconds = cli_output(["header_range", "prove",
                               os.path.join(d, "input.json"), "--fixtures", d,
                               "--output", os.path.join(d, "output.json")])
    if out != header_range_want(headers, consts.HEADER_RANGE_TREE_SIZE_SMALL):
        raise AssertionError("CLI header_range output != the host's")

    t0 = time.perf_counter()
    started = {what: start_cli(*job) for what, job in jobs.items()}
    with concurrent.futures.ThreadPoolExecutor(len(started)) as pool:
        done = dict(zip(started, pool.map(finish_cli, started.values())))
    side_by_side_s = time.perf_counter() - t0
    for what in ("wrong_set_hash", "broken_link", "two_thirds_signed"):
        if done[what][0] == 0:
            raise AssertionError(f"the CLI accepted {what}: {done[what][1]}")
    fields = {}
    for n_new, (new_pubs, header) in rotations.items():
        if (cli_result(f"rotate {n_new}", done[f"rotate_{n_new}"])
                != commitments.authority_set_hash(new_pubs)):
            raise AssertionError(f"CLI rotate output != the host's ({n_new})")
        padded = len(header) + (-len(header)) % 128
        window_end = header.index(new_pubs[0]) + consts.MAX_SUBARRAY_SIZE
        fields[f"new_{n_new}_command_s"] = f"{done[f'rotate_{n_new}'][2]:.3f}"
        fields[f"new_{n_new}_header_bytes"] = len(header)
        fields[f"new_{n_new}_window_past_end_bytes"] = max(window_end - padded, 0)
    for program in ("header_range", "rotate"):
        art = os.path.join(CLI_DIR, f"build_{program}", "manifest.json")
        if done[f"build_{program}"][0] != 0 or not os.path.exists(art):
            raise AssertionError(f"CLI build {program} failed: "
                                 f"{done[f'build_{program}'][1]}")
    want = header_range_want(stark_headers, 16)
    if cli_result("--stark", done["stark"]) != want:
        raise AssertionError("CLI --stark output != the host's")
    if cli_result("--stark --procs 2", done["stark_procs"]) != want:
        raise AssertionError("CLI --stark --procs 2 output != --procs 1's")
    if (cli_result("rotate --stark --procs 2", done["rotate_stark_procs"])
            != commitments.authority_set_hash(rot_new)):
        raise AssertionError("CLI rotate --stark --procs 2 output != the host's")
    with open(counts) as f:
        recorded = json.load(f)
    duplex_shapes.update(tuple(x) for x in recorded["duplex"])
    sponge_shapes.update(tuple(x) for x in recorded["sponge_rows"])
    # the CLI verified the bundle before it wrote the file; here the file
    # must read back to the same bytes ([bundle-header-range] verifies a
    # bundle that came back from its bytes)
    with open(proof, "rb") as f:
        blob = f.read()
    bundle, cfg = statements.deserialize_header_range(blob)
    if statements.serialize_header_range(bundle, cfg) != blob:
        raise AssertionError("the CLI's bundle file does not read back")

    log("cli-header-range", headers=CLI_HEADERS,
        slots=f"{consts.HEADER_RANGE_TREE_SIZE_SMALL}x{consts.MAX_HEADER_SIZE}",
        authorities=CLI_AUTHORITIES, signed=CLI_SIGNED, output="host",
        command_s=f"{seconds:.3f}", fixtures_s=f"{fixture_s:.1f}",
        refused="wrong_set_hash|broken_link|two_thirds_signed",
        refused_headers=CLI_FORGED_HEADERS,
        **{f"refused_{k}_s": f"{done[k][2]:.3f}"
           for k in ("wrong_set_hash", "broken_link", "two_thirds_signed")})
    log("cli-rotate", authorities=CLI_AUTHORITIES, signed=CLI_SIGNED,
        output="authority_set_hash", **fields)
    log("cli-stark", headers=2, tree_size=16, authorities=4, signed=3,
        config=json.dumps(dataclasses.asdict(cfg)).replace(" ", ""),
        output="host", command_s=f"{done['stark'][2]:.3f}",
        bundle_bytes=len(blob), file_round_trip="equal",
        procs2_output="equal", procs2_command_s=f"{done['stark_procs'][2]:.3f}",
        rotate_procs2_s=f"{done['rotate_stark_procs'][2]:.3f}",
        **{f"build_{p}_s": f"{done[f'build_{p}'][2]:.2f}"
           for p in ("header_range", "rotate")})
    log("cli-side-by-side", processes=len(jobs),
        seconds=f"{side_by_side_s:.1f}")
    return recorded["launches"], out


class FixtureChain:
    """The node in the service loop, over a FixtureSource directory: the
    fetcher surface of avail_rpc.AvailClient (for services/tools.py) and
    the operator's ChainClient, whose has_justification reads the
    indexer's store. Every block up to `head` has the set id
    set_id_of(block) and the fixture's authorities."""

    def __init__(self, source, store, authorities, head: int, set_id_of):
        self.source, self.store, self.authorities = source, store, authorities
        self.head, self.set_id_of = head, set_id_of

    async def get_head_block(self):
        return self.head

    async def get_head_block_number(self):
        return self.head

    async def get_header_scale(self, block):
        return self.source.get_header(block)

    async def get_headers_range(self, start, end):
        return [self.source.get_header(b) for b in range(start, end + 1)]

    async def get_authority_set_id(self, block):
        return self.set_id_of(block)

    async def get_authorities(self, block):
        return self.authorities

    async def last_justified_block(self, authority_set_id):
        return 0                         # the fixture's set is still live

    async def has_justification(self, block):
        return self.store.get_justification(block) is not None


class SimContract:
    """The operator's ContractClient over contract_sim.VectorXSim."""

    def __init__(self, sim):
        self.sim = sim

    async def latest_block(self):
        return self.sim.latest_block

    async def header_range_commitment_tree_size(self):
        return self.sim.header_range_commitment_tree_size

    async def authority_set_id_to_hash(self, set_id):
        return self.sim.authority_set_id_to_hash.get(set_id, bytes(32))

    async def block_height_to_header_hash(self, block):
        return self.sim.block_height_to_header_hash.get(block, bytes(32))

    async def request_header_range(self, inp):
        self.sim.request_header_range(inp.authority_set_id, inp.target_block)
        if self.sim.gateway.requests[-1].input != inp.encode():
            raise AssertionError("the contract built another input than the "
                                 "operator's")
        return len(self.sim.gateway.requests)

    async def request_rotate(self, inp):
        self.sim.request_rotate(inp.authority_set_id)
        if self.sim.gateway.requests[-1].input != inp.encode():
            raise AssertionError("the contract built another rotate input")
        return len(self.sim.gateway.requests)


class SimEth:
    """events.EthClient over the simulator's events: event i is in
    Ethereum block i + 1, the HeaderRangeCommitmentStored ones as logs."""

    def __init__(self, sim):
        self.sim = sim

    async def latest_block_number(self):
        return len(self.sim.events)

    async def get_logs(self, address, topic0, from_block, to_block):
        from vectorx_tpu_torch.services import events
        if topic0 != events.EVENT_TOPIC:
            return []
        logs = []
        for block, ev in enumerate(self.sim.events, 1):
            if ev.name == "HeaderRangeCommitmentStored" and \
                    from_block <= block <= to_block:
                a = ev.args
                logs.append({"data": "0x" + (
                    a["startBlock"].to_bytes(32, "big")
                    + a["endBlock"].to_bytes(32, "big") + a["dataCommitment"]
                    + a["stateCommitment"]
                    + a["headerRangeCommitmentTreeSize"].to_bytes(32, "big")
                ).hex()})
        return logs


def phase_service(d: str, cli_out: bytes):
    """The service loop on the card over the [cli-header-range] fixture
    (180 headers, 300 authorities with 240 signed): the indexer verifies
    the target's justification (one 300-lane verify_batch; a forged lane
    dropped, two thirds signed refused) into its store; genesis_params and
    VectorXSim with MockProofGateway at the trusted block; the Operator
    requests the header range; run_program proves it in process; the
    gateway fulfils it and the contract commits; poll_once reads the
    commitments back, compute_block_range_data gives the same; a chain one
    authority set ahead makes the operator request rotate. Seconds by
    stage from the port's PhaseTimer ([service-split])."""
    from vectorx_tpu_torch.services import (contract_sim, entrypoint, events,
                                            indexer, operator, store, tools)
    from vectorx_tpu_torch.utils.profiling import PhaseTimer
    dev = default_device()
    timer = PhaseTimer()
    source = entrypoint.FixtureSource(d, device=dev)
    with open(os.path.join(d, "input.json")) as f:
        inp = abi.HeaderRangeInput.decode(bytes.fromhex(json.load(f)["input"][2:]))
    target, tree_size = inp.target_block, consts.HEADER_RANGE_TREE_SIZE_SMALL
    rec = source.get_justification_record(target)
    block_hash, _, round_, set_id = scale.decode_precommit_bytes(
        bytes.fromhex(rec.signed_message))
    pubs = [bytes.fromhex(p) for p in rec.pubkeys]
    sigs = [bytes.fromhex(s) for s in rec.signatures]
    signed = [i for i, on in enumerate(rec.validator_signed) if on]

    def verify(lane_sigs):
        """Every lane present: the unsigned ones with their dummy bytes."""
        return indexer.verify_justification(indexer.Justification(
            round_, block_hash, target, set_id, pubs, lane_sigs), pubs,
            device=dev)

    idx_store = store.InMemoryStore()
    with timer.phase("indexer", dev):
        got = verify(sigs)
    if got != rec:
        raise AssertionError("the indexer's record != the fixture's")
    idx_store.add_justification(got)
    lane = signed[7]
    forged = list(sigs)
    forged[lane] = sigs[lane][:40] + bytes([sigs[lane][40] ^ 1]) + sigs[lane][41:]
    minority = [s if i in signed[:len(pubs) * 2 // 3] else bytes(64)
                for i, s in enumerate(sigs)]
    with timer.phase("indexer_refusals", dev):
        dropped, refused = verify(forged), verify(minority)
    if (dropped is None or dropped.validator_signed[lane]
            or sum(dropped.validator_signed) != len(signed) - 1
            or dropped.signatures[lane] != bytes(64).hex()):
        raise AssertionError("the indexer kept a forged lane")
    if refused is not None:
        raise AssertionError("the indexer stored two thirds signed")

    chain = FixtureChain(source, idx_store, pubs, target, lambda b: set_id)
    with timer.phase("genesis"):
        params = asyncio.run(tools.genesis_params(chain, CLI_TRUSTED))
        gateway = contract_sim.MockProofGateway()
        sim = contract_sim.VectorXSim.deploy(
            "guardian", gateway, params["height"],
            bytes.fromhex(params["header_hash"][2:]), params["authority_set_id"],
            bytes.fromhex(params["authority_set_hash"][2:]), tree_size=tree_size)
    if (bytes.fromhex(params["header_hash"][2:]) != inp.trusted_header_hash
            or bytes.fromhex(params["authority_set_hash"][2:])
            != inp.authority_set_hash):
        raise AssertionError(f"genesis_params != the request's trusted state: {params}")

    config = operator.OperatorConfig(update_delay_blocks=180)
    with timer.phase("request"):
        asyncio.run(operator.Operator(chain, SimContract(sim), config)
                    .find_and_request_header_range())
    if len(gateway.requests) != 1 or len(gateway.requests[0].input) != 80:
        raise AssertionError(f"the operator requested {gateway.requests}")
    req = gateway.requests[0]
    if abi.HeaderRangeInput.decode(req.input) != inp:
        raise AssertionError("the request != the [cli-header-range] input")

    with timer.phase("prove", dev):
        out = entrypoint.run_program("header_range", req.input, source,
                                     tree_size, device=dev)
    if out != cli_out:
        raise AssertionError("the in-process output != [cli-header-range]'s")

    with timer.phase("fulfil"):
        gateway.fulfill_request(req, out)
    key = abi.range_commitment_key(CLI_TRUSTED, target)
    if (sim.latest_block != target
            or sim.block_height_to_header_hash[target] != out[:32]
            or sim.state_root_commitments[key] != out[32:64]
            or sim.data_root_commitments[key] != out[64:]
            or [e.name for e in sim.events[-2:]]
            != ["HeaderRangeCommitmentStored", "HeadUpdate"]):
        raise AssertionError("the contract did not commit the range")
    committed_event = sim.events[-2].name

    with timer.phase("read_back", dev):
        n_events = asyncio.run(events.poll_once(SimEth(sim), idx_store,
                                                "0xvectorx", 1))
        backfill = asyncio.run(tools.compute_block_range_data(
            chain, CLI_TRUSTED, target, tree_size, dev))
    if (n_events != 1 or idx_store.get_block_range_data(CLI_TRUSTED, target)
            != (out[64:], out[32:64])):
        raise AssertionError("poll_once did not store the commitments")
    if (backfill["state_root_commitment"] != "0x" + out[32:64].hex()
            or backfill["data_root_commitment"] != "0x" + out[64:].hex()
            or backfill["end_header_hash"] != "0x" + out[:32].hex()):
        raise AssertionError("compute_block_range_data != the commitments")

    ahead = FixtureChain(source, idx_store, pubs, target + 300,
                         lambda b: set_id + (b > target))
    with timer.phase("rotate"):
        asyncio.run(operator.Operator(ahead, SimContract(sim), config)
                    .find_and_request_rotate())
    rot = gateway.requests[-1]
    if (len(gateway.requests) != 2 or rot.function_id != sim.rotate_function_id
            or rot.input != abi.RotateInput(set_id, inp.authority_set_hash).encode()):
        raise AssertionError("the operator did not request rotate")

    log("service", stage="indexer", lanes=len(pubs), signed=len(signed),
        record="equal_to_fixture", forged_lane="dropped",
        two_thirds_signed="refused")
    log("service", stage="contract", genesis_height=params["height"],
        requests=1, input_bytes=len(req.input), target=target,
        output="equal_to_cli_header_range", committed=f"{CLI_TRUSTED}-{target}",
        event=committed_event)
    log("service", stage="read_back", events_stored=n_events,
        commitments="equal", compute_block_range_data="equal")
    log("service", stage="rotate", requests=len(gateway.requests),
        input_bytes=len(rot.input), authority_set_id=set_id)
    log("service-split", **{f"{k}_s": f"{v:.3f}"
                            for k, v in timer.totals.items()},
        total_s=f"{sum(timer.totals.values()):.3f}")


# -- the collective layer: meshes of shards of the one card -----------------

COLLECTIVE_SHARDS = 4
COLLECTIVE_DIR = os.path.join("build", "chip_smoke_collective")
FORGED_SLOT = 128                # the first header of shard 2 of 4


def cli_header_range_chain(d: str, dev):
    """The [cli-header-range] chain from its fixture: (header bytes, sizes,
    num_active, trusted hash, trusted block) for its 256 slots of 35,840
    bytes, on `dev`."""
    from vectorx_tpu_torch.parallel import subchain
    from vectorx_tpu_torch.services import entrypoint
    source = entrypoint.FixtureSource(d, device=dev)
    headers = [source.get_header(b)
               for b in range(CLI_TRUSTED, CLI_TRUSTED + CLI_HEADERS + 1)]
    buf, sizes = subchain.pack_headers(headers[1:],
                                       consts.HEADER_RANGE_TREE_SIZE_SMALL,
                                       consts.MAX_HEADER_SIZE)
    trusted = hashlib.blake2b(headers[0], digest_size=32).digest()
    return (torch.from_numpy(buf).to(dev), torch.from_numpy(sizes).to(dev),
            CLI_HEADERS,
            torch.frombuffer(bytearray(trusted), dtype=torch.uint8).to(dev),
            CLI_TRUSTED)


def timed_subchain(args, mesh=None):
    """-> (SubchainResult, seconds) of one verify_subchain call."""
    from vectorx_tpu_torch.parallel import subchain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = subchain.verify_subchain(*args, mesh=mesh)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def same_result(a, b) -> bool:
    return all(torch.equal(x.to(y.device), y) for x, y in zip(a, b))


def phase_collective_subchain(d: str):
    """The cli_header_range_180 chain (180 active headers in 256 slots of
    35,840 bytes) over a mesh of 4 shards of the card: every field equal
    to the single-device call's; a parent hash forged at the first header
    of shard 2 turns links_ok False."""
    from vectorx_tpu_torch.parallel.mesh import Mesh
    dev = default_device()
    mesh = Mesh([dev] * COLLECTIVE_SHARDS)
    args = cli_header_range_chain(d, dev)
    one, one_s = timed_subchain(args)
    sharded, sharded_s = timed_subchain(args, mesh)
    if not (bool(one.links_ok) and bool(one.blocks_sequential)):
        raise AssertionError("the [cli-header-range] chain does not verify")
    if not same_result(sharded, one):
        raise AssertionError("sharded verify_subchain != the single-device one")
    forged = args[0].clone()
    forged[FORGED_SLOT, 0] ^= 1
    bad, bad_s = timed_subchain((forged,) + args[1:], mesh)
    if bool(bad.links_ok):
        raise AssertionError("a parent hash forged at slot 128 was not refused")
    log("collective-subchain", mesh=f"{COLLECTIVE_SHARDS}x{dev}(one card)",
        slots=f"{args[0].shape[0]}x{args[0].shape[1]}", active=args[2],
        fields="equal", forged_slot=FORGED_SLOT, forged_links_ok=False,
        one_device_s=f"{one_s:.3f}", sharded_s=f"{sharded_s:.3f}",
        forged_sharded_s=f"{bad_s:.3f}")


def collective_case():
    """The [slice] proof's air, config and first header's case."""
    air, log_n, cfg = slice_setup()
    case = header_case(air, make_header(np.random.default_rng(3), 1000,
                                        HEADER_BYTES))
    return air, log_n, cfg, case


def unsharded_payload() -> tuple:
    """-> (the unsharded proof's bytes of the [collective-prove] header,
    its warm prove seconds, its kernel launches)."""
    air, _, cfg, case = collective_case()
    proof, seconds, _, launches = timed_prove(air, case, cfg)
    return serialize.serialize_proof(proof), seconds, launches


def phase_collective_prove(want: bytes, unsharded_s: float,
                           unsharded_launches: dict):
    """The [slice] proof (HeaderAir(16), rate 8, 28 queries, pow 16)
    proved with ShardedNttOps over 4 shards of the card: its payload equal
    to the unsharded proof's, verified, a tampered copy refused; seconds,
    peak memory, and the Poseidon launches of the prove, which must equal
    the unsharded prove's (the same transcript and commits)."""
    from vectorx_tpu_torch.parallel.mesh import Mesh
    from vectorx_tpu_torch.parallel.ntt_dist import ShardedNttOps, _split
    air, log_n, cfg, case = collective_case()
    ops = ShardedNttOps(Mesh([default_device()] * COLLECTIVE_SHARDS))
    before = dict(pc.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = prover.prove(air, *case, cfg, ntt_ops=ops)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: pc.launches[k] - before[k] for k in before}
    if serialize.serialize_proof(proof) != want:
        raise AssertionError("the sharded-NTT proof != the unsharded proof")
    if launches != unsharded_launches:
        raise AssertionError(f"the sharded-NTT prove launched {launches}, "
                             f"the unsharded one {unsharded_launches}")
    t0 = time.perf_counter()
    if not verifier.verify(air, proof, case[1], log_n, cfg):
        raise AssertionError("the sharded-NTT proof did not verify")
    verify_s = time.perf_counter() - t0
    if verifier.verify(air, flipped(proof, "trace_rows_a"), case[1], log_n,
                       cfg):
        raise AssertionError("a tampered sharded-NTT proof was accepted")
    n_lde = air.n_rows << cfg.rate_bits
    log("collective-prove", air=f"HeaderAir({HEADER_CHUNKS})",
        rows=air.n_rows, cols=air.num_cols,
        mesh=f"{COLLECTIVE_SHARDS}x{default_device()}(one card)",
        trace_intt="x".join(map(str, _split(air.n_rows))),
        lde="x".join(map(str, _split(n_lde))), payload="equal",
        verified=True, tampered_refused=True, prove_s=f"{prove_s:.4f}",
        unsharded_prove_s=f"{unsharded_s:.4f}",
        verify_s=f"{verify_s:.4f}", peak_bytes=peak,
        **{f"{k}_per_prove": v for k, v in launches.items()},
        launches_per_prove="equal_to_unsharded")


def phase_collective_dryrun():
    from vectorx_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(COLLECTIVE_SHARDS)
    log("collective-dryrun", mesh=f"{COLLECTIVE_SHARDS}x{default_device()}",
        phases=3, seconds=f"{time.perf_counter() - t0:.2f}")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_collective_dcn() -> tuple:
    """Start the two-process demo (python -m
    vectorx_tpu_torch.parallel.dcn_demo), each process with its 4 local
    shards on the card, on gloo, since NCCL refuses two ranks on one card;
    beside it one process at world size 1 on NCCL runs phase 1. Each
    writes its output to log files of its own. -> (processes, their log
    paths, start time)."""
    import shutil
    dev = default_device()
    shutil.rmtree(COLLECTIVE_DIR, ignore_errors=True)
    handoff = os.path.join(COLLECTIVE_DIR, "handoff")
    os.makedirs(handoff)
    demo = [sys.executable, "-m", "vectorx_tpu_torch.parallel.dcn_demo"]
    gloo_port, nccl_port = free_port(), free_port()
    args = [[str(gloo_port), str(pid), handoff, "--backend", "gloo"]
            for pid in range(2)]
    args.append([str(nccl_port), "0", "--backend", "nccl", "--processes",
                 "1"])
    t0 = time.perf_counter()
    procs, logs = [], []
    for i, a in enumerate(args):
        out, err = (os.path.join(COLLECTIVE_DIR, f"dcn{i}.{k}")
                    for k in ("out", "err"))
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(demo + a + ["--device", str(dev)],
                                          stdout=fo, stderr=fe))
        logs.append((out, err))
    return procs, logs, t0


def finish_collective_dcn(started):
    """DCN_DEMO_OK with the single-device root of the same chain from both
    groups, then DCN_MAP_OK from the gloo pair."""
    from vectorx_tpu_torch.parallel import dcn_demo, subchain
    dev = default_device()
    procs, logs, t0 = started
    headers, trusted = dcn_demo.demo_chain()
    buf, sizes = subchain.pack_headers(headers, dcn_demo.N_HEADERS,
                                       dcn_demo.SLOT_BYTES)
    want = dcn_demo.root_hex(subchain.verify_subchain(
        torch.from_numpy(buf).to(dev), torch.from_numpy(sizes).to(dev),
        dcn_demo.N_HEADERS, torch.frombuffer(bytearray(trusted),
                                             dtype=torch.uint8).to(dev),
        0).state_root_words)
    outs = []
    for p, (out, err) in zip(procs, logs):
        if p.wait(timeout=300) != 0:
            raise AssertionError(f"dcn_demo exited {p.returncode}: "
                                 f"{open(err).read().strip()[-2000:]}")
        outs.append(open(out).read())
    seconds = time.perf_counter() - t0
    backends = [o.split("DCN_BACKEND", 1)[1].split()[0] for o in outs]
    roots = [outs[i].split("DCN_DEMO_OK", 1)[1].split()[0] for i in (0, 2)]
    if (backends != ["gloo", "gloo", "nccl"] or roots != [want, want]
            or "DCN_MAP_OK" not in outs[0]):
        raise AssertionError(f"dcn_demo: {backends} {roots} != {want}: {outs}")
    log("collective-dcn", processes=2, backend="gloo",
        mesh=f"dcn=2 x batch=4 of {dev}(one card)", root=want,
        root_equal_to_single_device=True, map="DCN_MAP_OK",
        nccl_world1="DCN_DEMO_OK", seconds_beside_subchain=f"{seconds:.1f}")


def phase_collective(by_path: dict):
    """[collective]: the multi-process demo in processes of its own beside
    the sharded subchain check (which is launch-bound on this process),
    then the sharded-NTT proof (its launches a main path of their own,
    counted from 0 after the unsharded reference proof) and the dry run."""
    t0 = time.perf_counter()
    dcn = start_collective_dcn()
    try:
        phase_collective_subchain(os.path.join(CLI_DIR, "header_range"))
        finish_collective_dcn(dcn)
    finally:
        for p in dcn[0]:
            if p.poll() is None:
                p.kill()
                p.wait()
    want, unsharded_s, unsharded_launches = unsharded_payload()
    pc.reset_launches()
    phase_collective_prove(want, unsharded_s, unsharded_launches)
    by_path["collective-prove"] = launches = dict(pc.launches)
    log("collective-prove-launches-total", **launches,
        total=sum(launches.values()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"the collective-prove path skipped a kernel: "
                             f"{launches}")
    phase_collective_dryrun()
    log("collective", seconds=f"{time.perf_counter() - t0:.1f}")


def slice_setup():
    air = ah.HeaderAir(max_chunks=HEADER_CHUNKS)
    cfg = prover.StarkConfig(rate_bits=3, num_queries=28, final_poly_len=8,
                             pow_bits=prover.PRODUCTION_POW_BITS)
    return air, air.n_rows.bit_length() - 1, cfg


def traced(name, fn):
    """One run of fn under torch.profiler (CUDA activity): span, busy
    time and share, kernel count, the Poseidon kernels' share."""
    from torch.profiler import ProfilerActivity, profile
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


def profile_witness():
    """One warm witness-level header_range at production width (the
    [cli-header-range] request) under the profiler, and its stages."""
    from vectorx_tpu_torch.circuits import ed25519 as ed
    from vectorx_tpu_torch.parallel import subchain
    from vectorx_tpu_torch.services import entrypoint, grandpa
    dev = default_device()
    d, headers, _, _, _ = header_range_fixture(
        os.path.join(CLI_DIR, "profile"), CLI_HEADERS, CLI_AUTHORITIES,
        CLI_SIGNED, 61)
    source = entrypoint.FixtureSource(d, device=dev)
    with open(os.path.join(d, "input.json")) as f:
        raw = bytes.fromhex(json.load(f)["input"][2:])
    log("profile", program="header_range", headers=CLI_HEADERS,
        slots=f"{consts.HEADER_RANGE_TREE_SIZE_SMALL}x{consts.MAX_HEADER_SIZE}",
        authorities=CLI_AUTHORITIES, signed=CLI_SIGNED)

    def program():
        return entrypoint.run_program("header_range", raw, source,
                                      device=dev)

    if program() != header_range_want(headers,
                                       consts.HEADER_RANGE_TREE_SIZE_SMALL):
        raise AssertionError("witness-level header_range output != the host's")
    blocks = sorted(headers)[1:]
    buf, sizes = subchain.pack_headers([headers[b] for b in blocks],
                                       consts.HEADER_RANGE_TREE_SIZE_SMALL,
                                       consts.MAX_HEADER_SIZE)
    buf, sizes = torch.from_numpy(buf).to(dev), torch.from_numpy(sizes).to(dev)
    jd = grandpa.to_device_justification(
        source.get_justification_record(max(headers)), CLI_AUTHORITIES, dev)
    traced("witness-program", program)
    traced("witness-blake2b", lambda: subchain.hash_headers(buf, sizes))
    traced("witness-authority-chain", lambda: commitments.authority_set_hash_vec(
        jd.pubkeys, jd.num_authorities))
    traced("witness-verify-batch", lambda: ed.verify_batch(
        jd.pubkeys, jd.signatures[:, :32], jd.signatures[:, 32:],
        jd.challenges, jd.validator_signed))


def phase_profile(which: str):
    """Where the device time of one warm prove and one verify goes."""
    from torch.profiler import ProfilerActivity, profile
    if which == "witness":
        return profile_witness()
    if which == "header":
        air, log_n, cfg = slice_setup()
        case = header_case(air, make_header(np.random.default_rng(3), 1000,
                                            HEADER_BYTES))
    else:
        air, case, log_n, _, _ = statement_case(which)
        cfg = STATEMENT_CFG
    log("profile", proof=which, air=type(air).__name__, rows=air.n_rows,
        cols=air.num_cols, lde=air.n_rows << cfg.rate_bits)
    proof = prover.prove(air, *case, cfg)                     # cold: VK, tables
    if not verifier.verify(air, proof, case[1], log_n, cfg):
        raise AssertionError("the port verifier rejected an honest proof")

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

    started = time.perf_counter()
    t0 = time.perf_counter()
    pc._load()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for line in pc.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())

    args = sys.argv[1:]
    if args[:1] == ["--profile"] and len(args) <= 2:
        phase_profile(args[1] if len(args) == 2 else "header")
        print(smi)
        return 0
    if args:
        raise SystemExit(f"chip_smoke: unknown arguments {args}")

    stats = phase_poseidon(np.random.default_rng(11), dev, sm_mhz)
    phase_small()
    phase_aux_small()

    # processes of their own prove on the CPU what the card proves, at the
    # lowest priority: the recursion-small proofs beside the main paths,
    # the B = 8 Ed25519 proof beside the last checks (the pool stops them
    # on the way out)
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        rec_on_cpu = [pool.apply_async(recursion_small_on_cpu, (names,))
                      for names in (("recursive", "streamed", "level1"),
                                    ("reduce", "map_reduce"))]
        dsl_on_cpu = pool.apply_async(dsl_small_on_cpu)
        # the main paths, each proof with the counts set to 0 just before it
        duplex_shapes, sponge_shapes = set(), set()
        record_duplex_shapes(duplex_shapes)
        record_sponge_shapes(sponge_shapes)
        by_path, rec_on_card, dsl_on_card = {}, [], []
        for path, run in ([("slice", phase_slice)] + [
                (name, lambda name=name: phase_statement(name))
                for name in STATEMENTS] + [
                ("bundle-header-range", phase_bundle_header_range),
                ("bundle-rotate", phase_bundle_rotate),
                ("recursion-small",
                 lambda: rec_on_card.append(phase_recursion_small())),
                ("reduce-streamed", phase_reduce_streamed),
                ("recursion-leaf", phase_recursion_leaf),
                ("dsl-small",
                 lambda: dsl_on_card.append(phase_dsl_small()))]):
            pc.reset_launches()
            t0 = time.perf_counter()
            run()
            by_path[path] = launches = dict(pc.launches)
            log(f"{path}-launches-total", **launches,
                total=sum(launches.values()),
                seconds=f"{time.perf_counter() - t0:.1f}")
            if min(launches.values()) <= 0:
                raise AssertionError(f"the {path} path skipped a kernel: "
                                     f"{launches}")
        # the CLI: the witness-level programs (no Poseidon kernel on their
        # path) and the --stark route, whose process reports its launches
        t0 = time.perf_counter()
        by_path["cli-stark"], cli_out = phase_cli(duplex_shapes, sponge_shapes)
        launches = by_path["cli-stark"]
        log("cli-stark-launches-total", **launches,
            total=sum(launches.values()),
            cli_seconds=f"{time.perf_counter() - t0:.1f}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"the cli-stark path skipped a kernel: "
                                 f"{launches}")
        # the service loop: witness-level, no Poseidon kernel on its path
        pc.reset_launches()
        phase_service(os.path.join(CLI_DIR, "header_range"), cli_out)
        log("service-launches-total", **pc.launches)
        # the collective layer, on meshes of shards of the one card
        phase_collective(by_path)
        # the kernels at the main paths' shapes
        ed_on_cpu = pool.apply_async(ed25519_small_payload_on_cpu)
        t0 = time.perf_counter()
        shape_times = check_sponge_shapes(dev, gl.MODULUS, sm_mhz,
                                          sponge_shapes)
        check_duplex_shapes(np.random.default_rng(17), dev, duplex_shapes)
        log("shape-checks", seconds=f"{time.perf_counter() - t0:.1f}")
        phase_ed25519_small(ed_on_cpu.get())
        compare_recursion_small(rec_on_card[0],
                                [r.get() for r in rec_on_cpu])
        compare_dsl_small(dsl_on_card[0], dsl_on_cpu.get())
    stats["duplex"]["max_abs_err"] = max_abs_err["duplex"]
    stats["sponge_rows"].update(
        max_abs_err=max_abs_err["sponge_rows"],
        ms_and_bound_ms_by_shape={k: [round(ms, 4), round(b, 4)]
                                  for k, (ms, b, _) in shape_times.items()})

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": sum(launches[name] for launches in by_path.values()),
         "launches_by_path": {path: launches[name]
                              for path, launches in by_path.items()},
         "library_ms": None, **stats[name]}
        for name in ("permute", "duplex", "sponge_rows")]}))
    log("total", seconds=f"{time.perf_counter() - started:.1f}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
