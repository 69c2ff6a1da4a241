"""Run one cell of the benchmark once.

    python3 -m vxbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up makes the cell's job pool from the seed and runs one warm
job of the cell's shape; then a closed loop with one worker takes the
pool's jobs in order (witness, prove, verify each) until ``--seconds``
have passed, and finishes the job in flight. Once the window has closed
the outputs are compared with the plain reference (``reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit. The checks are also the last lines of
standard error. Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded after the window, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vectorx_tpu"})
#: every compared number is a count of faults; each limit is 0
LIMITS = {"publics_mismatch": 0, "verify_rejected": 0, "config_mismatch": 0,
          "reference_rejected": 0, "tampered_accepted": 0,
          "false_accepted": 0}
#: proofs a run draws from the seed for the reference's whole check
CHECK_SAMPLE = 2
EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names among ``modules`` (sys.modules when None) that the
    run may not load, compared whole: ``vectorx_tpu_torch`` is not
    ``vectorx_tpu``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


@dataclass
class Job:
    """One job of the window and what it produced."""
    index: int
    inputs: dict
    prove_s: float = 0.0            # witness + prove, host clock
    verify_s: float = 0.0
    accepted: bool = False
    publics: List[int] = field(default_factory=list)
    proof: object = None
    spans: Dict[str, object] = field(default_factory=dict)


@dataclass
class Run:
    """A finished window, handed to the metric readers."""
    cell: object
    ctx: dict
    jobs: List[Job]
    window_s: float
    setup_s: float
    peak_bytes: int
    shape: dict
    guarantee: dict
    sm_mhz: float = 0.0
    nonces: List[int] = field(default_factory=list)


def proof_shape(config: dict, key: str) -> dict:
    """The widths the configuration states for one kind of proof, in the
    reference's terms."""
    w = config["proofs"][key]
    rows = w["rows"]
    if rows & (rows - 1):
        raise ValueError(f"{key}: rows {rows} is not a power of two")
    return {"log_n": rows.bit_length() - 1, "num_cols": w["cols"],
            "n_aux": w["aux_cols"], "n_consts": w["const_cols"],
            "n_chunks": w["quotient_chunks"]}


def run_job(kind, ctx, job: Job, cfg, sync: Callable, traced: bool) -> None:
    from . import stark_job
    if not traced:
        t0 = time.perf_counter()
        air, trace, job.publics = kind.witness(job.inputs, ctx)
        job.proof = stark_job.prove(air, trace, job.publics, cfg)
        del trace
        sync()
        del air
        t1 = time.perf_counter()
        job.accepted = stark_job.verify(kind.verifier_air(job.inputs, ctx),
                                        job.proof, job.publics, cfg)
        sync()
        job.prove_s, job.verify_s = t1 - t0, time.perf_counter() - t1
        return
    from .trace import profiled
    (air, trace, job.publics), sp_w = profiled(
        "witness", lambda: kind.witness(job.inputs, ctx), sync)
    phases, last = {}, [0.0]

    def mark(phase):
        sync()
        now = time.perf_counter()
        phases[phase] = phases.get(phase, 0.0) + now - last[0]
        last[0] = now

    def prove():
        last[0] = time.perf_counter()
        return stark_job.prove(air, trace, job.publics, cfg, timer=mark)

    job.proof, sp_p = profiled("prove", prove, sync)
    sp_p.phases = phases
    del trace, air
    job.accepted, sp_v = profiled(
        "verify", lambda: stark_job.verify(kind.verifier_air(job.inputs, ctx),
                                           job.proof, job.publics, cfg), sync)
    job.spans = {"witness": sp_w, "prove": sp_p, "verify": sp_v}
    job.prove_s = sp_w.seconds + sp_p.seconds
    job.verify_s = sp_v.seconds


def check(run: Run, cfg, seed: int, device) -> Dict[str, int]:
    """The comparison with the plain reference, once the window has
    closed: every job's public values and verdict, every proof's widths
    and configuration, and a sample of proofs drawn from the seed through
    the reference's whole check. The program's verifier must refuse the
    first of them with a bit flipped, and a proof of that job's witness
    under a statement the reference calls false."""
    from . import proofs, stark_job
    from .reference import stark as ref_stark
    kind, config = run.cell.kind, run.cell.config
    counts = dict.fromkeys(LIMITS, 0)
    expected = []
    for job in run.jobs:
        publics = kind.expected(job.inputs, config)
        expected.append(publics)
        counts["publics_mismatch"] += int(job.publics != publics)
        counts["verify_rejected"] += int(not job.accepted)
    arrays = [proofs.as_arrays(job.proof) for job in run.jobs]
    run.nonces = [a["pow_nonce"] for a in arrays]
    for a in arrays:
        counts["config_mismatch"] += int(bool(
            ref_stark.shape_faults(a, run.shape, run.guarantee)))
    rng = np.random.default_rng([seed, 0x5EED])
    n_sample = min(CHECK_SAMPLE, len(run.jobs))
    sample = sorted(int(i) for i in rng.choice(len(run.jobs), n_sample,
                                               replace=False))
    airs = {i: kind.verifier_air(run.jobs[i].inputs, run.ctx) for i in sample}
    for i in sample:
        job = run.jobs[i]
        faults = ref_stark.check(arrays[i], expected[i], run.shape,
                                 run.guarantee,
                                 stark_job.vk_cap(airs[i], cfg, device),
                                 kind.constants(job.inputs, config))
        if faults:
            print(f"reference: job {i}: {'; '.join(faults[:4])}",
                  file=sys.stderr)
        counts["reference_rejected"] += int(bool(faults))
    job = run.jobs[sample[0]]
    counts["tampered_accepted"] = int(stark_job.verify(
        airs[sample[0]], proofs.tampered(job.proof), job.publics, cfg))
    air, trace, publics, verifier_air = kind.false_statement(job.inputs,
                                                             run.ctx)
    proof = stark_job.prove(air, trace, publics, cfg)
    del trace
    counts["false_accepted"] = int(stark_job.verify(verifier_air, proof,
                                                    publics, cfg))
    return counts


def _on_card(device) -> bool:
    return getattr(device, "type", None) == "cuda"


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             sync: Callable, t_start: float):
    """Set-up and window of one run. -> (Run, the StarkConfig)."""
    from . import stark_job
    kind, config = cell.kind, cell.config
    cfg = stark_job.stark_config(config)
    warm, pool = kind.make_pool(seed, cell.traffic, config)
    ctx = kind.setup(config, device)
    run_job(kind, ctx, Job(-1, warm), cfg, sync, traced=False)
    if _on_card(device):
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    jobs: List[Job] = []
    t_window = time.perf_counter()
    while True:
        job = Job(len(jobs), pool[len(jobs) % len(pool)])
        run_job(kind, ctx, job, cfg, sync, traced)
        jobs.append(job)
        if time.perf_counter() - t_window >= seconds:
            break
    window_s = time.perf_counter() - t_window
    peak = 0
    if _on_card(device):
        import torch
        peak = int(torch.cuda.max_memory_allocated(device))
    run = Run(cell, ctx, jobs, window_s, t_window - t_start, peak,
              proof_shape(config, kind.PROOF), dict(config["guarantee"]))
    return run, cfg


def end_to_end(run: Run) -> Dict[str, dict]:
    n = len(run.jobs)
    values = {"prove_s": sum(j.prove_s for j in run.jobs) / n,
              "verify_s": sum(j.verify_s for j in run.jobs) / n,
              "setup_s": run.setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in run.cell.end_to_end()}


def per_layer(run: Run) -> Dict[str, dict]:
    out = {}
    for m in run.cell.per_layer():
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run: Run, counts: Dict[str, int], traced: bool,
                device_info: dict) -> dict:
    correct = all(counts[k] <= LIMITS[k] for k in LIMITS)
    line = {"correct": correct, "attempted": len(run.jobs),
            "failed": counts["verify_rejected"],
            "metrics": per_layer(run) if traced else end_to_end(run),
            "device": device_info}
    if traced:
        from .trace import breakdown
        spans = [sp for j in run.jobs for sp in j.spans.values()]
        line["device"] = dict(device_info,
                              busy_s=sum(sp.busy_s() for sp in spans),
                              window_s=sum(sp.seconds for sp in spans))
        line["breakdown"] = breakdown(spans)
    line["jobs"] = {"prove_s": [j.prove_s for j in run.jobs],
                    "verify_s": [j.verify_s for j in run.jobs],
                    "window_s": run.window_s}
    line["checks"] = {k: {"value": counts[k], "limit": LIMITS[k]}
                      for k in LIMITS}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m vxbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, traced: bool, device,
            sync: Callable, t_start: float) -> dict:
    """Set-up, window and check of one run on ``device`` -> the result
    line. The card's checks are the caller's."""
    run, cfg = run_cell(cell, seed, seconds, traced, device, sync, t_start)
    if traced and _on_card(device):
        from .peaks import max_sm_mhz
        run.sm_mhz = max_sm_mhz()
    counts = check(run, cfg, seed, device)
    info = {"platform": "gpu" if _on_card(device) else str(device),
            "kind": _device_name(device), "count": cell.chips,
            "memory_peak_bytes": run.peak_bytes}
    return result_line(run, counts, traced, info)


def _device_name(device) -> str:
    if _on_card(device):
        import torch
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vxbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return EXIT_NO_CARD
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                   torch.cuda.synchronize, T_START)
    found = forbidden_modules()
    if found:
        print(f"vxbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for k, v in line["checks"].items():
        print(f"check {k}={v['value']} limit={v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
