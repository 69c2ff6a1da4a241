"""The metric arithmetic: whole-job sums over the count, the union of
device intervals, the idle share, and the Poseidon permutations of a
prove against a hand count."""

from types import SimpleNamespace

import numpy as np
import pytest

from vxbench import roofline, run, spec
from vxbench.trace import POSEIDON_KERNEL, Span, breakdown, union_ns


def test_union_of_intervals():
    s = np.array([20, 0, 5, 40, 41], dtype=np.int64)
    e = np.array([30, 10, 15, 50, 45], dtype=np.int64)
    assert union_ns(s, e) == 15 + 10 + 10
    assert union_ns(np.zeros(0, np.int64), np.zeros(0, np.int64)) == 0
    assert union_ns(np.array([0, 1]), np.array([100, 2])) == 100


def _span(step, seconds, intervals, names=None, phases=None):
    s = np.array([a for a, _ in intervals], dtype=np.int64)
    e = np.array([b for _, b in intervals], dtype=np.int64)
    names = names or ["k"] * len(intervals)
    return Span(step, seconds, names, s, e, dict(phases or {}))


def _run(jobs, **kw):
    cell = spec.Cell(spec.load_benchmark(),
                     kw.get("cell", "rotate.authority_chains"))
    shape = run.proof_shape(cell.config, cell.kind.PROOF)
    return run.Run(cell, {}, jobs, 10.0, 5.0, kw.get("peak", 2 ** 31), shape,
                   dict(cell.config["guarantee"]), kw.get("sm_mhz", 1980.0),
                   kw.get("nonces", [0] * len(jobs)))


def _job(i, prove_s, verify_s, prove_span, verify_span, witness_s=1.0):
    j = run.Job(i, {}, prove_s=prove_s, verify_s=verify_s, accepted=True)
    j.spans = {"witness": _span("witness", witness_s, []),
               "prove": prove_span, "verify": verify_span}
    return j


def test_whole_job_sums_over_the_count():
    jobs = [_job(0, 3.0, 1.0, _span("prove", 2.0, [(0, 10 ** 9)],
                                    phases={"lde": 0.5, "deep": 1.0}),
                 _span("verify", 1.0, [(0, 1)] * 3), 0.5),
            _job(1, 5.0, 2.0, _span("prove", 4.0, [(0, 10 ** 9)] * 2,
                                    phases={"lde": 1.5, "openings": 0.5}),
                 _span("verify", 2.0, [(0, 1)]), 1.5)]
    r = _run(jobs)
    e2e = run.end_to_end(r)
    assert e2e["prove_s"]["value"] == 4.0 and e2e["verify_s"]["value"] == 1.5
    assert e2e["setup_s"]["value"] == 5.0
    layer = run.per_layer(r)
    assert layer["lde_s"]["value"] == 1.0
    assert layer["open_deep_s"]["value"] == 0.75
    assert layer["witness_s"]["value"] == 1.0
    assert layer["prove_kernels_per_job"]["value"] == 1.5
    assert layer["verify_kernels_per_job"]["value"] == 2.0
    # busy 1 s of 2 s and 1 s of 4 s: idle 1 - 2/6
    assert layer["prove_idle_pct"]["value"] == pytest.approx(100 * 4 / 6)
    assert layer["peak_mem_gib"]["value"] == 2.0
    assert "poseidon_roofline" not in layer        # no Poseidon kernel seen


def test_verify_read_per_layer_in_the_shard_cell():
    jobs = [_job(0, 3.0, 1.0, _span("prove", 2.0, [(0, 1)]),
                 _span("verify", 1.25, [(0, 1)] * 3)),
            _job(1, 5.0, 2.0, _span("prove", 4.0, [(0, 1)]),
                 _span("verify", 2.25, [(0, 1)]))]
    r = _run(jobs, cell="header_range.ed25519_shards")
    assert set(run.end_to_end(r)) == {"prove_s", "setup_s"}
    layer = run.per_layer(r)
    assert layer["verify_s.shards"]["value"] == 1.75
    assert layer["verify_kernels_per_job.shards"]["value"] == 2.0
    assert "verify_kernels_per_job" not in layer


def test_copies_are_not_kernels():
    sp = _span("prove", 1.0, [(0, 5), (5, 9), (9, 10)],
               names=["Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
                      "void at::native::x(int)"])
    assert sp.kernels() == 1 and sp.busy_s() == 10e-9


def test_breakdown_lists_ops_and_idle_by_step():
    spans = [_span("prove", 2e-8, [(0, 5), (10, 12)], names=["a", "b"]),
             _span("verify", 1e-8, [(0, 9)], names=["a"])]
    b = breakdown(spans)
    assert b["device_ops"] == [["a", 14e-9], ["b", 2e-9]]
    assert dict(b["idle_gaps"]) == pytest.approx({"prove": 13e-9,
                                                  "verify": 1e-9})


def test_poseidon_kernels_by_name():
    for name in ("void (anonymous namespace)::permute_kernel(unsigned long "
                 "const*, unsigned long*, long)",
                 "(anonymous namespace)::sponge_rows_coop_kernel<true>(int)",
                 "_ZN12_GLOBAL__N_113duplex_kernelEPKm"):
        assert POSEIDON_KERNEL.match(name)
    for name in ("void at::native::vectorized_elementwise_kernel<2, "
                 "permute_kernel>(int)", "permute_kernelx(int)", "Memcpy"):
        assert not POSEIDON_KERNEL.match(name)


def test_permutations_against_a_hand_count():
    shape = {"log_n": 3, "num_cols": 9, "n_aux": 0, "n_consts": 5,
             "n_chunks": 2}
    guarantee = {"rate_bits": 1, "final_poly_len": 2, "cap_height": 0,
                 "pow_bits": 4}
    work = {w: p for w, p, _ in roofline.prove_work(shape, guarantee, 5)}
    # 16 LDE rows: 9 columns are 2 chunks a row, 5 constant and 4
    # quotient columns 1; FRI from 16 down to 4 points: layers of 8 and 4
    # leaves
    assert work == {"constants leaves": 16, "constants tree": 15,
                    "trace leaves": 32, "trace tree": 15,
                    "quotient leaves": 16, "quotient tree": 15,
                    "fri layer 0": 15, "fri layer 1": 7, "grinding": 6}
    ops = 137 * roofline.INT32_OPS_PER_PERM
    assert roofline.prove_bound_s(shape, guarantee, 5, 1000.0) == \
        pytest.approx(ops / (132 * 64 * 1e9), rel=1e-3)
    assert roofline.INT32_OPS_PER_PERM == 6792


def test_poseidon_roofline_share():
    names = ["void (anonymous namespace)::permute_kernel(int)", "other"]
    jobs = [_job(0, 1, 1, _span("prove", 1.0, [(0, 10 ** 6), (0, 10 ** 9)],
                                names=names), _span("verify", 1.0, []))]
    r = _run(jobs, nonces=[100])
    bound = roofline.prove_bound_s(r.shape, r.guarantee, 100, 1980.0)
    got = run.per_layer(r)["poseidon_roofline"]["value"]
    assert got == pytest.approx(100 * bound / 1e-3)
    assert run.per_layer(_run(jobs, nonces=[100], sm_mhz=0.0)).get(
        "poseidon_roofline") is None


def test_no_traced_job_reads_nothing():
    jobs = [run.Job(0, {}, prove_s=1.0, verify_s=1.0, accepted=True)]
    layer = run.per_layer(_run(jobs))
    assert set(layer) == {"peak_mem_gib"}
