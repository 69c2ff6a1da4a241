"""The port's host utilities against the JAX package's: xxhash,
PhaseTimer and the torch.profiler hooks, watch, and the native loader.

- ``utils/xxhash.py``: the spot values of ``tests/test_utils_events.py``
  and the JAX package's values on seeded inputs of every length class;
- ``utils/profiling.py``: ``PhaseTimer`` as ``tests/test_infra.py`` holds
  the JAX one, plus the synchronize at a phase end of each CUDA device
  given (recorded, there is no card here); ``xprof_trace`` writes a trace
  that holds an ``annotate`` region;
- ``stark/watch.py``: the log lines of the JAX package's ``watch`` and
  ``watch_fp`` on the same canonical values; non-canonical bit patterns
  log canonically;
- ``runtime/native.py``: every function against ``tests/oracle.py``,
  hashlib and the port's Poseidon (skipped without ``g++``), and two
  processes that load from one empty build directory at once.
"""

import hashlib
import json
import logging
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.stark import watch as jwatch
from vectorx_tpu.utils import profiling as jprof
from vectorx_tpu.utils import xxhash as jxx
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.runtime import native
from vectorx_tpu_torch.stark import watch
from vectorx_tpu_torch.utils import profiling, xxhash

from oracle import P, gl_inv, gl_mul, ntt_naive

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RNG_SEED = 83


# -- xxhash -------------------------------------------------------------------

def test_xxhash_spot_values():
    assert xxhash.twox128(b"System").hex() == "26aa394eea5630e07c48ae0c9558cef7"
    assert xxhash.twox128(b"Account").hex() == "b99d880ec681799c0cf30e8886371da9"
    assert xxhash.xxhash64(b"", 0) == 0xEF46DB3751D8E999
    k = xxhash.storage_key("Grandpa", "CurrentSetId")
    assert len(k) == 32 and k[:16] == xxhash.twox128(b"Grandpa")


def test_xxhash_equals_reference():
    rng = np.random.default_rng(RNG_SEED)
    # every tail class: < 4, < 8, < 32 and the 32-byte stripes
    for n in list(range(0, 70)) + [127, 128, 1000]:
        data = rng.bytes(n)
        seed = int(rng.integers(0, 1 << 63)) if n % 3 else n % 2
        assert xxhash.xxhash64(data, seed) == jxx.xxhash64(data, seed)
        assert xxhash.twox128(data) == jxx.twox128(data)
    for pallet, item in [("Grandpa", "CurrentSetId"), ("System", "Number"),
                         ("Babe", "EpochIndex")]:
        assert xxhash.storage_key(pallet, item) == jxx.storage_key(pallet, item)


# -- profiling ----------------------------------------------------------------

def test_phase_timer_nests_like_the_reference():
    got, want = profiling.PhaseTimer(), jprof.PhaseTimer()
    for t in (got, want):
        with t.phase("outer"):
            with t.phase("inner"):
                pass
            with t.phase("inner"):
                pass
    assert set(got.totals) == set(want.totals) == {"outer", "outer/inner"}
    assert got.counts == want.counts == {"outer": 1, "outer/inner": 2}
    assert [line.split(":")[0] for line in got.report().splitlines()] == \
        [line.split(":")[0] for line in want.report().splitlines()]


def test_phase_timer_synchronizes_the_cuda_devices_given(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    t = profiling.PhaseTimer()
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    with t.phase("cpu_only", torch.zeros(2)):
        pass
    assert synced == []
    with t.phase("two_cards", [cuda0, {"x": cuda1}], (cuda0,), torch.ones(1)):
        pass
    assert sorted(synced, key=str) == [cuda0, cuda1]
    synced.clear()
    with profiling.PhaseTimer(sync=False).phase("off", cuda0):
        pass
    assert synced == []


def test_xprof_trace_holds_the_annotated_region(tmp_path):
    with profiling.xprof_trace(str(tmp_path)):
        with profiling.annotate("vectorx_region"):
            torch.arange(64).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "vectorx_region"
               for e in trace["traceEvents"])


# -- watch --------------------------------------------------------------------

def _messages(caplog, fn):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="vectorx.watch"):
        fn()
        jax.effects_barrier()
    return [r.getMessage() for r in caplog.records if r.name == "vectorx.watch"]


def test_watch_logs_the_reference_lines(caplog):
    vals = [5, P - 1, 0, 1 << 40]
    want = _messages(caplog, lambda: jax.jit(
        lambda x: (jwatch.watch_fp("vals", x), x)[1])(jgl.to_fp(vals)))
    got = _messages(caplog, lambda: watch.watch_fp("vals", gl.to_fp(vals, "cpu")))
    assert got == want == [f"watch vals: {np.array(vals, np.uint64)}"]

    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    want = _messages(caplog, lambda: jwatch.watch("arr", jax.numpy.asarray(arr)))
    got = _messages(caplog, lambda: watch.watch("arr", torch.from_numpy(arr)))
    assert got == want


def test_watch_fp_logs_canonical_integers(caplog):
    # bit patterns in [p, 2^64): p + 3 and 2^64 - 1 = p + 2^32 - 2
    raw = torch.tensor(np.array([P + 3, (1 << 64) - 1], np.uint64).view(np.int64))
    got = _messages(caplog, lambda: watch.watch_fp("raw", raw))
    assert got == [f"watch raw: {np.array([3, (1 << 32) - 2], np.uint64)}"]


# -- native -------------------------------------------------------------------

@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    loaded = native.load()
    assert loaded is not None and native.available()
    return loaded


def test_native_field_ops_and_ntt(lib):
    rng = np.random.default_rng(RNG_SEED)
    for a, b in [(1, 1), (P - 1, P - 1), (0xFFFFFFFF, 0x100000000),
                 (123456789123456789, 987654321987654321)]:
        assert native.gl_mul(a, b) == gl_mul(a % P, b % P)
        assert native.gl_inv(a) == gl_inv(a % P)
    assert lib.vx_gl_add(P - 1, 5) == 4 and lib.vx_gl_sub(3, 5) == P - 2
    for log_n in (3, 6, 8):
        n = 1 << log_n
        v = [int(x) % P for x in rng.integers(0, 1 << 64, n, dtype=np.uint64)]
        root = gl.primitive_root_of_unity(log_n)
        got = native.ntt(v, root)
        assert [int(x) for x in got] == ntt_naive(v, root)
        assert [int(x) for x in native.ntt(got, root, inverse=True)] == v


def test_native_poseidon_equals_the_port(lib):
    from vectorx_tpu_torch.hashes import poseidon as ps
    states = np.random.default_rng(RNG_SEED).integers(0, P, (4, 12),
                                                      dtype=np.uint64)
    got = native.poseidon_permute(states.copy())
    assert (got == ps.permute_np(states.copy())).all()
    assert [int(x) for x in got[0]] == ps.permute_ints([int(x) for x in states[0]])
    with pytest.raises(ValueError):
        native.poseidon_permute(states[:, :8])


def test_native_hashes_match_hashlib(lib):
    rng = np.random.default_rng(RNG_SEED)
    for n in (0, 1, 53, 127, 128, 129, 1000):
        msg = rng.bytes(n)
        assert native.blake2b256(msg) == hashlib.blake2b(msg, digest_size=32).digest()
        assert native.sha256(msg) == hashlib.sha256(msg).digest()
    lens = np.array([10, 128, 200, 0], np.uint32)
    raw = [rng.bytes(int(n)) for n in lens]
    msgs = np.zeros((4, 256), np.uint8)
    for i, r in enumerate(raw):
        msgs[i, :len(r)] = np.frombuffer(r, np.uint8)
    out = native.blake2b256_batch(msgs, lens)
    assert [bytes(o) for o in out] == [
        hashlib.blake2b(r, digest_size=32).digest() for r in raw]


LOADER = """
import os, sys, time
from vectorx_tpu_torch.runtime import native
print("ready", flush=True)
while not os.path.exists(sys.argv[2]):
    time.sleep(0.001)
lib = native.load(sys.argv[1])
print(lib.vx_gl_mul(3, 5) if lib is not None else "none", flush=True)
"""


def test_two_processes_load_one_empty_build_dir_at_once(tmp_path):
    """Both build or wait under the lock; neither loads a partial file."""
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    build, go = tmp_path / "build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(build), str(go)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready"
        go.touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["15", "15"]
    assert sorted(f.name for f in build.iterdir()) == ["libvxnative.lock",
                                                       "libvxnative.so"]
