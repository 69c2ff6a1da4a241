"""CUDA Poseidon for Hopper — the wrappers of csrc/poseidon.cu.

Replaces the TPU kernel ``_kernel`` of ``vectorx_tpu/ops/poseidon_pallas.py``
(launched by ``permute_tiles``/``permute``): the width-12 Goldilocks
Poseidon with the sparse partial rounds. Three entries share its arithmetic:

- ``permute``      (..., 12) states. Large batches run a thread per state
                   (bound by the INT32 rate: ~1,100 modular products against
                   192 bytes per state); batches of at most
                   ``COOP_MAX_STATES`` run a 16-lane group per state (bound
                   by the time of one permutation's dependent chain).
- ``duplex``       one transcript state through a whole chain of absorbs
                   and squeezes in one launch, the state in registers.
- ``sponge_rows``  the leaf digests of an (n, w) matrix in one launch, read
                   through its strides (a transposed view of a column-major
                   matrix is read as it lies).

The plain versions are ``permute_plain``, ``duplex_plain`` and
``hash_many_plain`` of ``hashes/poseidon.py``. Every wrapper launches its
kernel or raises; none falls back to a plain version.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/torch_kernels/`` of
the checkout, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from ..hashes import poseidon as ps

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "poseidon.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

WIDTH, RATE, DIGEST_WIDTH = ps.WIDTH, ps.RATE, ps.DIGEST_WIDTH

#: largest batch (states, or rows of a sponge) that takes the cooperative
#: kernel; above it a thread per state is faster on an H100 (the measured
#: crossover is in PERF.md; chip_smoke.py prints it)
COOP_MAX_STATES = 4096

#: launches per entry since the last reset (comparisons included)
launches = {"permute": 0, "duplex": 0, "sponge_rows": 0}
#: nvcc's output (register/spill report) of the build in this process
build_log = ""

_lib = None
_ready_devices: set = set()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the Poseidon kernels cannot be built")
    return str(path)


def build(extra_flags: Sequence[str] = ()) -> Path:
    """Compile csrc/poseidon.cu (once per source version and flag set) ->
    the .so path. ``extra_flags`` (``-D...``) builds a variant for
    measurement; the port itself builds with none."""
    global build_log
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(extra_flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libvx_poseidon_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{build_log}")
    os.replace(tmp, out)
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = ctypes.CDLL(str(path))
    for name, args in (
            ("vx_poseidon_set_constants", [p] * 5),
            ("vx_poseidon_permute", [p, p, i64, p]),
            ("vx_poseidon_permute_coop", [p, p, i64, p]),
            ("vx_poseidon_duplex", [p, p, i64, i64, p, p, i64, p]),
            ("vx_poseidon_sponge_rows", [p, i64, i64, i64, i64, p, p]),
            ("vx_poseidon_sponge_rows_coop", [p, i64, i64, i64, i64, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.vx_poseidon_mds_shifts.argtypes = [p]
    lib.vx_poseidon_mds_shifts.restype = None
    lib.vx_poseidon_min_blocks.argtypes = []
    lib.vx_poseidon_min_blocks.restype = ctypes.c_int
    _check_baked_mds(lib)
    return lib


def _check_baked_mds(lib) -> None:
    """The MDS exponents baked into the source must be the table of
    hashes/poseidon.py (row 0 of the circulant)."""
    baked = np.zeros(WIDTH, dtype=np.int32)
    lib.vx_poseidon_mds_shifts(baked.ctypes.data)
    want = ps._mds_shift_tables()
    table = np.array([[baked[(j - i) % WIDTH] for j in range(WIDTH)]
                      for i in range(WIDTH)])
    if not np.array_equal(table, want):
        raise RuntimeError(
            f"csrc/poseidon.cu bakes MDS exponents {baked.tolist()}, "
            f"hashes.poseidon has row {want[0].tolist()}")


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def upload_constants(lib, device: torch.device) -> None:
    """Copy the round tables into ``lib``'s symbols on ``device``."""
    rows, col, d, rc = ps._np_fast_partial()
    tables = [np.ascontiguousarray(t, dtype=np.uint64)
              for t in (rc, rows, col, d, d.T)]
    with torch.cuda.device(device):
        check(lib.vx_poseidon_set_constants(
            *[t.ctypes.data for t in tables]), "Poseidon constant upload")


def _ensure_constants(device: torch.device) -> None:
    if device.index not in _ready_devices:
        upload_constants(_load(), device)
        _ready_devices.add(device.index)


def _require(t: torch.Tensor, what: str) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"poseidon_cuda: {what} must be a CUDA tensor")
    if t.dtype != torch.int64:
        raise TypeError(f"poseidon_cuda: {what} must be int64, got {t.dtype}")


def _launch(entry: str, fn, device: torch.device, *args) -> None:
    """Launch on PyTorch's current stream of ``device`` and count it."""
    _ensure_constants(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        check(fn(*args, stream), f"Poseidon {entry} launch")
    launches[entry] += 1


def _permute(state: torch.Tensor, coop: bool) -> torch.Tensor:
    _require(state, "states")
    if state.dim() == 0 or state.shape[-1] != WIDTH:
        raise ValueError(f"Poseidon states end in 12, got {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("Poseidon states must be contiguous")
    out = torch.empty_like(state)
    n = state.numel() // WIDTH
    if n == 0:
        return out
    lib = _load()
    fn = lib.vx_poseidon_permute_coop if coop else lib.vx_poseidon_permute
    _launch("permute", fn, state.device, state.data_ptr(), out.data_ptr(), n)
    return out


def permute(state: torch.Tensor) -> torch.Tensor:
    """(..., 12) int64 CUDA tensor -> permuted states (canonical)."""
    return _permute(state, state.numel() // WIDTH <= COOP_MAX_STATES)


def duplex(state: torch.Tensor, data: torch.Tensor, flush: bool,
           n_squeeze: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of a transcript's chain: absorb the full 8-element chunks
    of the flat ``data`` in overwrite mode (and, with ``flush``, its tail of
    fewer than 8), then squeeze ``n_squeeze`` elements. Returns
    (state (12,), squeezed (n_squeeze,)); see ``duplex_plain``."""
    _require(state, "the state")
    _require(data, "the data")
    if state.shape != (WIDTH,) or data.dim() != 1:
        raise ValueError(f"duplex takes a (12,) state and flat data, got "
                         f"{tuple(state.shape)} and {tuple(data.shape)}")
    if data.device != state.device:
        raise ValueError("duplex: state and data lie on different devices")
    if not (state.is_contiguous() and data.is_contiguous()):
        raise ValueError("duplex: state and data must be contiguous")
    if n_squeeze < 0:
        raise ValueError(f"duplex: n_squeeze = {n_squeeze}")
    m = data.shape[0]
    n_absorb = m // RATE + (1 if flush and m % RATE else 0)
    squeezed = torch.empty((n_squeeze,), dtype=torch.int64, device=state.device)
    if n_absorb == 0 and n_squeeze == 0:
        return state, squeezed
    out = torch.empty_like(state)
    _launch("duplex", _load().vx_poseidon_duplex, state.device,
            state.data_ptr(), data.data_ptr(), m, n_absorb, out.data_ptr(),
            squeezed.data_ptr(), n_squeeze)
    return out, squeezed


def _sponge_rows(rows: torch.Tensor, coop: bool) -> torch.Tensor:
    _require(rows, "the rows")
    if rows.dim() != 2:
        raise ValueError(f"sponge_rows takes an (n, w) matrix, got "
                         f"{tuple(rows.shape)}")
    n, w = rows.shape
    out = torch.empty((n, DIGEST_WIDTH), dtype=torch.int64, device=rows.device)
    if n == 0:
        return out
    stride_n, stride_w = rows.stride()
    if stride_n < 0 or stride_w < 0:
        raise ValueError(f"sponge_rows: strides {rows.stride()}")
    lib = _load()
    fn = lib.vx_poseidon_sponge_rows_coop if coop else lib.vx_poseidon_sponge_rows
    _launch("sponge_rows", fn, rows.device, rows.data_ptr(), n, w, stride_n,
            stride_w, out.data_ptr())
    return out


def sponge_rows(rows: torch.Tensor) -> torch.Tensor:
    """(n, w) int64 CUDA matrix of any strides -> (n, 4) digests of its
    rows: the overwrite-mode sponge, zero-padded to a multiple of 8."""
    return _sponge_rows(rows, rows.dim() == 2
                        and rows.shape[0] <= COOP_MAX_STATES)
