"""CUDA Poseidon permutation for Hopper — the wrapper of csrc/poseidon.cu.

Replaces the TPU kernel ``_kernel`` of ``vectorx_tpu/ops/poseidon_pallas.py``
(launched by ``permute_tiles``/``permute``): the width-12 Goldilocks
Poseidon with the sparse partial rounds. On the H100 it is ALU-bound: 30
rounds of 64-bit modular products (~1,100 per permutation) against 192
bytes of device-memory traffic, so the design keeps the whole state in
registers, one thread per permutation, and reads the (B, 12) rows in place.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/torch_kernels/`` of
the checkout, and loaded with ctypes. The plain version is
``hashes.poseidon.permute_plain``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "poseidon.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches of the kernel since the last reset (comparisons included)
launches = 0
#: nvcc's output (register/spill report) of the build in this process
build_log = ""

_lib = None
_ready_devices: set = set()


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the Poseidon kernel cannot be built")
    return str(path)


def build() -> Path:
    """Compile csrc/poseidon.cu (once per source version) -> the .so path."""
    global build_log
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libvx_poseidon_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.vx_poseidon_set_constants.argtypes = [ctypes.c_void_p] * 5
        lib.vx_poseidon_set_constants.restype = ctypes.c_int
        lib.vx_poseidon_permute.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_void_p]
        lib.vx_poseidon_permute.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def _ensure_constants(device: torch.device) -> None:
    """Upload the round tables to this device's constant memory."""
    if device.index in _ready_devices:
        return
    from ..hashes import poseidon as ps
    rows, col, d, rc = ps._np_fast_partial()
    tables = [np.ascontiguousarray(t, dtype=np.uint64)
              for t in (rc, rows, col, d)]
    tables.append(np.ascontiguousarray(ps._mds_shift_tables(),
                                       dtype=np.uint32))
    with torch.cuda.device(device):
        _check(_load().vx_poseidon_set_constants(
            *[t.ctypes.data for t in tables]), "Poseidon constant upload")
    _ready_devices.add(device.index)


def permute(state: torch.Tensor) -> torch.Tensor:
    """(..., 12) int64 CUDA tensor -> permuted states (canonical)."""
    global launches
    if not state.is_cuda:
        raise ValueError("poseidon_cuda.permute needs a CUDA tensor")
    if state.dtype != torch.int64:
        raise TypeError(f"Poseidon states are int64, got {state.dtype}")
    if state.dim() == 0 or state.shape[-1] != 12:
        raise ValueError(f"Poseidon states end in 12, got {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("Poseidon states must be contiguous")
    out = torch.empty_like(state)
    n = state.numel() // 12
    if n == 0:
        return out
    _ensure_constants(state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    with torch.cuda.device(state.device):
        _check(_load().vx_poseidon_permute(state.data_ptr(), out.data_ptr(),
                                           n, stream), "Poseidon launch")
    launches += 1
    return out
