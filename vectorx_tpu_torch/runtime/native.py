"""ctypes loader for the native host runtime (``native/vxnative.cpp``).

Builds the shared library on demand with ``g++ -O3`` into ``build/native/``
of the checkout and loads it; without a compiler ``available()`` is False
and the entry points are not usable.

Processes that load at once (test workers, worker pools) share one build:
the first takes an exclusive ``fcntl.flock`` on ``libvxnative.lock``,
compiles to a temporary name and ``os.replace``s it over the library; the
others wait on the lock and then find the library up to date. No process
ever loads a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from functools import lru_cache
from typing import Optional

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(_ROOT, "native", "vxnative.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB_NAME = "libvxnative.so"


def _up_to_date(so: str) -> bool:
    return (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(SOURCE))


def _build(build_dir: str) -> Optional[str]:
    """-> the path of an up-to-date library in build_dir, or None when it
    cannot be compiled."""
    so = os.path.join(build_dir, _LIB_NAME)
    if _up_to_date(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libvxnative.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _up_to_date(so):          # another process built it meanwhile
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            SOURCE], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        os.replace(tmp, so)
    return so


@lru_cache(maxsize=None)
def load(build_dir: str = BUILD_DIR) -> Optional[ctypes.CDLL]:
    """The library built into ``build_dir`` (built first if missing or
    older than the source), or None without a compiler or source."""
    if not os.path.exists(SOURCE):
        return None
    so = _build(build_dir)
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u64, size, p64 = ctypes.c_uint64, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)
    p8, p32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
    for name in ("vx_gl_mul", "vx_gl_add", "vx_gl_sub"):
        getattr(lib, name).restype = u64
        getattr(lib, name).argtypes = [u64, u64]
    lib.vx_gl_inv.restype = u64
    lib.vx_gl_inv.argtypes = [u64]
    lib.vx_gl_ntt.restype = None
    lib.vx_gl_ntt.argtypes = [p64, size, u64, ctypes.c_int]
    lib.vx_poseidon_permute.restype = None
    lib.vx_poseidon_permute.argtypes = [p64, size, p64, p64, ctypes.c_int,
                                        ctypes.c_int]
    lib.vx_blake2b256.restype = None
    lib.vx_blake2b256.argtypes = [p8, size, p8]
    lib.vx_blake2b256_batch.restype = None
    lib.vx_blake2b256_batch.argtypes = [p8, p32, size, size, p8]
    lib.vx_sha256.restype = None
    lib.vx_sha256.argtypes = [p8, size, p8]
    return lib


def available() -> bool:
    return load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def gl_mul(a: int, b: int) -> int:
    return int(load().vx_gl_mul(a, b))


def gl_inv(a: int) -> int:
    return int(load().vx_gl_inv(a))


def ntt(values, root: int, inverse: bool = False) -> np.ndarray:
    """Radix-2 NTT over uint64 values (natural order in and out)."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    load().vx_gl_ntt(_ptr(arr, ctypes.c_uint64), arr.size, root,
                     1 if inverse else 0)
    return arr


def poseidon_permute(states: np.ndarray) -> np.ndarray:
    """(batch, 12) uint64 -> permuted, with the port's Poseidon constants."""
    from ..hashes import poseidon as ps
    rc = np.asarray(ps.round_constants(), dtype=np.uint64).reshape(-1)
    mds = np.asarray(ps.mds_matrix(), dtype=np.uint64).reshape(-1)
    arr = np.ascontiguousarray(np.asarray(states, dtype=np.uint64))
    if arr.ndim != 2 or arr.shape[1] != ps.WIDTH:
        raise ValueError(f"states must be (batch, {ps.WIDTH}), got {arr.shape}")
    load().vx_poseidon_permute(
        _ptr(arr, ctypes.c_uint64), arr.shape[0], _ptr(rc, ctypes.c_uint64),
        _ptr(mds, ctypes.c_uint64), ps.FULL_ROUNDS, ps.PARTIAL_ROUNDS)
    return arr


def _bytes_arg(msg: bytes) -> np.ndarray:
    return np.frombuffer(msg, dtype=np.uint8) if msg else np.zeros(1, np.uint8)


def blake2b256(msg: bytes) -> bytes:
    out = np.zeros(32, dtype=np.uint8)
    load().vx_blake2b256(_ptr(_bytes_arg(msg), ctypes.c_uint8), len(msg),
                         _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def blake2b256_batch(msgs_padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(n, stride) uint8 + (n,) lengths -> (n, 32) uint8 digests."""
    msgs = np.ascontiguousarray(msgs_padded, dtype=np.uint8)
    lens = np.ascontiguousarray(lengths, dtype=np.uint32)
    n, stride = msgs.shape
    if lens.shape != (n,) or (n and int(lens.max()) > stride):
        raise ValueError("lengths must be (n,) and at most the stride")
    out = np.zeros((n, 32), dtype=np.uint8)
    load().vx_blake2b256_batch(_ptr(msgs, ctypes.c_uint8),
                               _ptr(lens, ctypes.c_uint32), stride, n,
                               _ptr(out, ctypes.c_uint8))
    return out


def sha256(msg: bytes) -> bytes:
    out = np.zeros(32, dtype=np.uint8)
    load().vx_sha256(_ptr(_bytes_arg(msg), ctypes.c_uint8), len(msg),
                     _ptr(out, ctypes.c_uint8))
    return out.tobytes()
