"""Poseidon permutation over Goldilocks — the prover's algebraic hash.

Transcript (Fiat-Shamir) hashing and Merkle commitments of the STARK. The
parameters, constants and MDS matrix are those of the JAX package, so
digests match it bit for bit:

- width t = 12 (rate 8, capacity 4), digests are 4 field elements;
- S-box x^7; 8 full rounds (4 + 4) around 22 partial rounds;
- MDS: the 12x12 circulant with power-of-two entries (MDS_ROW);
- round constants: a SHA-256 counter stream over a domain tag,
  rejection-sampled below p.

States are int64 tensors of shape (..., 12) (see field/goldilocks.py).
``permute``, ``duplex`` (a transcript's chain of absorbs and squeezes) and
``hash_many`` (leaf digests) launch the CUDA kernels (ops/poseidon_cuda.py)
for every CUDA tensor. Their plain versions in torch ops (``permute_plain``,
the dense 30 rounds, and the loops over it) are what the kernels are held
against on the card. CPU tensors take the host route: ``permute_np`` and
``hash_many_np`` on numpy uint64 arrays, and ``duplex_ints`` on Python ints
for the one state of a transcript; torch's per-op cost makes its rounds
three to six times slower there.
"""

from __future__ import annotations

import hashlib
import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl

WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST_WIDTH = 4
FULL_ROUNDS = 8  # 4 before + 4 after the partial rounds
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
ALPHA = 7

P = gl.MODULUS

_DOMAIN_TAG = b"vectorx_tpu/poseidon/goldilocks/t12a7/v1"


# ---------------------------------------------------------------------------
# Constant generation (host-side, exact)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def round_constants() -> Tuple[Tuple[int, ...], ...]:
    """(N_ROUNDS, WIDTH) round constants from a SHA-256 counter stream."""
    out: List[int] = []
    counter = 0
    while len(out) < N_ROUNDS * WIDTH:
        h = hashlib.sha256(_DOMAIN_TAG + counter.to_bytes(8, "little")).digest()
        counter += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off:off + 8], "little")
            if v < P:  # rejection sampling: uniform in [0, p)
                out.append(v)
            if len(out) == N_ROUNDS * WIDTH:
                break
    return tuple(
        tuple(out[r * WIDTH:(r + 1) * WIDTH]) for r in range(N_ROUNDS)
    )


#: circulant MDS row; every entry is a power of two, so the MDS layer is
#: shift-accumulate (MDS property verified exhaustively by the JAX
#: package's scripts/verify_mds.py)
MDS_ROW = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)


@lru_cache(maxsize=None)
def mds_matrix() -> Tuple[Tuple[int, ...], ...]:
    """12x12 circulant MDS matrix M[i][j] = MDS_ROW[(j - i) mod 12]."""
    return tuple(
        tuple(MDS_ROW[(j - i) % WIDTH] for j in range(WIDTH))
        for i in range(WIDTH)
    )


@lru_cache(maxsize=None)
def _np_constants():
    """(round constants (30, 12), MDS matrix (12, 12)) as uint64."""
    return (np.array(round_constants(), dtype=np.uint64),
            np.array(mds_matrix(), dtype=np.uint64))


@lru_cache(maxsize=None)
def _mds_shift_tables() -> np.ndarray:
    """(12, 12) shift amounts log2(M[i][j])."""
    m = np.array(mds_matrix(), dtype=np.uint64)
    if np.any(m & (m - np.uint64(1))):
        raise ValueError("MDS entries must be powers of two")
    return np.log2(m.astype(np.float64)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Pure-Python oracle (exact ints)
# ---------------------------------------------------------------------------

def permute_ints(state: Sequence[int]) -> List[int]:
    if len(state) != WIDTH:
        raise ValueError("Poseidon state must have 12 elements")
    s = [x % P for x in state]
    rc = round_constants()
    m = mds_matrix()

    def full_round(s, r):
        s = [(x + c) % P for x, c in zip(s, rc[r])]
        s = [pow(x, ALPHA, P) for x in s]
        return [sum(m[i][j] * s[j] for j in range(WIDTH)) % P for i in range(WIDTH)]

    def partial_round(s, r):
        s = [(x + c) % P for x, c in zip(s, rc[r])]
        s[0] = pow(s[0], ALPHA, P)
        return [sum(m[i][j] * s[j] for j in range(WIDTH)) % P for i in range(WIDTH)]

    r = 0
    for _ in range(FULL_ROUNDS // 2):
        s = full_round(s, r); r += 1
    for _ in range(PARTIAL_ROUNDS):
        s = partial_round(s, r); r += 1
    for _ in range(FULL_ROUNDS // 2):
        s = full_round(s, r); r += 1
    return s


def _mat_inv_mod(A: Sequence[Sequence[int]]) -> List[List[int]]:
    """Exact inverse of a square matrix mod p (Gauss-Jordan)."""
    n = len(A)
    M = [[A[i][j] % P for j in range(n)] + [1 if j == i else 0 for j in range(n)]
         for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if M[r][col] % P != 0)
        M[col], M[piv] = M[piv], M[col]
        inv = pow(M[col][col], P - 2, P)
        M[col] = [(x * inv) % P for x in M[col]]
        for r in range(n):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(M[r][j] - f * M[col][j]) % P for j in range(2 * n)]
    return [row[n:] for row in M]


@lru_cache(maxsize=None)
def fast_partial_ints():
    """Poseidon-paper Appendix-B sparse factorization of the partial rounds.

    The 22 partial rounds  s -> M @ sbox0(s + rc_r)  are rewritten as

        for i in 0..21:  s -> S_i @ sbox0(s + a_i*e0)
        s -> D @ s + L

    with each S_i sparse ([[m00_i, v_i^T], [w_hat_i, I]]) and one dense
    D = [[1, 0], [0, Mh_0 Mh_1 ... Mh_21]] at the end; the lanes-1..11
    round constants fold forward into a_i and the leftover L.

    Returns (a, rows, whats, D, L):
      a[i]      lane-0 pre-sbox constant, round i
      rows[i]   length-12: [m00_i, v_i(11)]   (out0 = <rows[i], state'>)
      whats[i]  length-12: [0,     w_hat_i(11)] (out_j = whats[i][j]*s0' + s_j)
      D         12x12 dense matrix ([[1,0],[0,Dh]])
      L         length-12 leftover constant vector
    """
    t, n_p, hf = WIDTH, PARTIAL_ROUNDS, FULL_ROUNDS // 2
    M = [list(r) for r in mds_matrix()]
    rc = round_constants()

    # ---- constant folding: full-width rc -> lane-0 a_i + leftover L ----
    c = list(rc[hf])
    a: List[int] = []
    L: List[int] = []
    for i in range(n_p):
        a.append(c[0])
        tail = [sum(M[r][j] * c[j] for j in range(1, t)) % P for r in range(t)]
        if i < n_p - 1:
            c = [(tail[k] + rc[hf + i + 1][k]) % P for k in range(t)]
        else:
            L = tail

    # ---- sparse factorization ----
    def matmul(A, B):
        n = len(A)
        return [[sum(A[i][k] * B[k][j] for k in range(n)) % P
                 for j in range(n)] for i in range(n)]

    Mi = [row[:] for row in M]
    rows: List[List[int]] = []
    whats: List[List[int]] = []
    Dh = [[1 if i == j else 0 for j in range(t - 1)] for i in range(t - 1)]
    for i in range(n_p):
        m00 = Mi[0][0]
        v = [Mi[0][j] for j in range(1, t)]
        w = [Mi[r][0] for r in range(1, t)]
        Mh = [[Mi[r][j] for j in range(1, t)] for r in range(1, t)]
        w_hat = [sum(r_ * w_ for r_, w_ in zip(row, w)) % P
                 for row in _mat_inv_mod(Mh)]
        rows.append([m00] + v)
        whats.append([0] + w_hat)
        Dh = matmul(Dh, Mh)
        # M_{i+1} = S_i @ M_i'
        S = [[m00] + v] + [[w_hat[r]] + [1 if j == r else 0
                                         for j in range(t - 1)]
                           for r in range(t - 1)]
        Mp = [[1] + [0] * (t - 1)] + [[0] + Mh[r] for r in range(t - 1)]
        Mi = matmul(S, Mp)
    D = [[1] + [0] * (t - 1)] + [[0] + Dh[r] for r in range(t - 1)]
    return (tuple(a), tuple(map(tuple, rows)), tuple(map(tuple, whats)),
            tuple(map(tuple, D)), tuple(L))


@lru_cache(maxsize=None)
def _np_fast_partial():
    """The kernel's tables as uint64: (rows (22, 12), cols (22, 12) with
    a_i in slot 0, D (12, 12), rc (30, 12) with L folded into row 26)."""
    a, rows, whats, D, L = fast_partial_ints()
    hf = FULL_ROUNDS // 2
    rc = [list(r) for r in round_constants()]
    rc[hf + PARTIAL_ROUNDS] = [(x + l) % P for x, l in
                               zip(rc[hf + PARTIAL_ROUNDS], L)]
    # a_i rides slot 0 of the w_hat table: lane 0 of the column scatter
    # is overwritten by the row dot, so that slot is free
    col = [(a[i],) + whats[i][1:] for i in range(PARTIAL_ROUNDS)]
    return tuple(np.array(x, dtype=np.uint64) for x in (rows, col, D, rc))


# ---------------------------------------------------------------------------
# Host route — numpy uint64 (n, 12) states, and Python ints for one state
# ---------------------------------------------------------------------------

_U32 = np.uint64(32)
_M32 = np.uint64(0xFFFFFFFF)
_EPS = np.uint64(gl.EPSILON)                  # 2^64 mod p
_P_U = np.uint64(P)


def _mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b (mod p) for any 64-bit a, b, as a 64-bit value that may be
    >= p: the 128-bit product from 32-bit halves (its low word by the
    wrapping product), then lo - hi_hi + hi_lo * EPS."""
    a0, a1 = a & _M32, a >> _U32
    b0, b1 = b & _M32, b >> _U32
    lh, hl = a0 * b1, a1 * b0
    mid = (lh & _M32) + (hl & _M32) + ((a0 * b0) >> _U32)
    hi = a1 * b1 + (lh >> _U32) + (hl >> _U32) + (mid >> _U32)
    lo = a * b
    n3 = hi >> _U32
    t0 = lo - n3
    t0 -= (lo < n3) * _EPS                    # a borrow: -2^64 is -EPS
    t = (hi & _M32) * _EPS
    r = t0 + t
    r += (r < t) * _EPS                       # a carry: +2^64 is +EPS
    return r


@lru_cache(maxsize=None)
def _mds_f64() -> np.ndarray:
    """M^T as float64: a sum of twelve products of 32-bit halves and
    entries <= 2^16 stays below 2^52, so the float product is exact."""
    return np.array(mds_matrix(), dtype=np.float64).T.copy()


def _mds_np(s: np.ndarray) -> np.ndarray:
    """(n, 12) any 64-bit values -> M s (canonical)."""
    m = _mds_f64()
    slo = ((s & _M32).astype(np.float64) @ m).astype(np.uint64)
    shi = ((s >> _U32).astype(np.float64) @ m).astype(np.uint64)
    lo = slo + (shi << _U32)                  # slo + shi * 2^32 = lo + k 2^64
    t = ((shi >> _U32) + (lo < slo)) * _EPS
    r = lo + t
    r += (r < t) * _EPS
    return np.where(r >= _P_U, r - _P_U, r)


def _sbox_np(x: np.ndarray) -> np.ndarray:
    x2 = _mul_np(x, x)
    return _mul_np(_mul_np(x2, x2), _mul_np(x2, x))


def permute_np(state: np.ndarray) -> np.ndarray:
    """``permute_plain``'s function on (n, 12) numpy uint64 states: the
    dense 30 rounds, each value kept below 2^64 and reduced canonically by
    the MDS layer."""
    rc, _ = _np_constants()
    half_f = FULL_ROUNDS // 2
    s = np.array(state, dtype=np.uint64)
    for r in range(N_ROUNDS):
        s += rc[r]
        s += (s < rc[r]) * _EPS
        if half_f <= r < half_f + PARTIAL_ROUNDS:
            s[:, 0] = _sbox_np(s[:, 0])
        else:
            s = _sbox_np(s)
        s = _mds_np(s)
    return s


def hash_many_np(rows: np.ndarray) -> np.ndarray:
    """``hash_many_plain``'s function on an (n, w) numpy uint64 matrix ->
    (n, 4) digests."""
    n, w = rows.shape
    state = np.zeros((n, WIDTH), dtype=np.uint64)
    for i in range(0, w, RATE):
        chunk = rows[:, i:i + RATE]
        state[:, :chunk.shape[1]] = chunk
        state[:, chunk.shape[1]:RATE] = 0
        state = permute_np(state)
    return state[:, :DIGEST_WIDTH]


@lru_cache(maxsize=None)
def _int_tables():
    """The rounds in the kernel's form, as Python ints: the first full
    rounds' constants, the partial rounds' (a_i, row_i, w_hat_i) of
    ``fast_partial_ints``, D, the last full rounds' constants with L added,
    and each MDS row as shifts."""
    a, rows, whats, D, L = fast_partial_ints()
    rc = round_constants()
    half_f = FULL_ROUNDS // 2
    last = [list(c) for c in rc[half_f + PARTIAL_ROUNDS:]]
    last[0] = [(c + l) % P for c, l in zip(last[0], L)]
    logs = [m.bit_length() - 1 for m in MDS_ROW]
    shifts = [[logs[(j - i) % WIDTH] for j in range(WIDTH)]
              for i in range(WIDTH)]
    partial = [(a[i], rows[i][0], rows[i][1:], whats[i][1:])
               for i in range(PARTIAL_ROUNDS)]
    return rc[:half_f], partial, D, last, shifts


def _permute_list(s: List[int]) -> List[int]:
    """``permute_ints``'s function on 12 canonical ints, its partial rounds
    in the sparse form (a tenth of the dense rounds' products)."""
    first, partial, D, last, shifts = _int_tables()

    def full_round(s, c):
        t = [pow(x + k, ALPHA, P) for x, k in zip(s, c)]
        return [sum([x << k for x, k in zip(t, sh)]) % P for sh in shifts]

    for c in first:
        s = full_round(s, c)
    for a, r0, row, what in partial:
        x0 = pow(s[0] + a, ALPHA, P)
        tail = s[1:]
        s = [(r0 * x0 + sum([u * v for u, v in zip(row, tail)])) % P] + [
            (u * x0 + v) % P for u, v in zip(what, tail)]
    s = [sum([u * v for u, v in zip(row, s)]) % P for row in D]
    for c in last:
        s = full_round(s, c)
    return s


# ---------------------------------------------------------------------------
# Plain torch path — state is an int64 tensor of shape (..., 12)
# ---------------------------------------------------------------------------

def _sbox(x: gl.Fp) -> gl.Fp:
    """x^7 = x^4 * x^3, with x^4 and x^3 from one stacked product; lazy
    (the result may be >= p: only the MDS layer reads it)."""
    x2 = gl.mul_lazy(x, x)
    x4, x3 = gl.mul_lazy(torch.stack([x2, x2]), torch.stack([x2, x]))
    return gl.mul_lazy(x4, x3)


def _mds(state: gl.Fp, m: torch.Tensor) -> gl.Fp:
    """out[..., i] = Σ_j M[i, j] · s[..., j] for any 64-bit s (canonical
    out). With M[i, j] <= 2^16 the products of the 32-bit halves stay below
    2^48, so the twelve-term sums are exact in int64; one reduction per
    output element."""
    lo = gl._lo32(state).unsqueeze(-2)         # (..., 1, 12)
    hi = gl._hi32(state).unsqueeze(-2)
    return gl._reduce_sums((lo * m).sum(-1), (hi * m).sum(-1))


def permute_plain(state: gl.Fp) -> gl.Fp:
    """Poseidon permutation on (..., 12) states in torch ops (any device):
    the dense 30 rounds, the reference for the CUDA kernel."""
    rc_np, m_np = _np_constants()
    rc = torch.from_numpy(rc_np.view(np.int64)).to(state.device)
    m = torch.from_numpy(m_np.view(np.int64)).to(state.device)
    half_f = FULL_ROUNDS // 2
    s = state
    for r in range(N_ROUNDS):
        s = gl.add(s, rc[r])
        if half_f <= r < half_f + PARTIAL_ROUNDS:
            s = torch.cat([_sbox(s[..., :1]), s[..., 1:]], dim=-1)
        else:
            s = _sbox(s)
        s = _mds(s, m)
    return s


def permute(state: gl.Fp) -> gl.Fp:
    """Poseidon permutation on (..., 12) states: the CUDA kernel for CUDA
    tensors, ``permute_np`` for CPU tensors."""
    if state.is_cuda:
        from ..ops import poseidon_cuda
        return poseidon_cuda.permute(state.contiguous())
    if state.device.type != "cpu":
        raise NotImplementedError(f"no Poseidon path for {state.device}")
    out = permute_np(gl.to_u64(state).reshape(-1, WIDTH))
    return torch.from_numpy(out.view(np.int64)).reshape(state.shape)


def hash_two_to_one(left: gl.Fp, right: gl.Fp) -> gl.Fp:
    """Merkle 2-to-1 compression: (...,4),(...,4) -> (...,4)."""
    cap = torch.zeros(left.shape[:-1] + (CAPACITY,), dtype=torch.int64,
                      device=left.device)
    return permute(torch.cat([left, right, cap], dim=-1))[..., :DIGEST_WIDTH]


def hash_many_plain(inputs: gl.Fp) -> gl.Fp:
    """Sponge (overwrite mode) over the last axis: (..., n) -> (..., 4),
    zero-padded to a multiple of RATE; one ``permute_plain`` per chunk."""
    n = inputs.shape[-1]
    n_pad = (-n) % RATE
    if n_pad:
        inputs = torch.nn.functional.pad(inputs, (0, n_pad))
    state = torch.zeros(inputs.shape[:-1] + (WIDTH,), dtype=torch.int64,
                        device=inputs.device)
    for i in range(0, inputs.shape[-1], RATE):
        state = permute_plain(torch.cat([inputs[..., i:i + RATE],
                                         state[..., RATE:]], dim=-1))
    return state[..., :DIGEST_WIDTH]


def hash_many(inputs: gl.Fp) -> gl.Fp:
    """Sponge over the last axis, (..., n) -> (..., 4): the fused
    ``sponge_rows`` kernel for CUDA tensors (a 2-D view is read through its
    strides, so the rows of a column-major matrix need no transpose),
    ``hash_many_np`` for CPU tensors."""
    if inputs.is_cuda:
        from ..ops import poseidon_cuda
        rows = inputs if inputs.dim() == 2 else inputs.reshape(
            -1, inputs.shape[-1])
        return poseidon_cuda.sponge_rows(rows).reshape(
            inputs.shape[:-1] + (DIGEST_WIDTH,))
    if inputs.device.type != "cpu":
        raise NotImplementedError(f"no Poseidon path for {inputs.device}")
    out = hash_many_np(gl.to_u64(inputs).reshape(
        math.prod(inputs.shape[:-1]), inputs.shape[-1]))
    return torch.from_numpy(out.view(np.int64)).reshape(
        inputs.shape[:-1] + (DIGEST_WIDTH,))


def duplex_plain(state: gl.Fp, data: gl.Fp, flush: bool = False,
                 n_squeeze: int = 0) -> Tuple[gl.Fp, gl.Fp]:
    """A transcript's chain on (..., 12) states in torch ops: absorb the
    full RATE-sized chunks of ``data`` (..., m) in overwrite mode, one
    permutation each; with ``flush`` also its tail of fewer than RATE
    elements (only those lanes are overwritten); then squeeze ``n_squeeze``
    elements, up to RATE per permutation, each read followed by a
    permutation. Returns (state, squeezed (..., n_squeeze))."""
    m = data.shape[-1]
    end = m if flush else m - m % RATE
    for i in range(0, end, RATE):
        chunk = data[..., i:min(i + RATE, end)]
        state = permute_plain(
            torch.cat([chunk, state[..., chunk.shape[-1]:]], dim=-1))
    outs = [data[..., :0]]
    for i in range(0, n_squeeze, RATE):
        outs.append(state[..., :min(RATE, n_squeeze - i)])
        state = permute_plain(state)
    return state, torch.cat(outs, dim=-1)


def duplex_ints(state: gl.Fp, data: gl.Fp, flush: bool = False,
                n_squeeze: int = 0) -> Tuple[gl.Fp, gl.Fp]:
    """``duplex_plain``'s function for one (12,) state, its permutations on
    Python ints: a transcript's chain on the CPU, where torch's per-op cost
    on 12 elements dominates the torch rounds."""
    if state.shape != (WIDTH,) or data.dim() != 1:
        raise ValueError(f"duplex takes a (12,) state and flat data, got "
                         f"{tuple(state.shape)} and {tuple(data.shape)}")
    s = [int(v) for v in gl.to_u64(state)]
    d = [int(v) for v in gl.to_u64(data)]
    end = len(d) if flush else len(d) - len(d) % RATE
    for i in range(0, end, RATE):
        chunk = d[i:min(i + RATE, end)]
        s = _permute_list(chunk + s[len(chunk):])
    out: List[int] = []
    for i in range(0, n_squeeze, RATE):
        out += s[:min(RATE, n_squeeze - i)]
        s = _permute_list(s)
    return gl.to_fp(s, state.device), gl.to_fp(out, state.device)


def duplex(state: gl.Fp, data: gl.Fp, flush: bool = False,
           n_squeeze: int = 0) -> Tuple[gl.Fp, gl.Fp]:
    """``duplex_plain``'s function for one (12,) state: one launch of the
    cooperative CUDA kernel for CUDA tensors, ``duplex_ints`` for CPU
    tensors."""
    if state.is_cuda:
        from ..ops import poseidon_cuda
        return poseidon_cuda.duplex(state.contiguous(), data.contiguous(),
                                    flush, n_squeeze)
    if state.device.type != "cpu":
        raise NotImplementedError(f"no Poseidon path for {state.device}")
    return duplex_ints(state, data, flush, n_squeeze)
