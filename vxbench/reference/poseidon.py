"""Poseidon over Goldilocks, width 12, from its specification: the hash
that commits the proofs and drives their transcripts.

- state of 12 elements, rate 8, capacity 4, digests of 4 elements;
- S-box x^7; 4 full rounds, 22 partial rounds (S-box on lane 0), 4 full
  rounds; each round adds its constants, applies the S-box, then the MDS;
- MDS: the 12 x 12 circulant M[i][j] = MDS_ROW[(j - i) mod 12];
- round constants: SHA-256 of DOMAIN_TAG | counter (8 bytes, little
  endian), each digest read as four little-endian 64-bit words, a word
  kept when it is below p, until 30 x 12 are drawn.

Sponges run in overwrite mode: a chunk of up to 8 inputs replaces the
first lanes of the state, the other rate lanes are zeroed for a leaf
hash (and kept for a transcript), then the state is permuted.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np

from . import goldilocks as gf

P = gf.P
WIDTH, RATE, DIGEST = 12, 8, 4
HALF_FULL, PARTIAL = 4, 22
N_ROUNDS = 2 * HALF_FULL + PARTIAL
DOMAIN_TAG = b"vectorx_tpu/poseidon/goldilocks/t12a7/v1"
MDS_ROW = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)


@lru_cache(maxsize=None)
def round_constants() -> tuple:
    out, counter = [], 0
    while len(out) < N_ROUNDS * WIDTH:
        d = hashlib.sha256(DOMAIN_TAG + counter.to_bytes(8, "little")).digest()
        counter += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(d[off:off + 8], "little")
            if v < P and len(out) < N_ROUNDS * WIDTH:
                out.append(v)
    return tuple(tuple(out[r * WIDTH:(r + 1) * WIDTH]) for r in range(N_ROUNDS))


def _partial(r: int) -> bool:
    return HALF_FULL <= r < HALF_FULL + PARTIAL


# -- Python ints: one state (a transcript) -----------------------------------

_SHIFTS = [MDS_ROW[j].bit_length() - 1 for j in range(WIDTH)]


def permute_ints(s: list) -> list:
    rc = round_constants()
    s = [v % P for v in s]
    for r in range(N_ROUNDS):
        s = [(v + c) % P for v, c in zip(s, rc[r])]
        if _partial(r):
            s[0] = pow(s[0], 7, P)
        else:
            s = [pow(v, 7, P) for v in s]
        s = [sum(s[j] << _SHIFTS[(j - i) % WIDTH] for j in range(WIDTH)) % P
             for i in range(WIDTH)]
    return s


class Transcript:
    """A duplex sponge on Python ints. ``observe`` absorbs whole chunks of
    8 and keeps the rest pending; ``squeeze`` absorbs what is pending
    (overwriting only those lanes), then reads up to 8 lanes per
    permutation, each read followed by a permutation. ``perms`` counts
    the permutations."""

    def __init__(self):
        self.state = [0] * WIDTH
        self.pending: list = []
        self.perms = 0

    def _absorb(self, chunk):
        self.state = permute_ints(list(chunk) + self.state[len(chunk):])
        self.perms += 1

    def observe(self, elems) -> None:
        buf = self.pending + [int(v) for v in elems]
        n_full = len(buf) // RATE * RATE
        for i in range(0, n_full, RATE):
            self._absorb(buf[i:i + RATE])
        self.pending = buf[n_full:]

    def squeeze(self, n: int) -> list:
        if self.pending:
            self._absorb(self.pending)
            self.pending = []
        out = []
        for i in range(0, n, RATE):
            out += self.state[:min(RATE, n - i)]
            self.state = permute_ints(self.state)
            self.perms += 1
        return out

    def squeeze_ext(self):
        re, im = self.squeeze(2)
        return re, im


# -- numpy: many states at once (leaves and Merkle paths) ----------------------

@lru_cache(maxsize=None)
def _np_tables():
    rc = np.array(round_constants(), dtype=np.uint64)
    m = np.array([[MDS_ROW[(j - i) % WIDTH] for j in range(WIDTH)]
                  for i in range(WIDTH)], dtype=np.uint64)
    return rc, m.T.copy()


def _sbox(x):
    x2 = gf.mul(x, x)
    x4 = gf.mul(x2, x2)
    return gf.mul(x4, gf.mul(x2, x))


def _mds(s):
    """M s for (n, 12) canonical states: the products of 32-bit halves by
    entries <= 2^16 sum below 2^52, exact in uint64."""
    _, mt = _np_tables()
    lo = (s & np.uint64(0xFFFFFFFF)) @ mt
    hi = (s >> np.uint64(32)) @ mt                      # value = lo + hi 2^32
    low = lo + ((hi & np.uint64(0xFFFFFFFF)) << np.uint64(32))
    carry = (low < lo).astype(np.uint64)
    return gf._reduce128(low, (hi >> np.uint64(32)) + carry)


def permute_np(states: np.ndarray) -> np.ndarray:
    rc, _ = _np_tables()
    s = np.array(states, dtype=np.uint64)
    for r in range(N_ROUNDS):
        s = gf.add(s, rc[r][None, :])
        if _partial(r):
            s[:, 0] = _sbox(s[:, 0])
        else:
            s = _sbox(s)
        s = _mds(s)
    return s


def hash_rows(*mats: np.ndarray) -> list:
    """Leaf digests of the rows of one or more (n_i, w_i) matrices -> a
    list of (n_i, 4) arrays. The rows of all matrices go through each
    permutation together; a row whose chunks are spent keeps its state."""
    mats = [np.asarray(m, dtype=np.uint64) for m in mats]
    widths = np.concatenate([np.full(m.shape[0], m.shape[1]) for m in mats])
    wmax = int(widths.max()) if widths.size else 0
    rows = np.zeros((widths.size, wmax), dtype=np.uint64)
    at = 0
    for m in mats:
        rows[at:at + m.shape[0], :m.shape[1]] = m
        at += m.shape[0]
    state = np.zeros((widths.size, WIDTH), dtype=np.uint64)
    for i in range(0, wmax, RATE):
        live = widths > i
        nxt = state.copy()
        nxt[:, :RATE] = 0
        take = min(RATE, wmax - i)
        nxt[:, :take] = rows[:, i:i + take]
        nxt = permute_np(nxt)
        state = np.where(live[:, None], nxt, state)
    out, at = [], 0
    for m in mats:
        out.append(state[at:at + m.shape[0], :DIGEST])
        at += m.shape[0]
    return out


def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(n, 4), (n, 4) -> (n, 4): the Merkle 2-to-1 compression."""
    z = np.zeros((left.shape[0], WIDTH - 2 * DIGEST), dtype=np.uint64)
    return permute_np(np.concatenate([left, right, z], axis=1))[:, :DIGEST]


def merkle_roots(opened: list) -> list:
    """The root each opened row leads to, for a list of (rows (q, w),
    indices (q,), paths (q, d, 4)) -> a list of (q, 4) digests. Every
    level of every path is one batched compression."""
    digests = hash_rows(*[rows for rows, _, _ in opened])
    idx = [np.asarray(i, dtype=np.int64) for _, i, _ in opened]
    depth = max((p.shape[1] for _, _, p in opened), default=0)
    for d in range(depth):
        live = [k for k, (_, _, p) in enumerate(opened) if p.shape[1] > d]
        lefts, rights = [], []
        for k in live:
            sib = np.asarray(opened[k][2][:, d], dtype=np.uint64)
            right = ((idx[k] & 1) == 1)[:, None]
            lefts.append(np.where(right, sib, digests[k]))
            rights.append(np.where(right, digests[k], sib))
        out = compress(np.concatenate(lefts), np.concatenate(rights))
        at = 0
        for k in live:
            q = digests[k].shape[0]
            digests[k] = out[at:at + q]
            idx[k] = idx[k] >> 1
            at += q
    return digests
