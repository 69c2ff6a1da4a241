"""FRI low-degree proof over Goldilocks / GF(p^2) — commit, fold, query.

Protocol (degree bound d = N >> rate_bits, coset domain s·H_N):

  commit:  for each layer, pack leaf j = [f(x_j), f(-x_j)] (as 4 base
           elements), Merkle-commit, observe cap, squeeze β ∈ GF(p^2), fold
               f'(x²) = (f(x)+f(-x))/2 + β·(f(x)-f(-x))/(2x)
           halving the domain (shift s → s²), until the codeword reaches
           final_poly_len << rate_bits; then open the final polynomial's
           coefficients in the clear (coset-INTT) and observe them.
  query:   num_queries indices from the transcript; per layer open the leaf
           + Merkle path; the verifier re-folds and checks consistency down
           to a direct evaluation of the final polynomial.

Layer-0 openings are returned to the caller on verify so the STARK can
cross-check them against its own DEEP composition.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import ext
from ..hashes import poseidon as ps
from ..poly import ntt as pntt
from . import merkle
from .challenger import Challenger

P = gl.MODULUS
INV2 = pow(2, P - 2, P)


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3          # blowup 8
    num_queries: int = 28
    final_poly_len: int = 8     # coefficients sent in the clear
    cap_height: int = 0
    pow_bits: int = 0           # proof-of-work grinding before query sampling

    def num_layers(self, log_n: int) -> int:
        final_size_bits = (self.final_poly_len.bit_length() - 1) + self.rate_bits
        return log_n - final_size_bits


@dataclass
class FriProof:
    caps: List[gl.Fp]            # per layer: (2^cap_height, 4)
    final_coeffs: ext.Fp2        # (final_poly_len,)
    # per layer: leaves (num_queries, 4), paths (num_queries, depth_k, 4)
    query_leaves: List[gl.Fp]
    query_paths: List[gl.Fp]
    pow_nonce: gl.Fp             # scalar; 0 when pow_bits == 0


# ---------------------------------------------------------------------------
# Host-side domain precomputation
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _layer_domain(log_n0: int, layer: int,
                  shift0: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    """(shift, root, log_size) of the layer's evaluation domain."""
    shift = shift0
    for _ in range(layer):
        shift = (shift * shift) % P
    log_n = log_n0 - layer
    return shift, gl.primitive_root_of_unity(log_n), log_n


@lru_cache(maxsize=None)
def _inv_2x_table(log_n0: int, layer: int) -> np.ndarray:
    """inv(2 * s * w^j) for j in [0, N_layer/2) as uint64."""
    shift, root, log_n = _layer_domain(log_n0, layer)
    out = np.empty(1 << (log_n - 1), dtype=np.uint64)
    winv = pow(root, P - 2, P)
    acc = pow(2 * shift % P, P - 2, P)
    for j in range(out.shape[0]):
        out[j] = acc
        acc = (acc * winv) % P
    return out


@lru_cache(maxsize=None)
def _root_pow_table(log_n0: int, layer: int) -> List[int]:
    """w^(2^b) for b in [0, log_n): squared-power ladder."""
    _, root, log_n = _layer_domain(log_n0, layer)
    vals = []
    acc = root
    for _ in range(max(log_n, 1)):
        vals.append(acc)
        acc = (acc * acc) % P
    return vals


def _grind_batch(pow_bits: int) -> int:
    """Nonces per grinding batch: ~4 expected hits per batch, at least
    1024. The result does not depend on it (lowest nonce wins)."""
    return 1 << min(max(pow_bits + 2, 10), 20)


def _grind_nonce(challenger: Challenger, pow_bits: int) -> gl.Fp:
    """The LOWEST nonce whose absorption makes the next squeeze start with
    pow_bits low-order zero bits (on the squeezed element's low word —
    the word squeeze_indices samples from). Batches are scanned in order
    and the smallest hit of the first batch that has one is taken."""
    challenger._flush()
    state = challenger.state
    mask = (1 << pow_bits) - 1
    batch = _grind_batch(pow_bits)
    lanes = torch.arange(batch, dtype=torch.int64, device=state.device)
    for start in range(0, 1 << 32, batch):
        states = state.expand(batch, ps.WIDTH).clone()
        states[:, 0] = lanes + start
        hits = torch.nonzero((ps.permute(states)[:, 0] & mask) == 0)
        if hits.numel():
            return states[int(hits[0, 0]), 0].clone()
    raise RuntimeError(f"no {pow_bits}-bit proof-of-work nonce below 2^32")


def _pow_indices(table: List[int], exp: torch.Tensor, nbits: int) -> gl.Fp:
    """w^exp for a tensor of exponents, from the squared-power ladder."""
    acc = torch.ones_like(exp)
    for b in range(nbits):
        bit = ((exp >> b) & 1) == 1
        acc = torch.where(bit, gl.mul(acc, gl.full((), table[b], exp.device)),
                          acc)
    return acc


# ---------------------------------------------------------------------------
# Codeword packing / folding
# ---------------------------------------------------------------------------

def _pack_leaves(cw: ext.Fp2) -> gl.Fp:
    """(N,) Fp2 codeword -> (N/2, 4) base rows [re(a), im(a), re(b), im(b)]."""
    re, im = cw
    h = re.shape[0] // 2
    return torch.stack([re[:h], im[:h], re[h:], im[h:]], dim=1)


def fold(cw: ext.Fp2, beta: ext.Fp2, log_n0: int, layer: int) -> ext.Fp2:
    """One FRI fold: (N,) codeword -> (N/2,) on the squared domain."""
    h = cw[0].shape[0] // 2
    a = (cw[0][:h], cw[1][:h])
    b = (cw[0][h:], cw[1][h:])
    dev = cw[0].device
    s = ext.mul_base(ext.add(a, b), gl.full((), INV2, dev))
    inv2x = torch.from_numpy(_inv_2x_table(log_n0, layer).view(np.int64)).to(dev)
    d = ext.mul_base(ext.sub(a, b), inv2x)
    return ext.add(s, ext.mul(d, beta))


def _coset_intt_fp2(cw: ext.Fp2, log_n0: int, layer: int) -> ext.Fp2:
    """Coefficients of the polynomial whose coset evals are `cw`."""
    shift, _, _ = _layer_domain(log_n0, layer)
    return pntt.coset_intt(cw[0], shift), pntt.coset_intt(cw[1], shift)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def prove(codeword: ext.Fp2, challenger: Challenger, config: FriConfig):
    """Commit-phase + query-phase for a (N,) GF(p^2) codeword. The caller
    must already have bound the codeword's provenance into the transcript.
    Returns (proof, query indices)."""
    n = codeword[0].shape[0]
    log_n = n.bit_length() - 1
    num_layers = config.num_layers(log_n)
    if num_layers < 0:
        raise ValueError("codeword shorter than the final polynomial")

    trees: List[merkle.MerkleTree] = []
    codewords: List[ext.Fp2] = []
    cw = codeword
    for layer in range(num_layers):
        codewords.append(cw)
        tree = merkle.build(_pack_leaves(cw), cap_height=config.cap_height)
        trees.append(tree)
        challenger.observe_digests(tree.cap)
        beta = challenger.squeeze_ext(1)
        cw = fold(cw, (beta[0][0], beta[1][0]), log_n, layer)

    # final polynomial, in the clear
    full_re, full_im = _coset_intt_fp2(cw, log_n, num_layers)
    fl = config.final_poly_len
    final_coeffs = (full_re[:fl], full_im[:fl])
    challenger.observe(torch.cat(final_coeffs))

    # proof-of-work grinding before query sampling; the nonce is always
    # transcript-bound (nonce 0 trivially passes the empty check)
    if config.pow_bits > 0:
        pow_nonce = _grind_nonce(challenger, config.pow_bits)
    else:
        pow_nonce = gl.zeros((), codeword[0].device)
    challenger.observe(pow_nonce.reshape(1))
    challenger.squeeze(1)       # the checked response; advances the state

    indices = challenger.squeeze_indices(config.num_queries, log_n - 1)
    query_leaves, query_paths = [], []
    idx = indices
    for layer in range(num_layers):
        half = 1 << (log_n - layer - 1)
        layer_idx = torch.remainder(idx, half)
        query_leaves.append(_pack_leaves(codewords[layer])[layer_idx])
        query_paths.append(merkle.prove(trees[layer], layer_idx))
        idx = layer_idx

    proof = FriProof(caps=[t.cap for t in trees], final_coeffs=final_coeffs,
                     query_leaves=query_leaves, query_paths=query_paths,
                     pow_nonce=pow_nonce)
    return proof, indices


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

def transcript(proof: FriProof, log_n: int, challenger: Challenger,
               config: FriConfig):
    """Drive the FRI transcript (caps -> betas, final coeffs, pow, query
    indices)."""
    num_layers = config.num_layers(log_n)
    if len(proof.caps) != num_layers:
        raise ValueError("FRI proof has the wrong number of layers")
    betas = []
    for layer in range(num_layers):
        challenger.observe_digests(proof.caps[layer])
        b = challenger.squeeze_ext(1)
        betas.append((b[0][0], b[1][0]))
    challenger.observe(torch.cat(proof.final_coeffs))
    if config.pow_bits > 0:
        # the prover's grind absorbs the pending final coefficients before
        # the nonce (_grind_nonce flushes); a no-op when 2 * final_poly_len
        # is a multiple of RATE. The JAX verifier omits this flush and so
        # rejects honest proofs with pow_bits > 0 and other lengths.
        challenger._flush()
    challenger.observe(proof.pow_nonce.reshape(1))
    resp = challenger.squeeze(1)
    indices = challenger.squeeze_indices(config.num_queries, log_n - 1)
    return betas, resp, indices


def check(proof: FriProof, log_n: int, config: FriConfig, betas, resp,
          indices):
    """The value checks of FRI verification: pow mask, per-layer Merkle
    membership + fold consistency, final-poly match.
    Returns (ok bool tensor, layer0 (a, b, leaf_idx))."""
    num_layers = config.num_layers(log_n)
    dev = indices.device
    ok = torch.ones((), dtype=torch.bool, device=dev)
    if config.pow_bits > 0:
        ok = ok & ((resp[0] & ((1 << config.pow_bits) - 1)) == 0)
    idx = indices
    cur = None
    layer0_vals = None
    inv2 = gl.full((), INV2, dev)

    for layer in range(num_layers):
        half = 1 << (log_n - layer - 1)
        layer_idx = torch.remainder(idx, half)
        leaf = proof.query_leaves[layer]   # (q, 4)
        ok = ok & torch.all(merkle.verify_batch(
            proof.caps[layer], layer_idx, leaf, proof.query_paths[layer]))

        a = (leaf[:, 0], leaf[:, 1])   # f(x)
        b = (leaf[:, 2], leaf[:, 3])   # f(-x)
        if layer == 0:
            layer0_vals = (a, b, layer_idx)
        else:
            # the previous fold must equal this layer's codeword at the
            # previous index: first half -> a, else -> b
            expect = ext.select(idx < half, a, b)
            ok = ok & torch.all(ext.eq(cur, expect))

        shift, _, llog = _layer_domain(log_n, layer)
        w_i = _pow_indices(_root_pow_table(log_n, layer), layer_idx,
                           llog - 1 if llog > 1 else 1)
        x = gl.mul(gl.full((), shift, dev), w_i)
        inv2x = gl.inv(gl.mul(gl.full((), 2, dev), x))
        s = ext.mul_base(ext.add(a, b), inv2)
        d = ext.mul_base(ext.sub(a, b), inv2x)
        cur = ext.add(s, ext.mul(d, betas[layer]))
        idx = layer_idx

    # final: evaluate the final poly at the folded domain point (Horner)
    shift, _, llog = _layer_domain(log_n, num_layers)
    w_i = _pow_indices(_root_pow_table(log_n, num_layers), idx, max(llog, 1))
    x = gl.mul(gl.full((), shift, dev), w_i)
    fc_re, fc_im = proof.final_coeffs
    fl = fc_re.shape[0]
    acc = (fc_re[fl - 1].expand(x.shape), fc_im[fl - 1].expand(x.shape))
    for i in range(fl - 2, -1, -1):
        acc = ext.add(ext.mul_base(acc, x), (fc_re[i], fc_im[i]))
    ok = ok & torch.all(ext.eq(cur, acc))
    return ok, layer0_vals


def verify(proof: FriProof, log_n: int, challenger: Challenger,
           config: FriConfig):
    """Returns (ok bool tensor, indices (q,), layer0 (a, b, leaf_idx)).

    The caller must drive `challenger` identically to the prover before
    this call, and checks the returned layer-0 openings against the DEEP
    composition values."""
    betas, resp, indices = transcript(proof, log_n, challenger, config)
    ok, layer0 = check(proof, log_n, config, betas, resp, indices)
    return ok, indices, layer0
