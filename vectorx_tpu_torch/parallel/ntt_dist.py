"""Sharded NTT: the four-step transform with its columns over a mesh.

A transform too large for one device splits its butterflies over the
mesh. The four-step decomposition makes the communication exact:

    view x as (B, n1, n2), n1 = 2^ceil(log2(n) / 2); shard the n2 columns
    stage 1: per shard, length-n1 DFTs of its columns     — local
    twiddle: elementwise w^(k1 * j2)                       — local
    transpose: (n1, n2) -> (n2, n1)                        — one all-to-all
    stage 2: per shard, length-n2 DFTs of its k1 block     — local

The result is in natural order: flat index k2 * n1 + k1. The local DFTs
are the radix-2 butterfly of ``poly/ntt.py`` over the batch; the
all-to-all is a copy of blocks between the shards' devices (one process
holds the whole mesh). The B axis batches independent polynomials
(trace columns) through the same exchange; a wide batch goes through in
blocks of columns sized from the device's free memory
(``poly/ntt.col_tile``). Exact field arithmetic gives one answer: every
entry here is bit-equal to its ``poly/ntt.py`` counterpart.

The twiddle shards are built once per (mesh, n1, n2, inverse) and kept by
``_tables``; the butterfly's stage tables are ``poly/ntt.py``'s own,
cached per (size, inverse, device). A second call builds nothing.
"""

from __future__ import annotations

from functools import lru_cache, wraps
from typing import List, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl
from ..poly import ntt as pntt
from .mesh import Mesh

P = gl.MODULUS
SHIFT = gl.MULTIPLICATIVE_GROUP_GENERATOR
#: int64 temporaries per element of a four-step pass at its peak: its
#: input, panels, blocks and output at once, and the butterfly's own on
#: a panel (at most ``poly/ntt.LDE_TEMPS``)
_FOUR_STEP_TEMPS = 4 + pntt.LDE_TEMPS


def _split(n: int) -> Tuple[int, int]:
    """(n1, n2) with n1 = 2^ceil(log2(n) / 2), n1 * n2 = n."""
    log_n = n.bit_length() - 1
    n1 = 1 << ((log_n + 1) // 2)
    return n1, n // n1


@lru_cache(maxsize=32)
def _twiddle_table(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """(n2, n1) uint64: w^(j2 * k1) for the size-n1*n2 root w (inverted
    for the inverse transform)."""
    n = n1 * n2
    root = gl.primitive_root_of_unity(n.bit_length() - 1)
    if inverse:
        root = pow(root, P - 2, P)
    pw = pntt._powers(root, n)
    e = (np.arange(n2, dtype=np.int64)[:, None]
         * np.arange(n1, dtype=np.int64)[None, :]) % n
    return pw[e]


@lru_cache(maxsize=32)
def _tables(mesh: Mesh, n1: int, n2: int, inverse: bool) -> List[torch.Tensor]:
    """The twiddle rows (n2/D, n1) of each shard's columns, on its device."""
    d = mesh.size
    if n1 % d or n2 % d:
        raise ValueError(f"a {n1} x {n2} four-step transform does not "
                         f"split over {d} shards")
    tw = torch.from_numpy(pntt._i64(_twiddle_table(n1, n2, inverse)))
    return [c.to(dev) for c, dev in zip(torch.chunk(tw, d, 0), mesh.devices)]


def _run(x: gl.Fp, mesh: Mesh, inverse: bool) -> gl.Fp:
    """(B, n) -> (B, n) transformed, natural order, on ``x``'s device."""
    b, n = x.shape
    n1, n2 = _split(n)
    tws = _tables(mesh, n1, n2, inverse)
    d = mesh.size
    c, r = n2 // d, n1 // d
    # shard s holds columns [s*c, (s+1)*c) of the (n1, n2) view, laid out
    # (B, c, n1) so that stage 1 transforms the last axis
    cols = x.reshape(b, n1, n2).transpose(1, 2)
    panels = [cols[:, s * c:(s + 1) * c].to(dev).contiguous()
              for s, dev in enumerate(mesh.devices)]
    # stage 1 and the twiddles: (B, c, n1)[j2, k1]
    panels = [gl.mul(pntt.ntt(p, inverse), tw) for p, tw in zip(panels, tws)]
    # the all-to-all: shard e takes the k1 block [e*r, (e+1)*r) of every
    # shard's columns -> (B, n2, r)[j2, k1], laid out (B, r, n2)
    blocks = []
    for e, dev in enumerate(mesh.devices):
        mine = torch.cat([p[:, :, e * r:(e + 1) * r].to(dev) for p in panels],
                         dim=1)
        blocks.append(mine.transpose(1, 2).contiguous())
    del panels
    # stage 2: (B, r, n2)[k1, k2]; out[k2 * n1 + k1]
    out = torch.empty((b, n2, n1), dtype=x.dtype, device=x.device)
    for e, blk in enumerate(blocks):
        out[:, :, e * r:(e + 1) * r] = pntt.ntt(blk, inverse).transpose(
            1, 2).to(x.device)
    return out.reshape(b, n)


def _batched(fn):
    """Run ``fn`` on a (B, n) batch; a 1-D input is a batch of one."""
    @wraps(fn)
    def wrapper(x: gl.Fp, *args, **kwargs) -> gl.Fp:
        if x.dim() == 1:
            return fn(x[None, :], *args, **kwargs)[0]
        return fn(x, *args, **kwargs)
    return wrapper


@_batched
def ntt_sharded(x: gl.Fp, mesh: Mesh, inverse: bool = False) -> gl.Fp:
    """Four-step forward (or inverse) NTT over ``mesh``; the last axis is
    the transform, (n,) or (B, n). Equal to ``poly/ntt.ntt``."""
    return _run(x, mesh, inverse)


@_batched
def coset_intt_sharded(evals: gl.Fp, shift: int, mesh: Mesh) -> gl.Fp:
    """``poly/ntt.coset_intt`` through the sharded transform: coefficients
    of the polynomial whose evaluations on shift*H are given."""
    return pntt._scale_by_powers(_run(evals, mesh, True),
                                 pow(shift % P, P - 2, P))


@_batched
def coeffs_to_coset_evals_sharded(coeffs: gl.Fp, rate_bits: int, mesh: Mesh,
                                  shift: int = SHIFT) -> gl.Fp:
    """``poly/ntt.coeffs_to_coset_evals`` through the sharded transform."""
    n = coeffs.shape[-1]
    padded = torch.nn.functional.pad(pntt._scale_by_powers(coeffs, shift),
                                     (0, (n << rate_bits) - n))
    return _run(padded, mesh, False)


@_batched
def coset_lde_sharded(evals: gl.Fp, rate_bits: int, mesh: Mesh,
                      shift: int = SHIFT) -> gl.Fp:
    """``poly/ntt.coset_lde`` (the prover's trace blowup) through two
    batched sharded transforms, a block of columns at a time."""
    b, n = evals.shape
    n_ext = n << rate_bits
    t = pntt.col_tile(b, n_ext, _FOUR_STEP_TEMPS, evals.device)

    def lde(block):
        return coeffs_to_coset_evals_sharded(
            _run(block, mesh, True), rate_bits, mesh, shift)

    if t >= b:
        return lde(evals)
    out = torch.empty((b, n_ext), dtype=evals.dtype, device=evals.device)
    for c0 in range(0, b, t):
        out[c0:c0 + t] = lde(evals[c0:c0 + t])
    return out


class ShardedNttOps:
    """The prover's NTT surface over a mesh. Plug it into
    ``prover.prove(..., ntt_ops=ops)``: the trace and aux blowups and the
    quotient's NTT tail (coset INTT, chunk coset re-evaluations, subgroup
    evaluations) then run the sharded transform, and the proof is the
    same bytes."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def coset_lde(self, evals: gl.Fp, rate_bits: int) -> gl.Fp:
        return coset_lde_sharded(evals, rate_bits, self.mesh)

    def coset_intt(self, evals: gl.Fp, shift: int) -> gl.Fp:
        return coset_intt_sharded(evals, shift, self.mesh)

    def coeffs_to_coset_evals(self, coeffs: gl.Fp, rate_bits: int,
                              shift: int = SHIFT) -> gl.Fp:
        return coeffs_to_coset_evals_sharded(coeffs, rate_bits, self.mesh,
                                             shift)

    def ntt(self, x: gl.Fp) -> gl.Fp:
        return ntt_sharded(x, self.mesh)
