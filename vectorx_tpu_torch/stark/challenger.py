"""Fiat-Shamir transcript: a duplex Poseidon sponge.

Prover and verifier drive an identical sequence of observe/squeeze calls.
State: one width-12 Poseidon state on the device of the observed values.
Absorption is overwrite-mode in RATE (= 8) chunks; each squeeze reads up to
8 lanes, then permutes. Every observe and every squeeze is one call of
``hashes.poseidon.duplex``: one kernel launch on the card, the plain loop
of permutations on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import default_device
from ..field import goldilocks as gl
from ..field import ext
from ..hashes import poseidon as ps


@dataclass
class Challenger:
    state: gl.Fp      # (12,)
    pending: gl.Fp    # (k,) inputs not yet absorbed, k < RATE

    @staticmethod
    def new(device=None) -> "Challenger":
        device = default_device(device)
        return Challenger(state=gl.zeros((ps.WIDTH,), device),
                          pending=gl.zeros((0,), device))

    # -- observe ----------------------------------------------------------

    def observe(self, elems: gl.Fp) -> None:
        """Observe a flat (k,) vector of field elements. Full RATE-sized
        chunks absorb now (one chain); the remainder stays pending."""
        buf = torch.cat([self.pending, elems.reshape(-1)])
        nfull = buf.shape[0] // ps.RATE * ps.RATE
        if nfull:
            self.state, _ = ps.duplex(self.state, buf[:nfull])
        self.pending = buf[nfull:]

    def observe_digests(self, digests: gl.Fp) -> None:
        """Observe (n, 4) digests (e.g. a Merkle cap)."""
        self.observe(digests.reshape(-1))

    # -- squeeze ----------------------------------------------------------

    def squeeze(self, n: int) -> gl.Fp:
        """Draw n field-element challenges as a (n,) vector: absorb what
        is pending (overwriting only those lanes), then read up to RATE
        lanes per permutation."""
        self.state, out = ps.duplex(self.state, self.pending, flush=True,
                                    n_squeeze=n)
        self.pending = self.pending[:0]
        return out

    def _flush(self) -> None:
        self.squeeze(0)

    def squeeze_ext(self, n: int) -> ext.Fp2:
        base = self.squeeze(2 * n)
        return base[0::2], base[1::2]

    def squeeze_indices(self, n: int, domain_bits: int) -> torch.Tensor:
        """n query indices in [0, 2^domain_bits) from the low words."""
        return self.squeeze(n) & ((1 << domain_bits) - 1)
