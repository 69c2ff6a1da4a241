"""Fiat-Shamir transcript: a duplex Poseidon sponge.

Prover and verifier drive an identical sequence of observe/squeeze calls.
State: one width-12 Poseidon state on the device of the observed values.
Absorption is overwrite-mode in RATE (= 8) chunks; each squeeze reads up to
8 lanes, then permutes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import goldilocks as gl
from ..field import ext
from ..hashes import poseidon as ps


@dataclass
class Challenger:
    state: gl.Fp      # (12,)
    pending: gl.Fp    # (k,) inputs not yet absorbed, k < RATE

    @staticmethod
    def new(device=None) -> "Challenger":
        return Challenger(state=gl.zeros((ps.WIDTH,), device),
                          pending=gl.zeros((0,), device))

    # -- observe ----------------------------------------------------------

    def observe(self, elems: gl.Fp) -> None:
        """Observe a flat (k,) vector of field elements. Full RATE-sized
        chunks absorb now; the remainder stays pending."""
        buf = torch.cat([self.pending, elems.reshape(-1)])
        nfull = buf.shape[0] // ps.RATE
        for c in range(nfull):
            self.state = ps.permute(torch.cat(
                [buf[c * ps.RATE:(c + 1) * ps.RATE], self.state[ps.RATE:]]))
        self.pending = buf[nfull * ps.RATE:]

    def observe_digests(self, digests: gl.Fp) -> None:
        """Observe (n, 4) digests (e.g. a Merkle cap)."""
        self.observe(digests.reshape(-1))

    def _absorb(self) -> None:
        n = self.pending.shape[0]
        self.state = ps.permute(torch.cat([self.pending, self.state[n:]]))
        self.pending = self.pending[:0]

    # -- squeeze ----------------------------------------------------------

    def _flush(self) -> None:
        if self.pending.shape[0]:
            self._absorb()

    def squeeze(self, n: int) -> gl.Fp:
        """Draw n field-element challenges as a (n,) vector."""
        self._flush()
        outs = []
        remaining = n
        while remaining > 0:
            take = min(remaining, ps.RATE)
            outs.append(self.state[:take])
            self.state = ps.permute(self.state)
            remaining -= take
        return torch.cat(outs)

    def squeeze_ext(self, n: int) -> ext.Fp2:
        base = self.squeeze(2 * n)
        return base[0::2], base[1::2]

    def squeeze_indices(self, n: int, domain_bits: int) -> torch.Tensor:
        """n query indices in [0, 2^domain_bits) from the low words."""
        return self.squeeze(n) & ((1 << domain_bits) - 1)
