"""Evaluation-domain utilities: subgroup/coset points, vanishing polys,
barycentric evaluation at an out-of-domain point."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import default_device
from ..field import goldilocks as gl
from ..field import ext

P = gl.MODULUS


@lru_cache(maxsize=None)
def _domain_points_np(log_n: int, shift: int) -> np.ndarray:
    root = gl.primitive_root_of_unity(log_n)
    out = np.empty(1 << log_n, dtype=np.uint64)
    acc = shift % P
    for j in range(1 << log_n):
        out[j] = acc
        acc = (acc * root) % P
    return out


def domain_points(log_n: int, shift: int = 1, device=None) -> gl.Fp:
    """(shift * w^j) for j in [0, 2^log_n), w the 2^log_n root of unity."""
    return torch.from_numpy(
        _domain_points_np(log_n, shift % P).view(np.int64)).to(
            default_device(device))


def barycentric_eval(evals: gl.Fp, zeta: ext.Fp2, log_n: int,
                     shift: int = 1) -> ext.Fp2:
    """Evaluate polys from their evals on shift*H (natural order) at a
    scalar Fp2 point: (..., N) -> (...,) Fp2 values via

        T(ζ) = (ζ^N - s^N) / (N * s^N) * Σ_j T(x_j) * x_j / (ζ - x_j)
    """
    n = 1 << log_n
    x = domain_points(log_n, shift, evals.device)           # (N,)
    inv_diff = ext.inv(ext.sub(zeta, ext.from_base(x)))      # (N,)
    w_re, w_im = ext.mul_base(inv_diff, x)                  # x_j / (ζ - x_j)
    s_re = gl.sum_mod(gl.mul(evals, w_re), axis=-1)
    s_im = gl.sum_mod(gl.mul(evals, w_im), axis=-1)
    zn = ext.pow_const(zeta, n)
    sn = pow(shift % P, n, P)
    pref = ext.mul_base(
        ext.sub(zn, ext.from_base(gl.full((), sn, evals.device))),
        gl.full((), pow(n * sn % P, P - 2, P), evals.device))
    return ext.mul(pref, (s_re, s_im))


def vanishing_on_coset(log_n: int, rate_bits: int,
                       shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR,
                       device=None) -> gl.Fp:
    """(x^N - 1) evaluated on the LDE coset shift*H_{N*2^rate}: (N_lde,).
    Periodic with period 2^rate_bits."""
    n = 1 << log_n
    # x^N = shift^N * omega^j where omega = W^N has order 2^rate_bits
    omega = pow(gl.primitive_root_of_unity(log_n + rate_bits), n, P)
    acc = pow(shift % P, n, P)
    vals = []
    for _ in range(1 << rate_bits):
        vals.append((acc - 1) % P)
        acc = (acc * omega) % P
    return gl.to_fp(vals, device).repeat(n)
