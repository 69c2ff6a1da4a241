"""DEEP-ALI STARK verifier — mirrors prover.py's transcript exactly.

Checks:
  1. ALI at ζ: the AIR constraints evaluated at the opened values, combined
     with α-powers and divided by the vanishing polys, must equal the
     opened quotient Q(ζ) = Σ ζ^{iN}·chunk_i(ζ).
  2. Merkle membership of every opened trace/quotient/constant row at the
     FRI query positions (both halves of each FRI leaf pair).
  3. The FRI layer-0 codeword values equal the DEEP composition recomputed
     from the opened rows.
  4. The FRI fold/final-poly consistency (fri.verify).
"""

from __future__ import annotations

from typing import List

import torch

from ..field import goldilocks as gl
from ..field import ext
from ..poly import domain as pdom
from . import fri, merkle
from .air import Air, ExtAlgebra
from .challenger import Challenger
from .prover import (SHIFT, StarkConfig, StarkProof, _alpha_power_array,
                     _ext_col, _ext_row, _pick_ext, _slice_ext, _weighted_sum0,
                     constant_vk, num_quotient_chunks, require_no_aux)

P = gl.MODULUS


def _ali_check(air: Air, log_n: int, proof: StarkProof, publics, alpha,
               zeta, n_consts: int) -> torch.Tensor:
    """The AIR's constraints at ζ (ExtAlgebra) against the opened quotient."""
    dev = zeta[0].device
    n = 1 << log_n
    g_last = pow(gl.primitive_root_of_unity(log_n), n - 1, P)
    alg = ExtAlgebra(dev)
    local = [_pick_ext(proof.trace_zeta, c) for c in range(air.num_cols)]
    nxt = [_pick_ext(proof.trace_gzeta, c) for c in range(air.num_cols)]
    consts = [_pick_ext(proof.const_zeta, i) for i in range(n_consts)]
    consts_next = [_pick_ext(proof.const_gzeta, i) for i in range(n_consts)]
    ct = air.transition(alg, local, nxt, publics, consts, consts_next)
    cf = air.first_row(alg, local, publics, consts)
    cl = air.last_row(alg, local, publics, consts)

    def size(c):
        return c[0].numel()

    alphas = _alpha_power_array(alpha, sum(size(c) for c in ct + cf + cl))

    def comb(cs, k):
        acc = ext.zeros((), dev)
        for c in cs:
            m = size(c)
            term = ext.mul(_slice_ext(alphas, k, k + m),
                           (c[0].reshape(m), c[1].reshape(m)))
            acc = ext.add(acc, (gl.sum_mod(term[0], 0), gl.sum_mod(term[1], 0)))
            k += m
        return acc, k

    ct_c, k = comb(ct, 0)
    cf_c, k = comb(cf, k)
    cl_c, k = comb(cl, k)

    zeta_n = ext.pow_const(zeta, n)
    one = ext.ones((), dev)
    zeta_m_glast = ext.sub(zeta, ext.from_base(gl.full((), g_last, dev)))
    expected_q = ext.add(
        ext.add(ext.mul(ext.mul(ct_c, zeta_m_glast), ext.inv(ext.sub(zeta_n, one))),
                ext.mul(cf_c, ext.inv(ext.sub(zeta, one)))),
        ext.mul(cl_c, ext.inv(zeta_m_glast)))

    opened_q = ext.zeros((), dev)
    zpow = one
    for i in range(num_quotient_chunks(air)):
        opened_q = ext.add(opened_q, ext.mul(zpow, _pick_ext(proof.quotient_zeta, i)))
        zpow = ext.mul(zpow, zeta_n)
    return ext.eq(expected_q, opened_q)


def _deep_at(idx, trace_rows, quot_rows, const_rows, opens, betas, zeta,
             g_zeta, log_n_lde: int):
    """F(x) at the query points from the opened rows and ζ-openings."""
    tz, tgz, cz, cgz, qz = opens
    x = pdom.domain_points(log_n_lde, SHIFT, idx.device)[idx]      # (q,)
    xe = ext.from_base(x)
    inv_xz = ext.inv(ext.sub(xe, zeta))
    inv_xgz = ext.inv(ext.sub(xe, g_zeta))

    def block(F, rows, z_open, gz_open, k0):
        ncol = rows.shape[1]
        v = ext.from_base(rows.t())                               # (C, q)
        F = ext.add(F, _weighted_sum0(
            ext.mul(ext.sub(v, _ext_col(z_open)), _ext_row(inv_xz)),
            _slice_ext(betas, k0, k0 + ncol)))
        F = ext.add(F, _weighted_sum0(
            ext.mul(ext.sub(v, _ext_col(gz_open)), _ext_row(inv_xgz)),
            _slice_ext(betas, k0 + ncol, k0 + 2 * ncol)))
        return F, k0 + 2 * ncol

    F, kbase = block(ext.zeros(x.shape, x.device), trace_rows, tz, tgz, 0)
    if const_rows is not None:
        F, kbase = block(F, const_rows, cz, cgz, kbase)
    qv = (quot_rows[:, 0::2].t(), quot_rows[:, 1::2].t())
    diff_q = ext.sub(qv, _ext_col(qz))
    return ext.add(F, _weighted_sum0(ext.mul(diff_q, _ext_row(inv_xz)),
                                     _slice_ext(betas, kbase, betas[0].shape[0])))


def verify(air: Air, proof: StarkProof, publics: List[gl.Fp], log_n: int,
           config: StarkConfig, challenger: Challenger | None = None) -> bool:
    require_no_aux(air)
    dev = proof.trace_cap.device
    if challenger is None:
        challenger = Challenger.new(dev)
    num_cols = air.num_cols
    n = 1 << log_n
    log_n_lde = log_n + config.rate_bits
    n_lde = n << config.rate_bits
    g_dom = gl.primitive_root_of_unity(log_n)

    # -- preprocessed-constant VK: recomputed from the AIR itself, never read
    # from the proof ------------------------------------------------------
    vk = constant_vk(air, log_n, config, dev)
    has_consts = vk is not None
    n_consts = vk[1].shape[0] if has_consts else 0
    if has_consts != (proof.const_zeta is not None):
        return False

    # -- transcript replay -------------------------------------------------
    challenger.observe(torch.stack(publics))
    if has_consts:
        challenger.observe_digests(vk[0].cap)
    challenger.observe_digests(proof.trace_cap)
    alpha = _pick_ext(challenger.squeeze_ext(1), 0)
    challenger.observe_digests(proof.quotient_cap)
    zeta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 1: ALI consistency at ζ (needs no later challenge; each check below
    # returns as soon as it fails) -----------------------------------------
    if not bool(_ali_check(air, log_n, proof, publics, alpha, zeta, n_consts)):
        return False

    def obs_ext(v):
        challenger.observe(torch.cat([v[0].reshape(-1), v[1].reshape(-1)]))

    obs_ext(proof.trace_zeta)
    obs_ext(proof.trace_gzeta)
    if has_consts:
        obs_ext(proof.const_zeta)
        obs_ext(proof.const_gzeta)
    obs_ext(proof.quotient_zeta)
    beta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 4: FRI (also yields query indices + layer-0 values) ---------------
    fri_ok, indices, (a_vals, b_vals, _) = fri.verify(
        proof.fri_proof, log_n_lde, challenger, config.fri_config)
    if not bool(fri_ok):
        return False

    # -- 2: Merkle membership of openings ----------------------------------
    idx_a = indices
    idx_b = indices + n_lde // 2
    checks = [(proof.trace_cap, proof.trace_rows_a, proof.trace_paths_a,
               proof.trace_rows_b, proof.trace_paths_b),
              (proof.quotient_cap, proof.quot_rows_a, proof.quot_paths_a,
               proof.quot_rows_b, proof.quot_paths_b)]
    if has_consts:
        # membership against the verifier's OWN (recomputed) VK cap
        checks.append((vk[0].cap, proof.const_rows_a, proof.const_paths_a,
                       proof.const_rows_b, proof.const_paths_b))
    idx_ab = torch.cat([idx_a, idx_b])
    for cap, rows_a, paths_a, rows_b, paths_b in checks:
        # both halves of every FRI leaf pair in one batch per commitment
        if not bool(torch.all(merkle.verify_batch(
                cap, idx_ab, torch.cat([rows_a, rows_b]),
                torch.cat([paths_a, paths_b])))):
            return False

    # -- 3: DEEP composition recomputation at query points ------------------
    g_zeta = ext.mul_base(zeta, gl.full((), g_dom, dev))
    n_terms = (2 * num_cols + 2 * n_consts
               + num_quotient_chunks(air))
    betas = _alpha_power_array(beta, n_terms)
    opens = (proof.trace_zeta, proof.trace_gzeta, proof.const_zeta,
             proof.const_gzeta, proof.quotient_zeta)
    F_a = _deep_at(idx_a, proof.trace_rows_a, proof.quot_rows_a,
                   proof.const_rows_a, opens, betas, zeta, g_zeta, log_n_lde)
    F_b = _deep_at(idx_b, proof.trace_rows_b, proof.quot_rows_b,
                   proof.const_rows_b, opens, betas, zeta, g_zeta, log_n_lde)
    return bool(torch.all(ext.eq(F_a, a_vals)) & torch.all(ext.eq(F_b, b_vals)))
