"""DEEP-ALI STARK verifier — mirrors prover.py's transcript exactly.

Checks:
  1. ALI at ζ: the AIR constraints (and the LogUp/RAM ones, when the AIR
     has lookups or a RAM) evaluated at the opened values, combined with
     α-powers and divided by the vanishing polys, must equal the opened
     quotient Q(ζ) = Σ ζ^{iN}·chunk_i(ζ).
  2. Merkle membership of every opened trace/quotient/aux/constant row at
     the FRI query positions (both halves of each FRI leaf pair).
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
                     _ext_col, _ext_row, _ext_sum0, _lookup_constraint_evals,
                     _padded_lk, _pick_ext, _ram_constraint_evals,
                     _recombine_u, _slice_ext, _weighted_sum0, constant_vk,
                     num_quotient_chunks, total_aux_cols)

P = gl.MODULUS


def _aux_constraints_at_zeta(air: Air, proof: StarkProof, gamma, delta):
    """The LogUp constraints, then the RAM constraints, at ζ: (every,
    transition, first, last) lists. An aux element is stored as two base
    columns, so its value at ζ is re(ζ) + u·im(ζ)."""
    az, agz = proof.aux_zeta, proof.aux_gzeta
    lk_cols = air.lookup_range_columns()
    ram_spec = air.ram_multiset()
    lk_e, lk_t, lk_f, lk_l = [], [], [], []

    def elem(op, i):
        return _recombine_u(_pick_ext(op, i), _pick_ext(op, i + 1))

    base_r = 0
    if lk_cols:
        lk_p = _padded_lk(lk_cols)
        kk2 = len(lk_p) // 2
        base_r = 2 * kk2 + 6
        ci = torch.tensor(lk_p, device=az[0].device)
        w_all = proof.trace_zeta[0][ci], proof.trace_zeta[1][ci]
        lk_e, lk_t, lk_f, lk_l = _lookup_constraint_evals(
            gamma,
            _slice_ext(w_all, slice(0, None, 2)),
            _slice_ext(w_all, slice(1, None, 2)),
            _recombine_u(_slice_ext(az, slice(0, 2 * kk2, 2)),
                         _slice_ext(az, slice(1, 2 * kk2, 2))),
            elem(az, 2 * kk2), _pick_ext(az, 2 * kk2 + 2),
            elem(az, 2 * kk2 + 3), elem(agz, 2 * kk2 + 3),
            # the table ramp is an ordinary aux opening (committed column)
            _pick_ext(az, 2 * kk2 + 5), _pick_ext(agz, 2 * kk2 + 5))
    if ram_spec is not None:
        mult_c, ld_c, ad_c, act_c, val_col = ram_spec
        cz = proof.const_zeta
        r_e, r_t, r_f, r_l = _ram_constraint_evals(
            gamma, delta, _pick_ext(cz, ad_c), _pick_ext(cz, mult_c),
            _pick_ext(cz, ld_c), _pick_ext(cz, act_c),
            _pick_ext(proof.trace_zeta, val_col), elem(az, base_r),
            elem(az, base_r + 2), elem(agz, base_r + 2))
        lk_e, lk_t, lk_f, lk_l = lk_e + r_e, lk_t + r_t, lk_f + r_f, lk_l + r_l
    return lk_e, lk_t, lk_f, lk_l


def _ali_check(air: Air, log_n: int, proof: StarkProof, publics, alpha,
               zeta, n_consts: int, gamma=None, delta=None) -> torch.Tensor:
    """The AIR's constraints at ζ (ExtAlgebra), and the LogUp/RAM ones when
    the proof has an aux commitment, against the opened quotient."""
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
    if proof.aux_zeta is not None:
        lk_e, lk_t, lk_f, lk_l = _aux_constraints_at_zeta(air, proof, gamma,
                                                          delta)
    else:
        lk_e, lk_t, lk_f, lk_l = [], [], [], []

    def size(c):
        return c[0].numel()

    alphas = _alpha_power_array(
        alpha, sum(size(c) for c in ct + cf + cl + lk_t + lk_f + lk_l + lk_e))

    def comb(cs, k, acc):
        for c in cs:
            m = size(c)
            term = ext.mul(_slice_ext(alphas, k, k + m),
                           (c[0].reshape(m), c[1].reshape(m)))
            acc = ext.add(acc, _ext_sum0(term))
            k += m
        return acc, k

    zero = ext.zeros((), dev)
    ct_c, k = comb(ct, 0, zero)
    ct_c, k = comb(lk_t, k, ct_c)
    cf_c, k = comb(cf, k, zero)
    cf_c, k = comb(lk_f, k, cf_c)
    cl_c, k = comb(cl, k, zero)
    cl_c, k = comb(lk_l, k, cl_c)
    ce_c, k = comb(lk_e, k, zero)

    zeta_n = ext.pow_const(zeta, n)
    one = ext.ones((), dev)
    zeta_m_glast = ext.sub(zeta, ext.from_base(gl.full((), g_last, dev)))
    inv_zh = ext.inv(ext.sub(zeta_n, one))
    expected_q = ext.add(
        ext.add(ext.mul(ext.mul(ct_c, zeta_m_glast), inv_zh),
                ext.mul(cf_c, ext.inv(ext.sub(zeta, one)))),
        ext.add(ext.mul(cl_c, ext.inv(zeta_m_glast)),
                ext.mul(ce_c, inv_zh)))       # the every-row class

    opened_q = ext.zeros((), dev)
    zpow = one
    for i in range(num_quotient_chunks(air)):
        opened_q = ext.add(opened_q, ext.mul(zpow, _pick_ext(proof.quotient_zeta, i)))
        zpow = ext.mul(zpow, zeta_n)
    return ext.eq(expected_q, opened_q)


def _deep_at(idx, trace_rows, quot_rows, aux_rows, const_rows, opens, betas,
             zeta, g_zeta, log_n_lde: int):
    """F(x) at the query points from the opened rows and ζ-openings."""
    tz, tgz, az, agz, cz, cgz, qz = opens
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
    if aux_rows is not None:
        F, kbase = block(F, aux_rows, az, agz, kbase)
    if const_rows is not None:
        F, kbase = block(F, const_rows, cz, cgz, kbase)
    qv = (quot_rows[:, 0::2].t(), quot_rows[:, 1::2].t())
    diff_q = ext.sub(qv, _ext_col(qz))
    return ext.add(F, _weighted_sum0(ext.mul(diff_q, _ext_row(inv_xz)),
                                     _slice_ext(betas, kbase, betas[0].shape[0])))


def verify(air: Air, proof: StarkProof, publics: List[gl.Fp], log_n: int,
           config: StarkConfig, challenger: Challenger | None = None) -> bool:
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
    has_ram = air.ram_multiset() is not None
    n_aux = total_aux_cols(air)
    has_aux = n_aux > 0
    if (has_consts != (proof.const_zeta is not None)
            or has_aux != (proof.aux_cap is not None)):
        return False

    # -- transcript replay -------------------------------------------------
    challenger.observe(torch.stack(publics))
    if has_consts:
        challenger.observe_digests(vk[0].cap)
    challenger.observe_digests(proof.trace_cap)
    gamma = delta_r = None
    if has_aux:
        gamma = _pick_ext(challenger.squeeze_ext(1), 0)
        if has_ram:
            delta_r = _pick_ext(challenger.squeeze_ext(1), 0)
        challenger.observe_digests(proof.aux_cap)
    alpha = _pick_ext(challenger.squeeze_ext(1), 0)
    challenger.observe_digests(proof.quotient_cap)
    zeta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 1: ALI consistency at ζ (needs no later challenge; each check below
    # returns as soon as it fails) -----------------------------------------
    if not bool(_ali_check(air, log_n, proof, publics, alpha, zeta, n_consts,
                           gamma, delta_r)):
        return False

    def obs_ext(v):
        challenger.observe(torch.cat([v[0].reshape(-1), v[1].reshape(-1)]))

    obs_ext(proof.trace_zeta)
    obs_ext(proof.trace_gzeta)
    if has_aux:
        obs_ext(proof.aux_zeta)
        obs_ext(proof.aux_gzeta)
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
    if has_aux:
        checks.append((proof.aux_cap, proof.aux_rows_a, proof.aux_paths_a,
                       proof.aux_rows_b, proof.aux_paths_b))
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
    n_terms = (2 * num_cols + 2 * n_aux + 2 * n_consts
               + num_quotient_chunks(air))
    betas = _alpha_power_array(beta, n_terms)
    opens = (proof.trace_zeta, proof.trace_gzeta, proof.aux_zeta,
             proof.aux_gzeta, proof.const_zeta, proof.const_gzeta,
             proof.quotient_zeta)
    F_a = _deep_at(idx_a, proof.trace_rows_a, proof.quot_rows_a,
                   proof.aux_rows_a, proof.const_rows_a, opens, betas, zeta,
                   g_zeta, log_n_lde)
    F_b = _deep_at(idx_b, proof.trace_rows_b, proof.quot_rows_b,
                   proof.aux_rows_b, proof.const_rows_b, opens, betas, zeta,
                   g_zeta, log_n_lde)
    return bool(torch.all(ext.eq(F_a, a_vals)) & torch.all(ext.eq(F_b, b_vals)))
