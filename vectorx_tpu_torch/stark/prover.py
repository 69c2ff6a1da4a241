"""DEEP-ALI STARK prover — trace commit → quotient → DEEP → FRI.

  1. trace LDE         — batched coset NTT over all columns
  2. trace commit      — batched Poseidon Merkle (rows of the LDE matrix)
  3. constraint eval   — AIR constraints evaluated on the whole LDE domain
                         at once (BaseVecAlgebra), combined with α-powers
  4. quotient          — divide by vanishing polys, split into degree-N
                         chunks, commit
  5. DEEP composition  — open trace/constants/quotient at ζ (barycentric),
                         batch the deviation quotients with β-powers into
                         one GF(p^2) codeword
  6. FRI               — low-degree proof of the composition codeword
  7. query openings    — committed rows + Merkle paths at FRI indices

Transcript order (verifier.py mirrors it exactly): publics | [VK cap if the
AIR has constant columns] | trace cap | α | quotient cap | ζ | openings
(trace ζ, trace gζ, [const ζ, const gζ], quotient ζ) | β | FRI.

AIRs with LogUp lookups or the RAM multiset are not supported by this port
yet: ``prove`` raises NotImplementedError for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np
import torch

from .. import default_device
from ..field import goldilocks as gl
from ..field import ext
from ..poly import domain as pdom
from ..poly import ntt as pntt
from . import fri, merkle
from .air import Air, BaseVecAlgebra
from .challenger import Challenger

P = gl.MODULUS
SHIFT = gl.MULTIPLICATIVE_GROUP_GENERATOR


@dataclass(frozen=True)
class StarkConfig:
    rate_bits: int = 3
    num_queries: int = 28
    final_poly_len: int = 8
    cap_height: int = 0
    # FRI grinding bits: conjectured security ≈ rate_bits·num_queries +
    # pow_bits. Production configs use PRODUCTION_POW_BITS.
    pow_bits: int = 0

    @property
    def fri_config(self) -> fri.FriConfig:
        return fri.FriConfig(rate_bits=self.rate_bits, num_queries=self.num_queries,
                             final_poly_len=self.final_poly_len, cap_height=self.cap_height,
                             pow_bits=self.pow_bits)


#: plonky2's standard_recursion_config grinds 16 bits; same margin here.
PRODUCTION_POW_BITS = 16


@dataclass
class StarkProof:
    """Field order is the JAX package's (its pytree flatten order)."""
    trace_cap: gl.Fp
    quotient_cap: gl.Fp
    trace_zeta: ext.Fp2        # (num_cols,)
    trace_gzeta: ext.Fp2       # (num_cols,)
    quotient_zeta: ext.Fp2     # (num_chunks,)
    fri_proof: fri.FriProof
    # openings at FRI query positions (a: idx, b: idx + N_lde/2)
    trace_rows_a: gl.Fp        # (q, num_cols)
    trace_rows_b: gl.Fp
    trace_paths_a: gl.Fp       # (q, depth, 4)
    trace_paths_b: gl.Fp
    quot_rows_a: gl.Fp         # (q, 2*num_chunks)
    quot_rows_b: gl.Fp
    quot_paths_a: gl.Fp
    quot_paths_b: gl.Fp
    # LogUp/RAM aux commitment: always None in this port
    aux_cap: gl.Fp | None = None
    aux_zeta: ext.Fp2 | None = None
    aux_gzeta: ext.Fp2 | None = None
    aux_rows_a: gl.Fp | None = None
    aux_rows_b: gl.Fp | None = None
    aux_paths_a: gl.Fp | None = None
    aux_paths_b: gl.Fp | None = None
    # preprocessed-constant openings (present iff air.constant_columns is
    # non-empty); the verifier recomputes the VK cap from the AIR itself
    const_zeta: ext.Fp2 | None = None   # (num_consts,)
    const_gzeta: ext.Fp2 | None = None
    const_rows_a: gl.Fp | None = None
    const_rows_b: gl.Fp | None = None
    const_paths_a: gl.Fp | None = None
    const_paths_b: gl.Fp | None = None


def require_no_aux(air: Air) -> None:
    if air.lookup_range_columns() or air.ram_multiset() is not None:
        raise NotImplementedError(
            f"{type(air).__name__}: LogUp lookups and the RAM multiset are "
            "not ported yet")


# -- Fp2 vector helpers ---------------------------------------------------------

def _alpha_power_array(alpha: ext.Fp2, n: int) -> ext.Fp2:
    """[1, α, α², ...] (n terms) — doubling: block [k, 2k) = block [0, k)·α^k."""
    dev = alpha[0].device
    re, im = gl.ones((1,), dev), gl.zeros((1,), dev)
    step = alpha
    while re.shape[0] < n:
        nr, ni = ext.mul((re, im), step)
        re, im = torch.cat([re, nr]), torch.cat([im, ni])
        step = ext.square(step)
    return re[:n], im[:n]


def _slice_ext(v: ext.Fp2, a: int, b: int) -> ext.Fp2:
    return v[0][a:b], v[1][a:b]


def _pick_ext(v: ext.Fp2, i: int) -> ext.Fp2:
    return v[0][i], v[1][i]


def _ext_col(v: ext.Fp2) -> ext.Fp2:
    """(m,) Fp2 -> (m, 1) Fp2 for broadcasting against (m, N)."""
    return v[0][:, None], v[1][:, None]


def _ext_row(v: ext.Fp2) -> ext.Fp2:
    """(N,) Fp2 -> (1, N) Fp2."""
    return v[0][None, :], v[1][None, :]


def _ext_sum0(v: ext.Fp2) -> ext.Fp2:
    return gl.sum_mod(v[0], axis=0), gl.sum_mod(v[1], axis=0)


def _weighted_sum0(terms: ext.Fp2, w: ext.Fp2) -> ext.Fp2:
    """Σ_i w_i * terms_i over axis 0: terms (m, N), w (m,) -> (N,)."""
    return _ext_sum0(ext.mul(_ext_col(w), terms))


def _stack_ext(vs) -> ext.Fp2:
    return torch.stack([v[0] for v in vs]), torch.stack([v[1] for v in vs])


def num_quotient_chunks(air: Air) -> int:
    return max(air.max_constraint_degree - 1, 1)


def constant_vk(air: Air, log_n: int, config: StarkConfig, device=None):
    """The preprocessed-constant commitment (verifying key) for one
    AIR/shape/device — or None if the AIR has no constant columns.

    Returns (tree, cfp, c_lde): the Poseidon Merkle tree over the constant
    columns' coset LDE, their subgroup evals and the LDE. Cached on the air
    object, keyed by device as well as shape."""
    device = default_device(device)
    cache = air.__dict__.setdefault("_vx_vk", {})
    key = (log_n, config.rate_bits, config.cap_height, str(device))
    if key not in cache:
        cvals = np.asarray(air.constant_columns(1 << log_n), dtype=np.object_)
        if cvals.shape[0] == 0:
            cache[key] = None
        else:
            cfp = gl.to_fp(cvals, device)
            c_lde = pntt.coset_lde(cfp, config.rate_bits)
            tree = merkle.build_cols(c_lde, cap_height=config.cap_height)
            cache[key] = (tree, cfp, c_lde)
    return cache[key]


# -- quotient phase ----------------------------------------------------------------

@lru_cache(maxsize=16)
def _domain_arrays(log_n: int, rate: int, device: torch.device):
    """(x − g_last, 1/Z_H, 1/(x − 1), 1/(x − g_last)) on the LDE coset."""
    n = 1 << log_n
    n_lde = n << rate
    g_last = pow(gl.primitive_root_of_unity(log_n), n - 1, P)
    x = pdom.domain_points(log_n + rate, SHIFT, device)
    # Z_H repeats with period 2^rate: invert one period
    inv_zh = gl.inv(pdom.vanishing_on_coset(log_n, rate, SHIFT, device)[:1 << rate])
    xmg = gl.sub(x, gl.full((), g_last, device))
    return (xmg, inv_zh.repeat(n_lde >> rate),
            gl.inv(gl.sub(x, gl.ones((), device))), gl.inv(xmg))


def _combine(constraints, alphas_all: ext.Fp2, k0: int, acc: ext.Fp2, n_lde: int):
    """α-combine base-ring constraints; grouped leading axes count as
    independent constraints, each with its own α."""
    k = k0
    for c in constraints:
        m = int(np.prod(c.shape[:-1])) if c.dim() > 1 else 1
        cf = c.reshape(m, n_lde)
        a_re, a_im = _ext_col(_slice_ext(alphas_all, k, k + m))
        acc = ext.add(acc, (gl.sum_mod(gl.mul(a_re, cf), axis=0),
                            gl.sum_mod(gl.mul(a_im, cf), axis=0)))
        k += m
    return acc, k


def quotient_tail(quotient: ext.Fp2, n: int, n_chunks: int, rate: int,
                  shift: int):
    """Quotient codeword -> (quot_cols, chunk_evals_lde, chunk_evals_sub):
    coset INTT, degree-N chunk split, per-chunk coset/subgroup re-evals."""
    q_re = pntt.coset_intt(quotient[0], shift)
    q_im = pntt.coset_intt(quotient[1], shift)
    chunk_evals_lde, chunk_evals_sub = [], []
    for i in range(n_chunks):
        cre = q_re[i * n:(i + 1) * n]
        cim = q_im[i * n:(i + 1) * n]
        chunk_evals_lde.append((pntt.coeffs_to_coset_evals(cre, rate, shift),
                                pntt.coeffs_to_coset_evals(cim, rate, shift)))
        chunk_evals_sub.append((pntt.ntt(cre), pntt.ntt(cim)))
    quot_cols = torch.stack([c[j] for c in chunk_evals_lde for j in (0, 1)])
    return quot_cols, chunk_evals_lde, chunk_evals_sub


def quotient_phase(air: Air, log_n: int, rate: int, trace_lde: gl.Fp,
                   c_lde, publics: List[gl.Fp], alpha: ext.Fp2):
    """Constraint evaluation over the LDE domain, α-combination, vanishing
    division, chunk split and re-evaluation."""
    n = 1 << log_n
    n_lde = n << rate
    blowup = 1 << rate
    dev = trace_lde.device
    alg = BaseVecAlgebra((n_lde,), dev)
    local = list(trace_lde)
    nxt = list(torch.roll(trace_lde, -blowup, dims=1))
    if c_lde is not None:
        consts = list(c_lde)
        consts_next = list(torch.roll(c_lde, -blowup, dims=1))
    else:
        consts, consts_next = [], []
    ct = air.transition(alg, local, nxt, publics, consts, consts_next)
    cf = air.first_row(alg, local, publics, consts)
    cl = air.last_row(alg, local, publics, consts)

    n_constraints = sum(int(np.prod(c.shape[:-1])) if c.dim() > 1 else 1
                        for c in ct + cf + cl)
    alphas = _alpha_power_array(alpha, n_constraints)
    k = 0
    ct_comb, k = _combine(ct, alphas, k, ext.zeros((n_lde,), dev), n_lde)
    cf_comb, k = _combine(cf, alphas, k, ext.zeros((n_lde,), dev), n_lde)
    cl_comb, k = _combine(cl, alphas, k, ext.zeros((n_lde,), dev), n_lde)

    # quotient: divide by the per-class vanishing polynomials
    xmg, inv_zh, inv_x_minus_1, inv_x_minus_glast = _domain_arrays(
        log_n, rate, dev)
    q_t = ext.mul_base(ext.mul_base(ct_comb, xmg), inv_zh)
    q_f = ext.mul_base(cf_comb, inv_x_minus_1)
    q_l = ext.mul_base(cl_comb, inv_x_minus_glast)
    quotient = ext.add(ext.add(q_t, q_f), q_l)
    return quotient_tail(quotient, n, num_quotient_chunks(air), rate, SHIFT)


# -- prove -----------------------------------------------------------------------------

def prove(air: Air, trace: gl.Fp, publics: List[gl.Fp], config: StarkConfig,
          challenger: Challenger | None = None, timer=None) -> StarkProof:
    """trace: (num_cols, N) base field; publics: list of scalar Fp, on the
    trace's device. ``timer(phase)``, if given, is called as each phase
    ends (phase names: lde, commit, quotient, openings, deep, fri,
    queries)."""
    require_no_aux(air)
    mark = timer or (lambda phase: None)
    dev = trace.device
    if challenger is None:
        challenger = Challenger.new(dev)
    num_cols, n = trace.shape
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"trace length must be a power of two, got {n}")
    rate = config.rate_bits
    n_lde = n << rate
    g_dom = gl.primitive_root_of_unity(log_n)       # trace-domain generator

    # -- 0: preprocessed-constant VK (cached per air/shape/device) ---------
    vk = constant_vk(air, log_n, config, dev)
    has_consts = vk is not None
    if has_consts:
        vk_tree, cfp, c_lde = vk
        n_consts = cfp.shape[0]
    else:
        vk_tree = cfp = c_lde = None
        n_consts = 0

    # -- 1/2: trace LDE + commitment --------------------------------------
    trace_lde = pntt.coset_lde(trace, rate)            # (num_cols, N_lde)
    mark("lde")
    trace_tree = merkle.build_cols(trace_lde, cap_height=config.cap_height)
    challenger.observe(torch.stack(publics))
    if has_consts:
        challenger.observe_digests(vk_tree.cap)
    challenger.observe_digests(trace_tree.cap)
    mark("commit")

    alpha = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 3/4: constraints + quotient ---------------------------------------
    quot_cols, chunk_evals_lde, chunk_evals_sub = quotient_phase(
        air, log_n, rate, trace_lde, c_lde, publics, alpha)
    n_chunks = num_quotient_chunks(air)
    quot_tree = merkle.build_cols(quot_cols, cap_height=config.cap_height)
    challenger.observe_digests(quot_tree.cap)
    mark("quotient")

    zeta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 5: openings at ζ and g·ζ: one batched barycentric evaluation for
    # the trace, constant and quotient-chunk components ---------------------
    g_zeta = ext.mul_base(zeta, gl.full((), g_dom, dev))
    const_part = [cfp] if has_consts else []
    chunk_sub = [c[j][None, :] for c in chunk_evals_sub for j in (0, 1)]
    opened = pdom.barycentric_eval(torch.cat([trace] + const_part + chunk_sub),
                                   zeta, log_n)
    trace_zeta = _slice_ext(opened, 0, num_cols)
    const_zeta = (_slice_ext(opened, num_cols, num_cols + n_consts)
                  if has_consts else None)
    opened_g = pdom.barycentric_eval(torch.cat([trace] + const_part),
                                     g_zeta, log_n)
    trace_gzeta = _slice_ext(opened_g, 0, num_cols)
    const_gzeta = (_slice_ext(opened_g, num_cols, num_cols + n_consts)
                   if has_consts else None)

    # recombine chunk components: value = re_v + u*im_v, u^2 = W
    qv = []
    for i in range(n_chunks):
        a, b = _pick_ext(opened, num_cols + n_consts + 2 * i)
        c, d = _pick_ext(opened, num_cols + n_consts + 2 * i + 1)
        qv.append((gl.add(a, gl.mul_scalar(d, ext.W)), gl.add(b, c)))
    quotient_zeta = _stack_ext(qv)

    def obs_ext(v: ext.Fp2):
        challenger.observe(torch.cat([v[0].reshape(-1), v[1].reshape(-1)]))

    obs_ext(trace_zeta)
    obs_ext(trace_gzeta)
    if has_consts:
        obs_ext(const_zeta)
        obs_ext(const_gzeta)
    obs_ext(quotient_zeta)
    mark("openings")

    beta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- DEEP composition codeword -------------------------------------------
    ch_stack = _stack_ext(chunk_evals_lde)
    F = _deep_phase_raw(log_n, rate, trace_lde, c_lde, ch_stack,
                        trace_zeta, trace_gzeta, const_zeta, const_gzeta,
                        quotient_zeta, zeta, g_zeta, beta)
    mark("deep")

    # -- 6: FRI ------------------------------------------------------------
    fri_proof, indices = fri.prove(F, challenger, config.fri_config)
    mark("fri")

    # -- 7: openings at query indices ---------------------------------------
    idx_a = indices
    idx_b = indices + n_lde // 2
    (tra, tpa), (trb, tpb), (qra, qpa), (qrb, qpb), const_opens = \
        _open_queries_raw(trace_tree, trace_lde, quot_tree, quot_cols,
                          vk_tree, c_lde, idx_a, idx_b)
    if has_consts:
        (cra, cpa), (crb, cpb) = const_opens
    else:
        cra = crb = cpa = cpb = None
    mark("queries")

    return StarkProof(
        trace_cap=trace_tree.cap, quotient_cap=quot_tree.cap,
        trace_zeta=trace_zeta, trace_gzeta=trace_gzeta,
        quotient_zeta=quotient_zeta, fri_proof=fri_proof,
        trace_rows_a=tra, trace_rows_b=trb,
        trace_paths_a=tpa, trace_paths_b=tpb,
        quot_rows_a=qra, quot_rows_b=qrb,
        quot_paths_a=qpa, quot_paths_b=qpb,
        const_zeta=const_zeta, const_gzeta=const_gzeta,
        const_rows_a=cra, const_rows_b=crb,
        const_paths_a=cpa, const_paths_b=cpb,
    )


def _deep_phase_raw(log_n, rate, trace_lde, const_lde, ch_stack,
                    trace_zeta, trace_gzeta, const_zeta, const_gzeta,
                    quotient_zeta, zeta, g_zeta, beta):
    """DEEP composition: β-batched deviation quotients of every opening
    group into one GF(p^2) codeword. β-power term order (mirrored by the
    verifier): trace ζ | trace gζ | const ζ | const gζ | quotient."""
    n_lde = 1 << (log_n + rate)
    dev = trace_lde.device
    num_cols = trace_lde.shape[0]
    n_consts = const_lde.shape[0] if const_lde is not None else 0
    n_chunks = ch_stack[0].shape[0]

    xe = ext.from_base(pdom.domain_points(log_n + rate, SHIFT, dev))
    inv_xz = ext.inv(ext.sub(xe, zeta))
    inv_xgz = ext.inv(ext.sub(xe, g_zeta))

    n_terms = 2 * num_cols + 2 * n_consts + n_chunks
    betas = _alpha_power_array(beta, n_terms)

    def block(F, lde, z_open, gz_open, k0, ncol):
        fp2 = ext.from_base(lde)
        dz = ext.sub(fp2, _ext_col(z_open))
        F = ext.add(F, _weighted_sum0(ext.mul(dz, _ext_row(inv_xz)),
                                      _slice_ext(betas, k0, k0 + ncol)))
        dgz = ext.sub(fp2, _ext_col(gz_open))
        return ext.add(F, _weighted_sum0(
            ext.mul(dgz, _ext_row(inv_xgz)),
            _slice_ext(betas, k0 + ncol, k0 + 2 * ncol)))

    F = block(ext.zeros((n_lde,), dev), trace_lde, trace_zeta, trace_gzeta,
              0, num_cols)
    kbase = 2 * num_cols
    if const_lde is not None:
        F = block(F, const_lde, const_zeta, const_gzeta, kbase, n_consts)
        kbase += 2 * n_consts
    diff_q = ext.sub(ch_stack, _ext_col(quotient_zeta))
    return ext.add(F, _weighted_sum0(ext.mul(diff_q, _ext_row(inv_xz)),
                                     _slice_ext(betas, kbase, n_terms)))


def _open_queries_raw(trace_tree, trace_cols, quot_tree, quot_cols,
                      vk_tree, vk_cols, idx_a, idx_b):
    """Open every committed tree at both query-index halves. Committed
    matrices are column-major (w, n_lde): query rows are gathered."""
    def open_rows(tree, cols, idx):
        return cols[:, idx].t().contiguous(), merkle.prove(tree, idx)

    out = (open_rows(trace_tree, trace_cols, idx_a),
           open_rows(trace_tree, trace_cols, idx_b),
           open_rows(quot_tree, quot_cols, idx_a),
           open_rows(quot_tree, quot_cols, idx_b))
    consts = None
    if vk_tree is not None:
        consts = (open_rows(vk_tree, vk_cols, idx_a),
                  open_rows(vk_tree, vk_cols, idx_b))
    return out + (consts,)
