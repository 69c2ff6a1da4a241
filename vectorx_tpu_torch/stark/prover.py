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
AIR has constant columns] | trace cap | [γ, then δ if the AIR has a RAM |
aux cap, if the AIR has lookups or a RAM] | α | quotient cap | ζ | openings
(trace ζ, trace gζ, [aux ζ, aux gζ], [const ζ, const gζ], quotient ζ) | β |
FRI.
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
from .air import Air, BaseVecAlgebra, const_values
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
    # LogUp/RAM aux commitment (present iff the AIR has range lookups or a
    # RAM multiset); base columns [inv_k(re,im)]*K | inv_t(re,im) | m |
    # S(re,im) | t, then the RAM block inv(re,im) | S(re,im)
    aux_cap: gl.Fp | None = None
    aux_zeta: ext.Fp2 | None = None     # (num_aux,)
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


# -- working-set bounds ----------------------------------------------------------
# The large phases (LDE, quotient, ζ openings, DEEP) work on tiles whose size
# follows from the shapes and the device's free memory: a row window of the
# LDE domain for the quotient, a block of columns for the others. Field sums
# are exact, so every tiling gives the same bytes as one whole pass.

#: int64 temporaries per element a tiled phase holds at its peak: estimates
#: from the torch Goldilocks ops (a product builds ~8); the LDE's is
#: ``poly/ntt.LDE_TEMPS``
_OPEN_TEMPS = 12
_DEEP_TEMPS = 32
#: the column tile of a phase (``poly/ntt.col_tile``; tests patch it here)
_col_tile = pntt.col_tile


def _row_window(n_lde: int, width: int, kk2: int,
                device: torch.device) -> int:
    """LDE rows per window of the quotient's constraint evaluation: a power
    of two dividing n_lde. A row holds the window of every committed column
    (trace, constants, aux), the AIR's constraint values and temporaries
    (~8 per column), and ~64 extension temporaries per LogUp column pair."""
    per_row = 8 * (8 * width + 64 * kk2 + 4096)
    rows = max(1, pntt.work_bytes(device) // per_row)
    b = 1 << min(n_lde.bit_length() - 1, rows.bit_length() - 1)
    return max(b, min(n_lde, 1024))


def lde_cols(cols: gl.Fp, rate: int) -> gl.Fp:
    """``ntt.coset_lde`` of a (w, n) matrix, a block of columns at a time
    (the NTT's temporaries are several times its output)."""
    w, n = cols.shape
    n_lde = n << rate
    t = _col_tile(w, n_lde, pntt.LDE_TEMPS, cols.device)
    if t >= w:
        return pntt.coset_lde(cols, rate)
    out = torch.empty((w, n_lde), dtype=cols.dtype, device=cols.device)
    for c0 in range(0, w, t):
        out[c0:c0 + t] = pntt.coset_lde(cols[c0:c0 + t], rate)
    return out


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


def _slice_ext(v: ext.Fp2, a, b: int | None = None) -> ext.Fp2:
    """v[a:b] along axis 0, or v[a] for a slice object ``a``."""
    sl = a if isinstance(a, slice) else slice(a, b)
    return v[0][sl], v[1][sl]


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
        cvals = const_values(air.constant_columns(1 << log_n))
        if cvals.shape[0] == 0:
            cache[key] = None
        else:
            cfp = gl.to_fp(cvals, device)
            c_lde = lde_cols(cfp, config.rate_bits)
            tree = merkle.build_cols(c_lde, cap_height=config.cap_height)
            cache[key] = (tree, cfp, c_lde)
    return cache[key]


# -- LogUp range-check lookup (air.lookup_range_columns) and RAM multiset ----------
# Identity proven:  Σ_r Σ_k 1/(γ - w_k(r)) == Σ_r m(r)/(γ - r)
# i.e. every looked-up value lies in the row ramp [0, n_rows). Looked
# columns are PAIRED: one witnessed inverse serves two columns via
#   (γ - w0)(γ - w1)·inv = 1        (degree 3 — exactly the AIR budget)
#   pair contribution = inv·(2γ - w0 - w1) = 1/(γ-w0) + 1/(γ-w1)
# Odd column counts are padded by repeating the last column (its
# multiplicity simply counts twice). Aux base columns:
# [inv_k.re, inv_k.im]*ceil(K/2) | inv_t.re, inv_t.im | m | S.re, S.im | t
# where S is the exclusive running sum and t the table ramp itself,
# committed so that t(ζ) is an ordinary opening (pinned by t(0)=0, t'=t+1).

def num_aux_cols(n_lookups: int, has_ram: bool = False) -> int:
    lk = (2 * ((n_lookups + 1) // 2) + 6) if n_lookups else 0
    return lk + (4 if has_ram else 0)


def total_aux_cols(air: Air) -> int:
    return num_aux_cols(len(air.lookup_range_columns()),
                        air.ram_multiset() is not None)


def _ram_constraint_evals(gamma_r, delta_r, addr_x, mult_x, ld_x, act_x,
                          val_x, inv_v, s_val, s_next):
    """Pair-multiset RAM constraints in any ext ring (air.ram_multiset).
    fp = γ − addr − δ·val; fp·inv == active (forces inv = 0 on inactive
    rows); S' = S + (mult − load)·inv with S(0) = 0 and S wrapping to 0:
        Σ_stores mult/fp == Σ_loads 1/fp
    — every load replays some store's (addr, value). All terms degree ≤ 2.
    Returns (every, transition, first, last) constraint lists — appended
    AFTER the LogUp lists in the prover's quotient and the verifier's ALI."""
    fp = ext.sub(gamma_r, ext.add(addr_x, ext.mul(delta_r, val_x)))
    def_i = ext.sub(ext.mul(fp, inv_v), act_x)
    contrib = ext.mul(ext.sub(mult_x, ld_x), inv_v)
    return ([def_i], [ext.sub(ext.sub(s_next, s_val), contrib)], [s_val],
            [ext.add(s_val, contrib)])


def _padded_lk(lk_cols):
    lk = list(lk_cols)
    if len(lk) % 2:
        lk.append(lk[-1])
    return lk


def _ramp_fp(n: int, device) -> gl.Fp:
    return torch.arange(n, dtype=torch.int64, device=device)


def _recombine_u(re_v: ext.Fp2, im_v: ext.Fp2) -> ext.Fp2:
    """Value of an ext element stored as two base columns: re + u*im."""
    a, b = re_v
    c, d = im_v
    return gl.add(a, gl.mul_scalar(d, ext.W)), gl.add(b, c)


def _lookup_constraint_evals(gamma, w0_g, w1_g, inv_g, inv_t, m_val,
                             s_val, s_next, t_val, t_next):
    """The LogUp constraints in any ext ring (vectors at prove time,
    scalars at ζ for the verifier). ``w0_g``/``w1_g``/``inv_g`` are GROUPED
    ext elements with the ceil(K/2) column PAIRS stacked on a leading axis.
    Returns (every, transition, first, last) lists of (possibly grouped)
    constraints; the degree-3 inverse definitions hold on EVERY row
    (divisor x^N − 1)."""
    one = ext.ones((), gamma[0].device)
    d0 = ext.sub(gamma, w0_g)
    d1 = ext.sub(gamma, w1_g)
    defs_g = ext.sub(ext.mul(ext.mul(d0, d1), inv_g), one)
    def_t = ext.sub(ext.mul(ext.sub(gamma, t_val), inv_t), one)
    contrib = _ext_sum0(ext.mul(inv_g, ext.add(d0, d1)))    # Σ inv·(2γ-w0-w1)
    contrib = ext.sub(contrib, ext.mul(m_val, inv_t))
    le = [defs_g, def_t]
    lt = [ext.sub(ext.sub(s_next, s_val), contrib),
          ext.sub(ext.sub(t_next, t_val), one)]     # ramp step t' = t + 1
    lf = [s_val, t_val]                             # S(0) = 0, t(0) = 0
    ll = [ext.add(s_val, contrib)]
    return le, lt, lf, ll


def _num_lookup_constraints(n_lookups: int):
    """(transition, first, last) counts (pairs + table def + sum step)."""
    kk2 = (n_lookups + 1) // 2
    return kk2 + 3, 2, kk2 + 2


def _exscan(v: ext.Fp2) -> ext.Fp2:
    return gl.prefix_sum_mod(v[0]), gl.prefix_sum_mod(v[1])


def _build_aux_trace(trace: gl.Fp, lk_cols, gamma: ext.Fp2, n: int) -> gl.Fp:
    """-> (num_aux, n) base-column aux trace (one batched inverse pass over
    the column-pair denominators plus the table denominator)."""
    lk = _padded_lk(lk_cols)
    kk2 = len(lk) // 2
    dev = trace.device
    t_ramp = _ramp_fp(n, dev)
    looked = trace[torch.tensor(lk, device=dev)]               # (2·kk2, n)
    d = ext.sub(gamma, ext.from_base(looked))
    d0 = _slice_ext(d, slice(0, None, 2))
    d1 = _slice_ext(d, slice(1, None, 2))
    denom_p = ext.mul(d0, d1)                                  # (kk2, n)
    denom_t = ext.sub(gamma, ext.from_base(t_ramp[None, :]))
    inv_all = ext.inv((torch.cat([denom_p[0], denom_t[0]]),
                       torch.cat([denom_p[1], denom_t[1]])))
    inv_p = _slice_ext(inv_all, slice(0, kk2))
    inv_t = _pick_ext(inv_all, kk2)

    # multiplicities: a cell outside [0, n) is counted nowhere (its proof
    # cannot verify); canonical values >= 2^63 read as negative
    in_range = (looked >= 0) & (looked < n)
    idx = torch.where(in_range, looked, torch.zeros_like(looked))
    m_fp = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(
        0, idx.reshape(-1), in_range.reshape(-1).to(torch.int64))

    contrib = _ext_sum0(ext.mul(inv_p, ext.add(d0, d1)))
    contrib = ext.sub(contrib, ext.mul_base(inv_t, m_fp))
    s_re, s_im = _exscan(contrib)

    # interleave re/im base columns: inv pairs | inv_t | m | S | t
    inter = torch.stack([inv_all[0], inv_all[1]], dim=1).reshape(-1, n)
    return torch.cat([inter, torch.stack([m_fp, s_re, s_im, t_ramp])])


def _build_ram_aux(air: Air, trace: gl.Fp, gamma: ext.Fp2,
                   delta_r: ext.Fp2, cfp: gl.Fp) -> gl.Fp:
    """(4, n) RAM aux base columns [inv.re | inv.im | S.re | S.im] for
    air.ram_multiset (see _ram_constraint_evals). ``cfp``: the AIR's
    constant columns on the trace's device."""
    mult_c, ld_c, ad_c, act_c, val_col = air.ram_multiset()
    fp = ext.sub(gamma, ext.add(ext.from_base(cfp[ad_c]),
                                ext.mul_base(delta_r, trace[val_col])))
    inv = ext.mul_base(ext.inv(fp), cfp[act_c])       # 0 on inactive rows
    contrib = ext.mul_base(inv, gl.sub(cfp[mult_c], cfp[ld_c]))
    s_re, s_im = _exscan(contrib)
    return torch.stack([inv[0], inv[1], s_re, s_im])


def _build_aux(air: Air, trace: gl.Fp, lk_cols, gamma: ext.Fp2,
               delta_r, n: int, cfp: gl.Fp | None) -> gl.Fp:
    """Full aux trace: LogUp range block (if any) then the RAM block.
    ``cfp``: the constant columns on the trace's device, as constant_vk
    caches them (read only by the RAM block)."""
    parts = []
    if lk_cols:
        parts.append(_build_aux_trace(trace, lk_cols, gamma, n))
    if air.ram_multiset() is not None:
        parts.append(_build_ram_aux(air, trace, gamma, delta_r, cfp))
    return torch.cat(parts)


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
        m = _group_size(c)
        cf = c.reshape(m, n_lde)
        a_re, a_im = _ext_col(_slice_ext(alphas_all, k, k + m))
        acc = ext.add(acc, (gl.sum_mod(gl.mul(a_re, cf), axis=0),
                            gl.sum_mod(gl.mul(a_im, cf), axis=0)))
        k += m
    return acc, k


def quotient_tail(quotient: ext.Fp2, n: int, n_chunks: int, rate: int,
                  shift: int, ntt_ops=None):
    """Quotient codeword -> (quot_cols, chunk_evals_lde, chunk_evals_sub):
    coset INTT, degree-N chunk split, per-chunk coset/subgroup re-evals.
    The transforms are ``ntt_ops``'s (``coset_intt``,
    ``coeffs_to_coset_evals``, ``ntt``): ``poly/ntt.py``'s by default,
    the sharded ones with parallel/ntt_dist.ShardedNttOps."""
    ops = ntt_ops or pntt
    q_re = ops.coset_intt(quotient[0], shift)
    q_im = ops.coset_intt(quotient[1], shift)
    chunk_evals_lde, chunk_evals_sub = [], []
    for i in range(n_chunks):
        cre = q_re[i * n:(i + 1) * n]
        cim = q_im[i * n:(i + 1) * n]
        chunk_evals_lde.append((ops.coeffs_to_coset_evals(cre, rate, shift),
                                ops.coeffs_to_coset_evals(cim, rate, shift)))
        chunk_evals_sub.append((ops.ntt(cre), ops.ntt(cim)))
    quot_cols = torch.stack([c[j] for c in chunk_evals_lde for j in (0, 1)])
    return quot_cols, chunk_evals_lde, chunk_evals_sub


def _group_size(c) -> int:
    """Number of constraints in one (possibly grouped) base or ext
    constraint over the domain: the product of its leading axes."""
    shape = (c[0] if isinstance(c, tuple) else c).shape[:-1]
    return int(np.prod(shape)) if shape else 1


def _combine_ext(constraints, alphas_all: ext.Fp2, k0: int, acc: ext.Fp2,
                 n_lde: int):
    """α-combine ext-valued constraints (the LogUp/RAM terms); a grouped
    one takes one α per member in flatten order."""
    k = k0
    for c in constraints:
        m = _group_size(c)
        if c[0].dim() == 1:
            acc = ext.add(acc, ext.mul(_pick_ext(alphas_all, k), c))
        else:
            cc = (c[0].reshape(m, n_lde), c[1].reshape(m, n_lde))
            acc = ext.add(acc, _weighted_sum0(
                cc, _slice_ext(alphas_all, k, k + m)))
        k += m
    return acc, k


def _aux_constraints(air: Air, trace_w: gl.Fp, c_w, aux_w: gl.Fp,
                     aux_nw: gl.Fp, gamma: ext.Fp2, delta):
    """The LogUp constraints, then the RAM constraints, over a window of
    the LDE domain (``*_w`` its rows, ``aux_nw`` the aux rows one trace
    step on): (every, transition, first, last) lists of ext-valued
    constraints."""
    lk_cols = air.lookup_range_columns()
    ram_spec = air.ram_multiset()
    lk_e, lk_t, lk_f, lk_l = [], [], [], []

    def pair(i):
        return aux_w[i], aux_w[i + 1]

    def pair_next(i):
        return aux_nw[i], aux_nw[i + 1]

    base_r = 0
    if lk_cols:
        lk_p = _padded_lk(lk_cols)
        kk2 = len(lk_p) // 2
        base_r = 2 * kk2 + 6
        w_all = ext.from_base(
            trace_w[torch.tensor(lk_p, device=trace_w.device)])
        lk_e, lk_t, lk_f, lk_l = _lookup_constraint_evals(
            gamma,
            _slice_ext(w_all, slice(0, None, 2)),        # (kk2, B)
            _slice_ext(w_all, slice(1, None, 2)),
            (aux_w[0:2 * kk2:2], aux_w[1:2 * kk2:2]),
            pair(2 * kk2), ext.from_base(aux_w[2 * kk2 + 2]),
            pair(2 * kk2 + 3), pair_next(2 * kk2 + 3),
            ext.from_base(aux_w[2 * kk2 + 5]),
            ext.from_base(aux_nw[2 * kk2 + 5]))
    if ram_spec is not None:
        mult_c, ld_c, ad_c, act_c, val_col = ram_spec
        r_e, r_t, r_f, r_l = _ram_constraint_evals(
            gamma, delta, ext.from_base(c_w[ad_c]),
            ext.from_base(c_w[mult_c]), ext.from_base(c_w[ld_c]),
            ext.from_base(c_w[act_c]), ext.from_base(trace_w[val_col]),
            pair(base_r), pair(base_r + 2), pair_next(base_r + 2))
        lk_e, lk_t, lk_f, lk_l = lk_e + r_e, lk_t + r_t, lk_f + r_f, lk_l + r_l
    return lk_e, lk_t, lk_f, lk_l


def _window(lde: gl.Fp, s: int, b: int, step: int):
    """Rows [s, s+b) of an LDE and the rows ``step`` on, wrapping at the
    end of the domain: views where they lie in one piece."""
    n_lde = lde.shape[1]
    here = lde[:, s:s + b]
    t = s + step
    if t + b <= n_lde:
        return here, lde[:, t:t + b]
    return here, torch.cat([lde[:, t:], lde[:, :t + b - n_lde]], dim=1)


def quotient_phase(air: Air, log_n: int, rate: int, trace_lde: gl.Fp,
                   c_lde, publics: List[gl.Fp], alpha: ext.Fp2,
                   gamma: ext.Fp2 | None = None, delta: ext.Fp2 | None = None,
                   aux_lde: gl.Fp | None = None, ntt_ops=None):
    """Constraint evaluation over the LDE domain (the AIR's, then the
    LogUp/RAM ones when there is an aux trace), α-combination, vanishing
    division, chunk split and re-evaluation. α order: transition, LogUp/RAM
    transition, first, LogUp/RAM first, last, LogUp/RAM last, every-row.
    ``ntt_ops`` (parallel/ntt_dist.ShardedNttOps or alike) runs the chunk
    split's transforms; by default they are ``poly/ntt.py``'s.

    The evaluation runs over windows of rows (``_row_window``): a window
    reads its rows and the rows one trace step on out of the resident LDEs,
    so the constraints' temporaries are groups × window, not groups ×
    N_lde. The codeword is the same for every window size."""
    n = 1 << log_n
    n_lde = n << rate
    blowup = 1 << rate
    dev = trace_lde.device
    width = (trace_lde.shape[0] + (c_lde.shape[0] if c_lde is not None else 0)
             + (aux_lde.shape[0] if aux_lde is not None else 0))
    kk2 = (len(air.lookup_range_columns()) + 1) // 2
    b = _row_window(n_lde, width, kk2, dev)
    dom = _domain_arrays(log_n, rate, dev)
    alphas = None
    parts = []
    for s in range(0, n_lde, b):
        tw, tnw = _window(trace_lde, s, b, blowup)
        if c_lde is not None:
            cw, cnw = _window(c_lde, s, b, blowup)
            consts, consts_next = list(cw), list(cnw)
        else:
            cw = None
            consts, consts_next = [], []
        alg = BaseVecAlgebra((b,), dev)
        local = list(tw)
        ct = air.transition(alg, local, list(tnw), publics, consts,
                            consts_next)
        cf = air.first_row(alg, local, publics, consts)
        cl = air.last_row(alg, local, publics, consts)
        if aux_lde is not None:
            aw, anw = _window(aux_lde, s, b, blowup)
            lk_e, lk_t, lk_f, lk_l = _aux_constraints(
                air, tw, cw, aw, anw, gamma, delta)
        else:
            lk_e, lk_t, lk_f, lk_l = [], [], [], []
        if alphas is None:
            n_constraints = sum(_group_size(c) for c in
                                ct + cf + cl + lk_t + lk_f + lk_l + lk_e)
            alphas = _alpha_power_array(alpha, n_constraints)
        k = 0
        ct_comb, k = _combine(ct, alphas, k, ext.zeros((b,), dev), b)
        ct_comb, k = _combine_ext(lk_t, alphas, k, ct_comb, b)
        cf_comb, k = _combine(cf, alphas, k, ext.zeros((b,), dev), b)
        cf_comb, k = _combine_ext(lk_f, alphas, k, cf_comb, b)
        cl_comb, k = _combine(cl, alphas, k, ext.zeros((b,), dev), b)
        cl_comb, k = _combine_ext(lk_l, alphas, k, cl_comb, b)
        del ct, cf, cl

        # divide by the per-class vanishing polynomials
        xmg, inv_zh, inv_x_minus_1, inv_x_minus_glast = (
            d[s:s + b] for d in dom)
        q_t = ext.mul_base(ext.mul_base(ct_comb, xmg), inv_zh)
        q_f = ext.mul_base(cf_comb, inv_x_minus_1)
        q_l = ext.mul_base(cl_comb, inv_x_minus_glast)
        quotient = ext.add(ext.add(q_t, q_f), q_l)
        if lk_e:
            # the every-row class (the inverse definitions): divisor Z_H
            ce_comb, k = _combine_ext(lk_e, alphas, k, ext.zeros((b,), dev),
                                      b)
            quotient = ext.add(quotient, ext.mul_base(ce_comb, inv_zh))
        parts.append(quotient)
    quotient = (torch.cat([q[0] for q in parts]),
                torch.cat([q[1] for q in parts]))
    return quotient_tail(quotient, n, num_quotient_chunks(air), rate, SHIFT,
                         ntt_ops)


def _open_at(mats: List[gl.Fp], point: ext.Fp2, log_n: int) -> ext.Fp2:
    """Barycentric values at ``point`` of every row of the (k_i, n)
    matrices, in order, a block of rows at a time."""
    n = 1 << log_n
    out_re, out_im = [], []
    for m in mats:
        t = _col_tile(m.shape[0], n, _OPEN_TEMPS, m.device)
        for r0 in range(0, m.shape[0], t):
            re, im = pdom.barycentric_eval(m[r0:r0 + t], point, log_n)
            out_re.append(re)
            out_im.append(im)
    return torch.cat(out_re), torch.cat(out_im)


# -- prove -----------------------------------------------------------------------------

def prove(air: Air, trace: gl.Fp, publics: List[gl.Fp], config: StarkConfig,
          challenger: Challenger | None = None, timer=None,
          ntt_ops=None) -> StarkProof:
    """trace: (num_cols, N) base field; publics: list of scalar Fp, on the
    trace's device. ``timer(phase)``, if given, is called as each phase
    ends (phase names: lde, commit, aux when the AIR has lookups or a RAM,
    quotient, openings, deep, fri, queries).

    ``ntt_ops`` (``parallel/ntt_dist.ShardedNttOps``) runs every transform
    of the proof over a device mesh: its ``coset_lde`` the trace and aux
    blowups in place of ``lde_cols``, the rest the quotient's NTT tail.
    Either gives the same bytes."""
    lde = lde_cols if ntt_ops is None else ntt_ops.coset_lde
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
    trace_lde = lde(trace, rate)                       # (num_cols, N_lde)
    mark("lde")
    trace_tree = merkle.build_cols(trace_lde, cap_height=config.cap_height)
    challenger.observe(torch.stack(publics))
    if has_consts:
        challenger.observe_digests(vk_tree.cap)
    challenger.observe_digests(trace_tree.cap)
    mark("commit")

    # -- LogUp/RAM aux phase: γ (and δ for a RAM) squeezed after the trace
    # commitment, the aux trace committed before α -------------------------
    lk_cols = air.lookup_range_columns()
    has_ram = air.ram_multiset() is not None
    has_aux = len(lk_cols) > 0 or has_ram
    aux_tree = aux_trace = aux_lde = gamma = delta_r = None
    n_aux = 0
    if has_aux:
        gamma = _pick_ext(challenger.squeeze_ext(1), 0)
        if has_ram:
            delta_r = _pick_ext(challenger.squeeze_ext(1), 0)
        aux_trace = _build_aux(air, trace, lk_cols, gamma, delta_r, n, cfp)
        n_aux = aux_trace.shape[0]
        aux_lde = lde(aux_trace, rate)
        aux_tree = merkle.build_cols(aux_lde, cap_height=config.cap_height)
        challenger.observe_digests(aux_tree.cap)
        mark("aux")

    alpha = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 3/4: constraints + quotient ---------------------------------------
    quot_cols, chunk_evals_lde, chunk_evals_sub = quotient_phase(
        air, log_n, rate, trace_lde, c_lde, publics, alpha, gamma, delta_r,
        aux_lde, ntt_ops)
    n_chunks = num_quotient_chunks(air)
    quot_tree = merkle.build_cols(quot_cols, cap_height=config.cap_height)
    challenger.observe_digests(quot_tree.cap)
    mark("quotient")

    zeta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- 5: openings at ζ and g·ζ: one batched barycentric evaluation for
    # the trace, aux, constant and quotient-chunk components ----------------
    g_zeta = ext.mul_base(zeta, gl.full((), g_dom, dev))
    committed = ([trace] + ([aux_trace] if has_aux else [])
                 + ([cfp] if has_consts else []))
    chunk_sub = [c[j][None, :] for c in chunk_evals_sub for j in (0, 1)]
    opened = _open_at(committed + chunk_sub, zeta, log_n)
    opened_g = _open_at(committed, g_zeta, log_n)
    k_aux, k_const = num_cols, num_cols + n_aux
    k_quot = k_const + n_consts
    trace_zeta = _slice_ext(opened, 0, num_cols)
    trace_gzeta = _slice_ext(opened_g, 0, num_cols)
    aux_zeta = _slice_ext(opened, k_aux, k_const) if has_aux else None
    aux_gzeta = _slice_ext(opened_g, k_aux, k_const) if has_aux else None
    const_zeta = _slice_ext(opened, k_const, k_quot) if has_consts else None
    const_gzeta = _slice_ext(opened_g, k_const, k_quot) if has_consts else None

    # recombine chunk components: value = re_v + u*im_v, u^2 = W
    quotient_zeta = _stack_ext(
        [_recombine_u(_pick_ext(opened, k_quot + 2 * i),
                      _pick_ext(opened, k_quot + 2 * i + 1))
         for i in range(n_chunks)])

    def obs_ext(v: ext.Fp2):
        challenger.observe(torch.cat([v[0].reshape(-1), v[1].reshape(-1)]))

    obs_ext(trace_zeta)
    obs_ext(trace_gzeta)
    if has_aux:
        obs_ext(aux_zeta)
        obs_ext(aux_gzeta)
    if has_consts:
        obs_ext(const_zeta)
        obs_ext(const_gzeta)
    obs_ext(quotient_zeta)
    mark("openings")

    beta = _pick_ext(challenger.squeeze_ext(1), 0)

    # -- DEEP composition codeword -------------------------------------------
    ch_stack = _stack_ext(chunk_evals_lde)
    F = _deep_phase_raw(log_n, rate, trace_lde, aux_lde, c_lde, ch_stack,
                        trace_zeta, trace_gzeta, aux_zeta, aux_gzeta,
                        const_zeta, const_gzeta, quotient_zeta, zeta, g_zeta,
                        beta)
    mark("deep")

    # -- 6: FRI ------------------------------------------------------------
    fri_proof, indices = fri.prove(F, challenger, config.fri_config)
    mark("fri")

    # -- 7: openings at query indices ---------------------------------------
    idx_a = indices
    idx_b = indices + n_lde // 2
    (tra, tpa), (trb, tpb), (qra, qpa), (qrb, qpb), aux_opens, const_opens = \
        _open_queries_raw(trace_tree, trace_lde, quot_tree, quot_cols,
                          aux_tree, aux_lde, vk_tree, c_lde, idx_a, idx_b)
    (ara, apa), (arb, apb) = aux_opens or ((None, None), (None, None))
    (cra, cpa), (crb, cpb) = const_opens or ((None, None), (None, None))
    mark("queries")

    return StarkProof(
        trace_cap=trace_tree.cap, quotient_cap=quot_tree.cap,
        trace_zeta=trace_zeta, trace_gzeta=trace_gzeta,
        quotient_zeta=quotient_zeta, fri_proof=fri_proof,
        trace_rows_a=tra, trace_rows_b=trb,
        trace_paths_a=tpa, trace_paths_b=tpb,
        quot_rows_a=qra, quot_rows_b=qrb,
        quot_paths_a=qpa, quot_paths_b=qpb,
        aux_cap=aux_tree.cap if has_aux else None,
        aux_zeta=aux_zeta, aux_gzeta=aux_gzeta,
        aux_rows_a=ara, aux_rows_b=arb,
        aux_paths_a=apa, aux_paths_b=apb,
        const_zeta=const_zeta, const_gzeta=const_gzeta,
        const_rows_a=cra, const_rows_b=crb,
        const_paths_a=cpa, const_paths_b=cpb,
    )


def _deep_phase_raw(log_n, rate, trace_lde, aux_lde, const_lde, ch_stack,
                    trace_zeta, trace_gzeta, aux_zeta, aux_gzeta,
                    const_zeta, const_gzeta, quotient_zeta, zeta, g_zeta, beta):
    """DEEP composition: β-batched deviation quotients of every opening
    group into one GF(p^2) codeword. β-power term order (mirrored by the
    verifier): trace ζ | trace gζ | aux ζ | aux gζ | const ζ | const gζ |
    quotient. Each group is summed a block of columns at a time
    (``_col_tile``)."""
    n_lde = 1 << (log_n + rate)
    dev = trace_lde.device
    num_cols = trace_lde.shape[0]
    n_aux = aux_lde.shape[0] if aux_lde is not None else 0
    n_consts = const_lde.shape[0] if const_lde is not None else 0
    n_chunks = ch_stack[0].shape[0]

    xe = ext.from_base(pdom.domain_points(log_n + rate, SHIFT, dev))
    inv_xz = ext.inv(ext.sub(xe, zeta))
    inv_xgz = ext.inv(ext.sub(xe, g_zeta))

    n_terms = 2 * num_cols + 2 * n_aux + 2 * n_consts + n_chunks
    betas = _alpha_power_array(beta, n_terms)

    tile = _col_tile(max(num_cols, n_aux, n_consts, 1), n_lde, _DEEP_TEMPS,
                     dev)

    def block(F, lde, z_open, gz_open, k0, ncol):
        # a block of columns at a time: untiled, a 3336-column block holds
        # ~17 (C, N_lde) extension temporaries
        for c0 in range(0, ncol, tile):
            c1 = min(ncol, c0 + tile)
            fp2 = ext.from_base(lde[c0:c1])
            dz = ext.sub(fp2, _ext_col(_slice_ext(z_open, c0, c1)))
            F = ext.add(F, _weighted_sum0(ext.mul(dz, _ext_row(inv_xz)),
                                          _slice_ext(betas, k0 + c0,
                                                     k0 + c1)))
            del dz
            dgz = ext.sub(fp2, _ext_col(_slice_ext(gz_open, c0, c1)))
            F = ext.add(F, _weighted_sum0(
                ext.mul(dgz, _ext_row(inv_xgz)),
                _slice_ext(betas, k0 + ncol + c0, k0 + ncol + c1)))
        return F

    F = block(ext.zeros((n_lde,), dev), trace_lde, trace_zeta, trace_gzeta,
              0, num_cols)
    kbase = 2 * num_cols
    if aux_lde is not None:
        F = block(F, aux_lde, aux_zeta, aux_gzeta, kbase, n_aux)
        kbase += 2 * n_aux
    if const_lde is not None:
        F = block(F, const_lde, const_zeta, const_gzeta, kbase, n_consts)
        kbase += 2 * n_consts
    diff_q = ext.sub(ch_stack, _ext_col(quotient_zeta))
    return ext.add(F, _weighted_sum0(ext.mul(diff_q, _ext_row(inv_xz)),
                                     _slice_ext(betas, kbase, n_terms)))


def _open_queries_raw(trace_tree, trace_cols, quot_tree, quot_cols,
                      aux_tree, aux_cols, vk_tree, vk_cols, idx_a, idx_b):
    """Open every committed tree at both query-index halves. Committed
    matrices are column-major (w, n_lde): query rows are gathered."""
    def open_rows(tree, cols, idx):
        return cols[:, idx].t().contiguous(), merkle.prove(tree, idx)

    out = (open_rows(trace_tree, trace_cols, idx_a),
           open_rows(trace_tree, trace_cols, idx_b),
           open_rows(quot_tree, quot_cols, idx_a),
           open_rows(quot_tree, quot_cols, idx_b))
    aux = consts = None
    if aux_tree is not None:
        aux = (open_rows(aux_tree, aux_cols, idx_a),
               open_rows(aux_tree, aux_cols, idx_b))
    if vk_tree is not None:
        consts = (open_rows(vk_tree, vk_cols, idx_a),
                  open_rows(vk_tree, vk_cols, idx_b))
    return out + (aux, consts)
