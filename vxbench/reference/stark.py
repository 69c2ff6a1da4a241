"""A plain check of a DEEP-ALI STARK proof against the configuration that
the benchmark states: its shape, its transcript, its grinding, its
commitments, its FRI folding and its DEEP composition.

It takes the proof as plain numpy arrays (``as_arrays`` of the harness),
the statement's public values and the statement's constant columns,
which the reference lays out itself. What it leaves to the program's
verifier is the one step that needs the AIR's constraints: the
constraints at the out-of-domain point ζ against the opened quotient
(the harness holds that step with a false statement instead). The
constants' Merkle cap (``vk_cap``) is the one value of the program's
that it reads, and it reads it to judge it: the transcript observes it
before ζ, the openings of the constant columns must lead to it, DEEP and
FRI tie those openings to the values at ζ and gζ, and those must be the
values of the reference's own constant columns there. A cap of other
constants passes all of that only where the two sets of polynomials
agree at a point drawn after the cap was fixed.

The protocol, for AIRs without a RAM multiset (the benchmark's), in
transcript order: observe the publics, the constants' cap (if any), the
trace cap; squeeze γ and observe the aux cap (if the AIR has lookups); squeeze α; observe the quotient cap; squeeze ζ;
observe the openings at ζ and gζ (each as all real parts, then all
imaginary parts: trace, aux, constants, then the quotient chunks at ζ);
squeeze β; per FRI layer observe its cap and squeeze its fold
challenge; observe the final coefficients (real, then imaginary); absorb
what is pending, observe the grinding nonce, squeeze the response (its
low pow_bits bits must be 0) and then the query indices (low bits of
the squeezed words).

Domains: the LDE of a trace of 2^log_n rows at rate 2^r is the coset
7·⟨w⟩ of 2^(log_n + r) points in natural order. FRI layer l lives on
7^(2^l)·⟨w_l⟩; its leaf j packs (f(x_j), f(-x_j)) as four base elements,
and folds to f'(x^2) = (a + b)/2 + β (a - b)/(2x).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import goldilocks as gf
from . import poseidon as ps

P = gf.P


def _ext_pairs(v) -> List[tuple]:
    re, im = v
    return [(int(a), int(b)) for a, b in zip(np.ravel(re), np.ravel(im))]


def _flat_ext(v) -> List[int]:
    re, im = v
    return [int(a) for a in np.ravel(re)] + [int(b) for b in np.ravel(im)]


def shape_faults(proof: Dict, shape: Dict, config: Dict) -> List[str]:
    """Where the proof departs from the stated widths and configuration."""
    q, r = config["num_queries"], config["rate_bits"]
    log_lde = shape["log_n"] + r
    depth = log_lde - config["cap_height"]
    faults = []

    def want(name, got, expected):
        if got != expected:
            faults.append(f"{name}: {got} != {expected}")

    for name, width in (("trace", shape["num_cols"]),
                        ("quot", 2 * shape["n_chunks"]),
                        ("aux", shape["n_aux"]), ("const", shape["n_consts"])):
        for half in "ab":
            rows = proof.get(f"{name}_rows_{half}")
            paths = proof.get(f"{name}_paths_{half}")
            if width == 0:
                want(f"{name}_rows_{half}", rows is None, True)
                continue
            want(f"{name}_rows_{half}", None if rows is None else rows.shape,
                 (q, width))
            want(f"{name}_paths_{half}",
                 None if paths is None else paths.shape, (q, depth, 4))
    n_layers = log_lde - ((config["final_poly_len"].bit_length() - 1) + r)
    want("fri layers", len(proof["fri_caps"]), n_layers)
    want("final coefficients", len(proof["final_coeffs"][0]),
         config["final_poly_len"])
    for layer, (leaves, paths) in enumerate(zip(proof["fri_leaves"],
                                                proof["fri_paths"])):
        want(f"fri leaves {layer}", leaves.shape, (q, 4))
        want(f"fri paths {layer}", paths.shape,
             (q, log_lde - 1 - layer - config["cap_height"], 4))
    want("trace zeta", len(proof["trace_zeta"][0]), shape["num_cols"])
    want("quotient zeta", len(proof["quotient_zeta"][0]), shape["n_chunks"])
    return faults


def check(proof: Dict, publics: List[int], shape: Dict, config: Dict,
          vk_cap=None, constants=None) -> List[str]:
    """-> the checks the proof fails (empty: accepted), ``shape_faults``
    first. When the statement has constant columns, ``constants`` are
    their values, (c, 2^log_n), and ``vk_cap`` their cap, (c, 4)."""
    faults = shape_faults(proof, shape, config)
    if faults:
        return faults
    log_n, rate = shape["log_n"], config["rate_bits"]
    log_lde = log_n + rate
    n_lde = 1 << log_lde
    has_aux, has_consts = shape["n_aux"] > 0, shape["n_consts"] > 0

    tr = ps.Transcript()
    tr.observe(publics)
    if has_consts:
        tr.observe(np.ravel(vk_cap))
    tr.observe(np.ravel(proof["trace_cap"]))
    if has_aux:
        tr.squeeze_ext()                                  # γ
        tr.observe(np.ravel(proof["aux_cap"]))
    tr.squeeze_ext()                                      # α
    tr.observe(np.ravel(proof["quotient_cap"]))
    zeta = tr.squeeze_ext()
    blocks = [("trace", shape["num_cols"])]
    if has_aux:
        blocks.append(("aux", shape["n_aux"]))
    if has_consts:
        blocks.append(("const", shape["n_consts"]))
    for name, _ in blocks:
        tr.observe(_flat_ext(proof[f"{name}_zeta"]))
        tr.observe(_flat_ext(proof[f"{name}_gzeta"]))
    tr.observe(_flat_ext(proof["quotient_zeta"]))
    beta = tr.squeeze_ext()

    # FRI transcript
    fri_betas = []
    for cap in proof["fri_caps"]:
        tr.observe(np.ravel(cap))
        fri_betas.append(tr.squeeze_ext())
    tr.observe(_flat_ext(proof["final_coeffs"]))
    if config["pow_bits"] > 0:
        tr.squeeze(0)
    tr.observe([int(proof["pow_nonce"])])
    response = tr.squeeze(1)[0]
    mask_q = (1 << (log_lde - 1)) - 1
    indices = np.array([v & mask_q for v in tr.squeeze(config["num_queries"])],
                       dtype=np.int64)
    faults = []
    g_zeta = gf.e_mul(zeta, (gf.root_of_unity(log_n), 0))
    if has_consts:
        constants = np.asarray(constants, dtype=np.uint64)
        if constants.shape != (shape["n_consts"], 1 << log_n):
            faults.append(f"constants: shape {constants.shape}")
        else:
            coeffs = gf.coefficients(constants)
            for name, point in (("const_zeta", zeta), ("const_gzeta", g_zeta)):
                if gf.evaluate(coeffs, point) != _ext_pairs(proof[name]):
                    faults.append(f"{name}: not the statement's constants")
    if response & ((1 << config["pow_bits"]) - 1):
        faults.append(f"grinding: response {response:#x} has fewer than "
                      f"{config['pow_bits']} low zero bits")

    # commitments: every opened row at both halves of each FRI pair, and
    # every FRI leaf, one batched pass
    idx_ab = np.concatenate([indices, indices + n_lde // 2])
    commits = [("trace", proof["trace_cap"]), ("quot", proof["quotient_cap"])]
    if has_aux:
        commits.append(("aux", proof["aux_cap"]))
    if has_consts:
        commits.append(("const", vk_cap))
    opened = [(np.concatenate([proof[f"{n}_rows_a"], proof[f"{n}_rows_b"]]),
               idx_ab,
               np.concatenate([proof[f"{n}_paths_a"], proof[f"{n}_paths_b"]]))
              for n, _ in commits]
    layer_idx, idx = [], indices
    for layer in range(len(proof["fri_caps"])):
        idx = idx % (1 << (log_lde - layer - 1))
        layer_idx.append(idx)
        opened.append((proof["fri_leaves"][layer], idx,
                       proof["fri_paths"][layer]))
    caps = [c for _, c in commits] + list(proof["fri_caps"])
    roots = ps.merkle_roots(opened)
    names = [n for n, _ in commits] + [f"fri layer {i}"
                                       for i in range(len(proof["fri_caps"]))]
    for name, root, (_, ix, pth), cap in zip(names, roots, opened, caps):
        cap = np.asarray(cap, dtype=np.uint64)
        want = cap[ix >> pth.shape[1]]
        if not np.array_equal(root, want):
            faults.append(f"{name}: an opening is not in its commitment")

    # FRI folding, down to the final polynomial
    shift, cur = gf.GENERATOR, None
    prev = indices
    for layer, leaves in enumerate(proof["fri_leaves"]):
        li = layer_idx[layer]
        llog = log_lde - layer
        half = 1 << (llog - 1)
        leaves = [[int(v) for v in row] for row in leaves]
        root = gf.root_of_unity(llog)
        nxt = []
        for k, row in enumerate(leaves):
            a, b = (row[0], row[1]), (row[2], row[3])
            if layer > 0:
                expect = a if prev[k] < half else b
                if cur[k] != expect:
                    faults.append(f"fri fold into layer {layer}")
                    return faults
            x = shift * pow(root, int(li[k]), P) % P
            s = gf.e_add(a, b)
            s = (s[0] * gf.inv(2) % P, s[1] * gf.inv(2) % P)
            d = gf.e_sub(a, b)
            i2x = gf.inv(2 * x % P)
            d = (d[0] * i2x % P, d[1] * i2x % P)
            nxt.append(gf.e_add(s, gf.e_mul(d, fri_betas[layer])))
        cur, prev = nxt, li
        shift = shift * shift % P
    llog = log_lde - len(proof["fri_caps"])
    root = gf.root_of_unity(llog)
    coeffs = _ext_pairs(proof["final_coeffs"])
    for k in range(len(indices)):
        x = shift * pow(root, int(prev[k]), P) % P
        acc = (0, 0)
        for c in reversed(coeffs):
            acc = gf.e_add((acc[0] * x % P, acc[1] * x % P), c)
        if acc != cur[k]:
            faults.append("fri final polynomial")
            break

    # DEEP: layer 0's values from the openings
    leaves0 = proof["fri_leaves"][0] if proof["fri_leaves"] else None
    if leaves0 is None:
        faults.append("fri has no layer")
        return faults
    n_terms = (2 * sum(w for _, w in blocks) + shape["n_chunks"])
    betas = gf.e_powers(beta, n_terms)
    lde_root = gf.root_of_unity(log_lde)
    for half_name, pos, lo in (("a", indices, 0), ("b", indices + n_lde // 2,
                                                   2)):
        xs = [gf.GENERATOR * pow(lde_root, int(i), P) % P for i in pos]
        inv_z = [gf.e_inv(gf.e_sub((x, 0), zeta)) for x in xs]
        inv_gz = [gf.e_inv(gf.e_sub((x, 0), g_zeta)) for x in xs]
        acc_z = [(0, 0)] * len(xs)
        acc_gz = [(0, 0)] * len(xs)
        k0 = 0
        for name, width in blocks:
            rows = proof[f"{name}_rows_{half_name}"]
            for opening, acc, k in ((proof[f"{name}_zeta"], acc_z, k0),
                                    (proof[f"{name}_gzeta"], acc_gz,
                                     k0 + width)):
                w = betas[k:k + width]
                w_re = np.array([v[0] for v in w], dtype=np.uint64)
                w_im = np.array([v[1] for v in w], dtype=np.uint64)
                # Σ_c β_c (v_c - o_c) = Σ_c β_c v_c - Σ_c β_c o_c
                s_re = gf.sum_rows(gf.mul(rows, w_re[None, :]))
                s_im = gf.sum_rows(gf.mul(rows, w_im[None, :]))
                o = _ext_pairs(opening)
                const = (0, 0)
                for bc, oc in zip(w, o):
                    const = gf.e_add(const, gf.e_mul(bc, oc))
                for j in range(len(xs)):
                    acc[j] = gf.e_add(acc[j], gf.e_sub((s_re[j], s_im[j]),
                                                       const))
            k0 += 2 * width
        quot = proof[f"quot_rows_{half_name}"]
        qz = _ext_pairs(proof["quotient_zeta"])
        for j in range(len(xs)):
            for c in range(shape["n_chunks"]):
                v = (int(quot[j, 2 * c]), int(quot[j, 2 * c + 1]))
                acc_z[j] = gf.e_add(acc_z[j], gf.e_mul(betas[k0 + c],
                                                        gf.e_sub(v, qz[c])))
            f = gf.e_add(gf.e_mul(acc_z[j], inv_z[j]),
                         gf.e_mul(acc_gz[j], inv_gz[j]))
            got = (int(leaves0[j, lo]), int(leaves0[j, lo + 1]))
            if f != got:
                faults.append(f"deep composition at query {j} ({half_name})")
                return faults
    return faults
