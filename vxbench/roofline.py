"""The Poseidon permutations a prove needs, counted from the proof's
shapes, and the least time the card could take for them.

The bound of one permutation is in INT32 operations (a 64 x 64 -> 128-bit
product is four 32 x 32 -> 64 multiply-adds, an MDS term one shift-add per
32-bit half), over the INT32 rate of the card at its highest SM clock; the
bytes (each input read once, each output written once) over the memory
rate are the other bound, and the larger of the two holds. The arithmetic
is ``bound_ms`` of ``chip_smoke.py``.

What a prove commits, with n rows and rate 2^r (N = n 2^r LDE rows):
the constant columns (every job proves with an air of its own, whose
constants' commitment the prove builds), the trace, the aux columns and
the quotient chunks (2 base columns a chunk) are N rows each, a sponge
of ceil(width / 8) permutations a row, and a tree of N - 2^cap
compressions; FRI layer l commits N / 2^(l+1) leaves of 4 elements (one
permutation each) and their tree; grinding permutes one state per nonce
tried, nonce + 1 at the least. The transcript's few hundred permutations
are left out: the count is what the prove needs at the least.
"""

from __future__ import annotations

from .peaks import H100

PRODUCTS_PER_PERM = 8 * 12 * 4 + 22 * 4 + 22 * 23 + 144     # 1,122
MDS_TERMS_PER_PERM = 8 * 144                                # 1,152
INT32_OPS_PER_PERM = 4 * PRODUCTS_PER_PERM + 2 * MDS_TERMS_PER_PERM
STATE_BYTES = 12 * 8


def bound_s(perms: int, nbytes: int, sm_mhz: float, peaks=H100) -> float:
    ops = perms * INT32_OPS_PER_PERM / (
        peaks["sms"] * peaks["int32_lanes_per_sm"] * sm_mhz * 1e6)
    return max(ops, nbytes / peaks["hbm_bytes_per_s"])


def prove_work(shape: dict, guarantee: dict, pow_nonce: int):
    """-> [(what, permutations, bytes)] of one prove."""
    n_lde = 1 << (shape["log_n"] + guarantee["rate_bits"])
    leaves_kept = 1 << guarantee["cap_height"]
    out = []
    for what, width in (("constants", shape["n_consts"]),
                        ("trace", shape["num_cols"]), ("aux", shape["n_aux"]),
                        ("quotient", 2 * shape["n_chunks"])):
        if width == 0:
            continue
        out.append((f"{what} leaves", n_lde * -(-width // 8),
                    n_lde * (width * 8 + 32)))
        out.append((f"{what} tree", n_lde - leaves_kept,
                    (n_lde - leaves_kept) * 2 * STATE_BYTES))
    final_bits = (guarantee["final_poly_len"].bit_length() - 1
                  + guarantee["rate_bits"])
    log_lde = shape["log_n"] + guarantee["rate_bits"]
    for layer in range(log_lde - final_bits):
        leaves = n_lde >> (layer + 1)
        out.append((f"fri layer {layer}", 2 * leaves - leaves_kept,
                    leaves * 64 + (leaves - leaves_kept) * 2 * STATE_BYTES))
    if guarantee["pow_bits"] > 0:
        out.append(("grinding", pow_nonce + 1,
                    (pow_nonce + 1) * 2 * STATE_BYTES))
    return out


def prove_bound_s(shape: dict, guarantee: dict, pow_nonce: int,
                  sm_mhz: float) -> float:
    return sum(bound_s(perms, nbytes, sm_mhz)
               for _, perms, nbytes in prove_work(shape, guarantee, pow_nonce))
