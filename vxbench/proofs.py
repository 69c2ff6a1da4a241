"""The program's proof object as plain numpy arrays, the form the
reference reads (``reference/stark.py``), and a copy with one bit of an
opened row flipped."""

from __future__ import annotations

import copy

import numpy as np

_ROWS = ("trace", "quot", "aux", "const")


def _u64(t):
    if t is None:
        return None
    return t.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def _ext(v):
    return None if v is None else (_u64(v[0]), _u64(v[1]))


def as_arrays(proof) -> dict:
    out = {"trace_cap": _u64(proof.trace_cap),
           "quotient_cap": _u64(proof.quotient_cap),
           "aux_cap": _u64(proof.aux_cap)}
    for name in ("trace", "aux", "const"):
        out[f"{name}_zeta"] = _ext(getattr(proof, f"{name}_zeta"))
        out[f"{name}_gzeta"] = _ext(getattr(proof, f"{name}_gzeta"))
    out["quotient_zeta"] = _ext(proof.quotient_zeta)
    for name in _ROWS:
        for half in "ab":
            out[f"{name}_rows_{half}"] = _u64(getattr(proof, f"{name}_rows_{half}"))
            out[f"{name}_paths_{half}"] = _u64(getattr(proof, f"{name}_paths_{half}"))
    fri = proof.fri_proof
    out["fri_caps"] = [_u64(c) for c in fri.caps]
    out["final_coeffs"] = _ext(fri.final_coeffs)
    out["fri_leaves"] = [_u64(v) for v in fri.query_leaves]
    out["fri_paths"] = [_u64(v) for v in fri.query_paths]
    out["pow_nonce"] = int(_u64(fri.pow_nonce).reshape(-1)[0])
    return out


def tampered(proof, field: str = "trace_rows_a"):
    """A copy of the proof with the lowest bit of one opened value
    flipped."""
    bad = copy.copy(proof)
    rows = getattr(proof, field).clone()
    rows[0, 0] ^= 1
    setattr(bad, field, rows)
    return bad
