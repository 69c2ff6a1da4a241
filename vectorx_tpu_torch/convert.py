"""Carry field data between the JAX package's layout and the port's.

The JAX package stores a Goldilocks element as a pair of uint32 planes
(lo, hi); the port stores it as one int64 tensor (field/goldilocks.py).
The proof helpers walk a ``StarkProof`` in the leaf order of
``jax.tree_util.tree_flatten`` on the JAX package's ``StarkProof``: dataclass
fields in declaration order, ``None`` fields skipped, lists and tuples in
order, each Fp tensor standing for its two leaves (lo, hi). So a flat list
of (lo, hi) pairs rebuilds a JAX proof with ``tree_unflatten`` and back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from . import default_device

Planes = Tuple[np.ndarray, np.ndarray]


def fp_from_pairs(lo, hi, device=None) -> torch.Tensor:
    """uint32 (lo, hi) planes -> int64 tensor (on the current CUDA device
    unless ``device`` names another)."""
    v = (np.asarray(lo, dtype=np.uint64)
         | (np.asarray(hi, dtype=np.uint64) << np.uint64(32)))
    # ascontiguousarray makes a 0-d array 1-d: keep the leaf's own shape
    return torch.from_numpy(
        np.ascontiguousarray(v).view(np.int64).reshape(v.shape)).to(
        default_device(device))


def fp_to_pairs(x: torch.Tensor) -> Planes:
    """int64 tensor -> uint32 (lo, hi) planes."""
    v = x.detach().cpu().contiguous().numpy().view(np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def fp2_from_pairs(x, device=None):
    """((re_lo, re_hi), (im_lo, im_hi)) -> (re, im) tensors."""
    return fp_from_pairs(*x[0], device), fp_from_pairs(*x[1], device)


def fp2_to_pairs(x) -> Tuple[Planes, Planes]:
    return fp_to_pairs(x[0]), fp_to_pairs(x[1])


def tensor_leaves(obj) -> List[torch.Tensor]:
    """The Fp tensors of a proof (dataclasses, lists, tuples), in order."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in tensor_leaves(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [t for item in obj for t in tensor_leaves(item)]
    raise TypeError(f"unexpected proof node {type(obj).__name__}")


def structure(obj) -> str:
    """A tag of the proof's structure: field names, None-ness and shapes."""
    if obj is None:
        return "None"
    if isinstance(obj, torch.Tensor):
        return "T" + "x".join(map(str, obj.shape))
    if dataclasses.is_dataclass(obj):
        return type(obj).__name__ + "{" + ",".join(
            f"{f.name}:{structure(getattr(obj, f.name))}"
            for f in dataclasses.fields(obj)) + "}"
    return ("[" if isinstance(obj, list) else "(") + ",".join(
        structure(x) for x in obj) + ("]" if isinstance(obj, list) else ")")


def _rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _rebuild(getattr(like, f.name), it)
                             for f in dataclasses.fields(like)})
    return type(like)(_rebuild(x, it) for x in like)


def proof_to_pairs(proof) -> List[Planes]:
    """Port proof -> [(lo, hi), ...] in JAX flatten order (flatten the
    pairs once more for the JAX leaf list)."""
    return [fp_to_pairs(t) for t in tensor_leaves(proof)]


def proof_from_pairs(pairs, like, device=None):
    """[(lo, hi), ...] in JAX flatten order -> a port proof shaped like
    ``like`` (a port proof or serialize.empty_proof_like_shapes)."""
    tensors = [fp_from_pairs(lo, hi, device) for lo, hi in pairs]
    n_like = len(tensor_leaves(like))
    if len(tensors) != n_like:
        raise ValueError(f"{len(tensors)} leaves for a proof of {n_like}")
    return _rebuild(like, iter(tensors))
