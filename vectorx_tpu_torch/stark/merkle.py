"""Poseidon Merkle tree with caps — trace/FRI commitments of the prover.

A cap of height h is the set of 2^h subtree roots. Leaves are rows of a
(num_leaves, row_width) matrix; each leaf digest is the Poseidon sponge of
its row; internal nodes are the Poseidon 2-to-1 compression, one batched
permutation per level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..field import goldilocks as gl
from ..hashes import poseidon as ps

Digest = gl.Fp  # (..., 4)


@dataclass
class MerkleTree:
    """levels[0] = leaf digests (n, 4); levels[-1] = cap (2^cap_height, 4)."""
    levels: List[Digest]
    cap_height: int = 0

    @property
    def cap(self) -> Digest:
        return self.levels[-1]

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]


def hash_leaves(rows: gl.Fp) -> Digest:
    """(n, w) field-element rows -> (n, 4) leaf digests."""
    return ps.hash_many(rows)


def _levels_from_digests(digests: Digest, cap_height: int) -> List[Digest]:
    levels = [digests]
    while digests.shape[0] > (1 << cap_height):
        digests = ps.hash_two_to_one(digests[0::2], digests[1::2])
        levels.append(digests)
    return levels


def build(rows: gl.Fp, cap_height: int = 0) -> MerkleTree:
    n = rows.shape[0]
    if n & (n - 1) or (1 << cap_height) > n:
        raise ValueError(f"bad Merkle shape: {n} leaves, cap height {cap_height}")
    return MerkleTree(levels=_levels_from_digests(hash_leaves(rows), cap_height),
                      cap_height=cap_height)


def build_cols(cols: gl.Fp, cap_height: int = 0) -> MerkleTree:
    """Commit the ROWS of a column-major (w, n) matrix."""
    return build(cols.t(), cap_height)


def prove(tree: MerkleTree, index) -> Digest:
    """Sibling paths: an index tensor of shape S -> S + (depth, 4)."""
    idx = torch.as_tensor(index, device=tree.cap.device)
    sibs = []
    for level in tree.levels[:-1]:
        sibs.append(level[idx ^ 1])
        idx = idx >> 1
    return torch.stack(sibs, dim=-2)


def verify_batch(cap: Digest, indices: torch.Tensor, leaf_rows: gl.Fp,
                 paths: Digest) -> torch.Tensor:
    """(q,) indices, (q, w) rows, (q, depth, 4) paths -> (q,) bools; one
    batched Poseidon call per level."""
    digest = ps.hash_many(leaf_rows)                 # (q, 4)
    idx = indices
    for d in range(paths.shape[1]):
        sib = paths[:, d]
        is_right = ((idx & 1) == 1)[:, None]
        left = torch.where(is_right, sib, digest)
        right = torch.where(is_right, digest, sib)
        digest = ps.hash_two_to_one(left, right)
        idx = idx >> 1
    return torch.all(digest == cap[idx], dim=-1)


def verify(cap: Digest, index, leaf_row: gl.Fp, path: Digest) -> bool:
    """Recompute the root from one leaf row and its sibling path."""
    idx = torch.as_tensor([index], device=cap.device).reshape(1)
    return bool(verify_batch(cap, idx, leaf_row[None], path[None])[0])
