"""Proof aggregation — the MapReduce reduce layer over STARK proofs.

VectorX compresses a MapReduce shard set by recursively verifying child
proofs inside reduce circuits until one proof remains. Here the reduce
node is a ``RecursionAir`` machine program that verifies N child proofs
IN-AIR and links their boundary publics (stark/recursion_air.py), so a
bundle of shard proofs collapses to ONE proof checked by
``verifier.verify``.

Chain semantics (the shape both statements need): each child claim has
``start`` and ``end`` public slots; adjacent children must satisfy
end_i == start_{i+1}; the aggregate claim is (start_0, end_{N-1}) — the
boundary-adjacency reduce of VectorX.

One reduce level (N-ary); a RecursionAir proof is itself recursable, so
a tree is reduce nodes over reduce nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..field import goldilocks as gl
from ..stark import recursion_air as ra


@dataclass(frozen=True)
class ChainLayout:
    """Which public slots of a child claim are the chain boundary."""
    start: Tuple[int, ...]
    end: Tuple[int, ...]


@dataclass
class Node:
    """One aggregation input/output: a proof plus its claim layout."""
    air: object
    proof: object
    publics: List          # ints or gl.Fp scalars
    log_n: int
    config: object
    layout: ChainLayout


def aggregate_chain(nodes: Sequence[Node], outer_config,
                    extra_expose: Sequence[Tuple[int, int]] = (),
                    device=None, stream=None) -> Node:
    """Reduce N chained child proofs to ONE proof, made on ``device`` (the
    current CUDA device unless named).

    Emits, inside a single RecursionAir program: the full verification of
    every child, equality links end_i == start_{i+1}, and outer publics
    (start_0 ‖ end_{N-1} ‖ extra_expose). Returns the aggregate Node whose
    layout is canonical (start slots first, end slots after). A single
    child is still wrapped in a reduce node, so callers always receive the
    canonical layout and a RecursionAir proof.
    """
    assert len(nodes) >= 1
    links = []
    for i in range(len(nodes) - 1):
        ea, sb = nodes[i].layout.end, nodes[i + 1].layout.start
        assert len(ea) == len(sb), "boundary arity mismatch"
        links += [(i, e, i + 1, s) for e, s in zip(ea, sb)]
    first, last = nodes[0], nodes[-1]
    expose = ([(0, i) for i in first.layout.start]
              + [(len(nodes) - 1, j) for j in last.layout.end]
              + list(extra_expose))
    children = [(n.air, n.proof, n.publics, n.log_n, n.config)
                for n in nodes]
    air, proof, publics = ra.prove_reduce(children, links, expose,
                                          outer_config, stream=stream,
                                          device=device)
    ns = len(first.layout.start)
    ne = len(last.layout.end)
    return Node(air=air, proof=proof, publics=publics,
                log_n=air.n_rows.bit_length() - 1, config=outer_config,
                layout=ChainLayout(start=tuple(range(ns)),
                                   end=tuple(range(ns, ns + ne))))


def aggregate_air_for(shapes, links, expose, device=None, stream=None):
    """Verifier-side reduce AIR (claim shapes only)."""
    return ra.reduce_air_for(shapes, links, expose, stream=stream,
                             device=device)


def verify_aggregate(node: Node, child_shapes, links, expose,
                     stream=None) -> bool:
    """Rebuild the reduce AIR from claim shapes and verify the aggregate
    proof with the standard verifier, on the proof's device."""
    from ..stark import verifier
    dev = node.proof.trace_cap.device
    air = ra.reduce_air_for(child_shapes, links, expose, stream=stream,
                            device=dev)
    pubs = [gl.to_fp(int(p), dev) for p in node.publics]
    return bool(verifier.verify(air, node.proof, pubs, node.log_n,
                                node.config))
