"""The port's aggregation layer (parallel/aggregate.py) and the reduce
program against the JAX package.

Two chained FibonacciAir(16) shards (B starts where A ends), rate 1, 2
queries, as tests/test_map_prove.py. The reduce node's program records the
same machine as the JAX package's (rows, K, schedule digest, constant
columns and trace, bit for bit); ``map_reduce_prove`` on the CPU gives ONE
proof that ``verify_aggregate`` accepts against the claim shapes, and
refuses under a claim shape with another link; ``aggregate_chain`` of one
node still wraps it in a reduce node with the canonical layout
(``aggregate_air_for`` rebuilds its schedule). The JAX package's reduce
machine of its own proofs of the two shards is recorded
(tests/reference_data/test_torch_aggregate.json, made by
tests/reference_data/record.py); the port's shard proofs equal them.
"""

import pytest
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.parallel import aggregate as agg
from vectorx_tpu_torch.parallel import map_prove
from vectorx_tpu_torch.stark import prover
from vectorx_tpu_torch.stark import recursion_air as ra
from vectorx_tpu_torch.stark.air import FibonacciAir

import reference_data as rd
from reference_data import inputs
from test_torch_recursion import _assert_same_machine, assert_same_payload

torch.set_num_threads(1)

N = inputs.AGG_N
LOG_N = 4
CFG = prover.StarkConfig(**inputs.REC_CFG)
AIR = FibonacciAir()
LAYOUT = agg.ChainLayout(start=(0,), end=(2,))
LINKS = inputs.AGG_LINKS
EXPOSE = inputs.AGG_EXPOSE
SHAPES = [(AIR, LOG_N, CFG, 3), (AIR, LOG_N, CFG, 3)]


def _shards():
    trace_a, pub_a = FibonacciAir.make_trace(N, device="cpu")
    a_last, b_last = (int(v) for v in gl.from_fp(trace_a[:, -1]))
    trace_b, pub_b = FibonacciAir.make_trace(N, a_last, b_last, device="cpu")
    return ([trace_a, trace_b],
            [[gl.to_fp(p, "cpu") for p in pu] for pu in (pub_a, pub_b)])


@pytest.fixture(scope="module")
def reduce_node():
    """ONE reduce proof of both shards (the heavy part of this module: its
    own phase under the time limit) -> (node, publics)."""
    traces, pubs = _shards()
    return map_prove.map_reduce_prove(AIR, traces, pubs, LAYOUT, CFG,
                                      devices=["cpu"]), pubs


def test_map_reduce_prove_verifies_and_refuses_other_claims(reduce_node):
    """ONE reduce proof of both shards: verify_aggregate accepts it against
    the claim shapes and refuses it under a claim whose link pins another
    pair of publics."""
    node, pubs = reduce_node
    assert node.layout == agg.ChainLayout(start=(0,), end=(1,))
    assert node.publics == [int(pubs[0][0]), int(pubs[1][2])]
    assert agg.verify_aggregate(node, SHAPES, LINKS, EXPOSE)
    assert not agg.verify_aggregate(node, SHAPES, [(0, 1, 1, 0)], EXPOSE)


def test_reduce_program_equals_reference():
    """The reduce node of the aggregate (links end_A == start_B, expose
    start_A ‖ end_B) records the JAX package's machine."""
    want = rd.load("test_torch_aggregate", inputs.test_torch_aggregate())
    traces, pubs = _shards()
    proofs = map_prove.prove_many(AIR, traces, pubs, CFG, ["cpu"])
    for proof, inner in zip(proofs, want["inner"]):
        assert_same_payload(proof, inner)
    children = [(AIR, p, pu, LOG_N, CFG) for p, pu in zip(proofs, pubs)]
    oair = ra.RecursionAir(ra.record_reduce(children, LINKS, EXPOSE))
    _assert_same_machine(oair, want["reduce"])
    vair = agg.aggregate_air_for(SHAPES, LINKS, EXPOSE, device="cpu")
    assert vair.schedule_digest() == oair.schedule_digest()


def test_single_node_is_wrapped_with_canonical_layout(monkeypatch):
    """One child still becomes a reduce node (start slots first, end slots
    after); the outer prove itself is left out here (map_reduce_prove's is
    above)."""
    traces, pubs = _shards()
    proof = map_prove.prove_many(AIR, traces[:1], pubs[:1], CFG, ["cpu"])[0]
    seen = {}

    def fake_prove_reduce(children, links, expose, outer_config, stream=None,
                          device=None):
        seen.update(children=children, links=links, expose=expose)
        air = ra.RecursionAir(ra.record_reduce(children, links, expose))
        return air, None, [ra._pub_ints(children[0][2])[i]
                           for _, i in expose]

    monkeypatch.setattr(ra, "prove_reduce", fake_prove_reduce)
    one = agg.Node(AIR, proof, pubs[0], LOG_N, CFG,
                   agg.ChainLayout(start=(0, 1), end=(2,)))
    out = agg.aggregate_chain([one], CFG, device="cpu")
    assert seen["links"] == [] and seen["expose"] == [(0, 0), (0, 1), (0, 2)]
    assert out.layout == agg.ChainLayout(start=(0, 1), end=(2,))
    assert out.publics == ra._pub_ints(pubs[0])
    assert isinstance(out.air, ra.RecursionAir)
