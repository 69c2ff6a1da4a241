"""The port's aggregation layer (parallel/aggregate.py) and the reduce
program against the JAX package.

Two chained FibonacciAir(16) shards (B starts where A ends), rate 1, 2
queries, as tests/test_map_prove.py. The reduce node's program records the
same machine as the JAX package's (rows, K, schedule digest, constant
columns and trace, bit for bit); ``map_reduce_prove`` on the CPU gives ONE
proof that ``verify_aggregate`` accepts against the claim shapes, and
refuses under a claim shape with another link; ``aggregate_chain`` of one
node still wraps it in a reduce node with the canonical layout
(``aggregate_air_for`` rebuilds its schedule).
"""

import torch

from vectorx_tpu.stark import prover as jprover
from vectorx_tpu.stark import recursion_air as jra
from vectorx_tpu.stark.air import FibonacciAir as JFibonacciAir
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.parallel import aggregate as agg
from vectorx_tpu_torch.parallel import map_prove
from vectorx_tpu_torch.stark import prover
from vectorx_tpu_torch.stark import recursion_air as ra
from vectorx_tpu_torch.stark.air import FibonacciAir

from test_torch_recursion import _assert_same_machine, _to_jax

torch.set_num_threads(1)

N = 16
LOG_N = 4
CFG = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
JCFG = jprover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
AIR = FibonacciAir()
LAYOUT = agg.ChainLayout(start=(0,), end=(2,))
LINKS = [(0, 2, 1, 0)]
EXPOSE = [(0, 0), (1, 2)]
SHAPES = [(AIR, LOG_N, CFG, 3), (AIR, LOG_N, CFG, 3)]


def _shards():
    trace_a, pub_a = FibonacciAir.make_trace(N, device="cpu")
    a_last, b_last = (int(v) for v in gl.from_fp(trace_a[:, -1]))
    trace_b, pub_b = FibonacciAir.make_trace(N, a_last, b_last, device="cpu")
    return ([trace_a, trace_b],
            [[gl.to_fp(p, "cpu") for p in pu] for pu in (pub_a, pub_b)])


def test_map_reduce_prove_verifies_and_refuses_other_claims():
    """ONE reduce proof of both shards (the heavy part of this module, so
    in one test): verify_aggregate accepts it against the claim shapes and
    refuses it under a claim whose link pins another pair of publics."""
    traces, pubs = _shards()
    node = map_prove.map_reduce_prove(AIR, traces, pubs, LAYOUT, CFG,
                                      devices=["cpu"])
    assert node.layout == agg.ChainLayout(start=(0,), end=(1,))
    assert node.publics == [int(pubs[0][0]), int(pubs[1][2])]
    assert agg.verify_aggregate(node, SHAPES, LINKS, EXPOSE)
    assert not agg.verify_aggregate(node, SHAPES, [(0, 1, 1, 0)], EXPOSE)


def test_reduce_program_equals_reference():
    """The reduce node of the aggregate (links end_A == start_B, expose
    start_A ‖ end_B) records the JAX package's machine."""
    traces, pubs = _shards()
    proofs = map_prove.prove_many(AIR, traces, pubs, CFG, ["cpu"])
    children = [(AIR, p, pu, LOG_N, CFG) for p, pu in zip(proofs, pubs)]
    oair = ra.RecursionAir(ra.record_reduce(children, LINKS, EXPOSE))
    jchildren = [(JFibonacciAir(), _to_jax(p, JFibonacciAir(), LOG_N),
                  pu, LOG_N, JCFG) for p, pu in zip(proofs, pubs)]
    mb = jra.MachineBuilder()
    cl = [[mb.loadw(v) for v in ra._pub_ints(pu)]
          for (_, _, pu, _, _) in jchildren]
    for (ci, pi) in EXPOSE:
        pc = mb.pin_public(mb.vals[cl[ci][pi]])
        mb.eq_cells(pc, cl[ci][pi])
    for (ci, pi, cj, pj) in LINKS:
        mb.eq_cells(cl[ci][pi], cl[cj][pj])
    for (a, pr, pu, ln, cf), cc in zip(jchildren, cl):
        jra.record_stark_verify(mb, a, pr, cc, ln, cf)
    _assert_same_machine(oair, jra.RecursionAir(mb))
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
