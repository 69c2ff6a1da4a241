"""The port on the card: the CUDA Poseidon kernel and a prove through it.

Every test here is marked ``cuda`` and skips without a card (a CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.ops import poseidon_cuda
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import FibonacciAir

from oracle import P

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _states(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, P, (n, 12), dtype=np.uint64)
    s[0] = P - 1
    s[1] = 0
    s[2::7] = P - 1 - (np.arange(len(s[2::7]))[:, None] % 8).astype(np.uint64)
    return torch.from_numpy(np.ascontiguousarray(s).view(np.int64))


def test_kernel_matches_plain_on_card(card):
    x = _states(21, 4099).to(card)
    before = poseidon_cuda.launches
    got = poseidon_cuda.permute(x)
    assert poseidon_cuda.launches == before + 1
    assert torch.equal(got, ps.permute_plain(x))
    assert torch.equal(ps.permute(x), got)
    want = [ps.permute_ints([int(v) for v in row]) for row in gl.to_u64(x[:16])]
    assert gl.to_u64(got[:16]).tolist() == want


def test_kernel_wrapper_rejects_what_it_cannot_launch_on_card(card):
    x = _states(22, 8).to(card)
    with pytest.raises(TypeError):
        poseidon_cuda.permute(x.to(torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x[:, :8].contiguous())
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x.t().contiguous().t())


def test_fibonacci_proof_same_on_card_and_cpu(card):
    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
    trace, publics = FibonacciAir.make_trace(32)
    pubs = [gl.to_fp(p) for p in publics]
    on_cpu = prover.prove(FibonacciAir(), trace, pubs, cfg)
    before = poseidon_cuda.launches
    on_card = prover.prove(FibonacciAir(), trace.to(card),
                           [p.to(card) for p in pubs], cfg)
    assert poseidon_cuda.launches > before
    assert serialize.payload(on_card) == serialize.payload(on_cpu)
    assert verifier.verify(FibonacciAir(), on_card, [p.to(card) for p in pubs],
                           5, cfg)
