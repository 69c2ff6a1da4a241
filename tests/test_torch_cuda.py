"""The port on the card: the CUDA Poseidon kernels (permute, duplex,
sponge_rows) against their plain versions, proves through them (the
recursion machine's and the DSL's among them), and the production Ed25519
shard (B = 13, 32 signed lanes: the witness on the card equal to the
CPU's, one proof verified and a tampered one rejected).

Every test here is marked ``cuda`` and skips without a card (a CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import vectorx_tpu_torch as vt
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hashes import poseidon as ps
from vectorx_tpu_torch.ops import poseidon_cuda
from vectorx_tpu_torch.stark import prover, serialize, verifier
from vectorx_tpu_torch.stark.air import FibonacciAir
from vectorx_tpu_torch.stark.air_ed25519 import Ed25519VerifyAir
from vectorx_tpu_torch.stark.challenger import Challenger

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
    s[1:2] = 0
    s[2::7] = P - 1 - (np.arange(len(s[2::7]))[:, None] % 8).astype(np.uint64)
    return torch.from_numpy(np.ascontiguousarray(s).view(np.int64))


def test_default_device_is_the_card(card):
    assert vt.default_device() == torch.device("cuda", torch.cuda.current_device())
    assert gl.zeros((3,)).is_cuda and Challenger.new().state.is_cuda
    assert vt.default_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 28, 33, 4099, 20000])
def test_kernel_matches_plain_on_card(card, n):
    """Batches on both sides of the dispatch between the cooperative and
    the thread-per-state kernel."""
    x = _states(21, n).to(card)
    before = poseidon_cuda.launches["permute"]
    got = poseidon_cuda.permute(x)
    assert poseidon_cuda.launches["permute"] == before + 1
    assert torch.equal(got, ps.permute_plain(x))
    assert torch.equal(ps.permute(x), got)
    for coop in (False, True):
        assert torch.equal(poseidon_cuda._permute(x, coop), got)
    rows = min(n, 16)
    want = [ps.permute_ints([int(v) for v in row]) for row in gl.to_u64(x[:rows])]
    assert gl.to_u64(got[:rows]).tolist() == want


@pytest.mark.parametrize("tail", [0, 1, 7])
@pytest.mark.parametrize("chunks", [0, 1, 2, 7, 100])
def test_duplex_matches_plain_on_card(card, chunks, tail):
    flat = _states(31, 80).reshape(-1)
    state = flat[:12].to(card)
    data = flat[12:12 + chunks * 8 + tail].to(card)
    for flush, n_squeeze in ((False, 0), (True, 0), (True, 1), (True, 9),
                             (False, 28)):
        before = poseidon_cuda.launches["duplex"]
        got = ps.duplex(state, data, flush, n_squeeze)
        want = ps.duplex_plain(state, data, flush, n_squeeze)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        runs = chunks + (1 if flush and tail else 0) + n_squeeze
        assert poseidon_cuda.launches["duplex"] == before + (1 if runs else 0)


@pytest.mark.parametrize("n", [1, 28, 5000])
@pytest.mark.parametrize("width", [0, 4, 8, 9, 135])
def test_sponge_rows_matches_plain_on_card(card, width, n):
    rng = np.random.default_rng(width + n)
    rows = rng.integers(0, P, (n, width), dtype=np.uint64)
    row_major = torch.from_numpy(rows.view(np.int64)).to(card)
    col_major = row_major.t().contiguous().t()        # (n, w) view of (w, n)
    want = ps.hash_many_plain(row_major)
    for x in (row_major, col_major):
        before = poseidon_cuda.launches["sponge_rows"]
        assert torch.equal(ps.hash_many(x), want)
        assert poseidon_cuda.launches["sponge_rows"] == before + 1
        for coop in (False, True):
            assert torch.equal(poseidon_cuda._sponge_rows(x, coop), want)
    if width:
        assert torch.equal(ps.hash_many(row_major.reshape(n, 1, width)),
                           want.reshape(n, 1, 4))


@pytest.mark.parametrize("width,n", [(314, 524288), (368, 262144),
                                     (685, 32768), (82, 32768), (10, 524288),
                                     (48, 262144), (75, 32768), (3336, 32768),
                                     (3188, 32768), (30, 32768), (803, 65536),
                                     (188, 65536)])
def test_sponge_rows_at_statement_shapes_on_card(card, width, n):
    """The column-major matrices the statement proofs commit (trace, aux,
    constants): the whole matrix through the kernel, 1024 seeded rows (first
    and last included) through the plain sponge; and the 84 query rows of a
    42-query verify in full."""
    gen = torch.Generator(device=card).manual_seed(width)
    cols = ((torch.randint(0, (1 << 32) - 1, (width, n), generator=gen,
                           device=card) << 32)
            | torch.randint(0, 1 << 32, (width, n), generator=gen, device=card))
    cols[:, 0] = gl.P_I64 - 1
    cols[:, -1] = 0
    idx = torch.cat([torch.tensor([0, n - 1], device=card),
                     torch.randint(0, n, (1022,), generator=gen, device=card)])
    got = ps.hash_many(cols.t())
    assert got.shape == (n, 4)
    assert torch.equal(got[idx], ps.hash_many_plain(cols[:, idx].t().contiguous()))
    few = cols[:, :84].t().contiguous()
    assert torch.equal(ps.hash_many(few), ps.hash_many_plain(few))


@pytest.mark.parametrize("n", [42, 84, 262144])
def test_permute_at_statement_shapes_on_card(card, n):
    """The verifier's 42- and 84-row paths and the first tree level under
    524288 leaves."""
    x = _states(23, n).to(card)
    got = poseidon_cuda.permute(x)
    rows = slice(0, None) if n < 1000 else slice(n - 512, n)
    assert torch.equal(got[rows], ps.permute_plain(x[rows]))
    assert torch.equal(got[:64], ps.permute_plain(x[:64]))


def test_lookup_proof_same_on_card_and_cpu(card):
    """The LogUp aux phase (prefix sums, multiplicities, aux commit)."""
    from vectorx_tpu_torch.stark.air import Air

    class RangeAir(Air):
        num_cols = 2
        num_publics = 1

        def lookup_range_columns(self):
            return [0, 1]

        def first_row(self, alg, local, publics, consts=()):
            return [alg.sub(local[0], alg.lift(publics[0]))]

    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4)
    vals = np.random.default_rng(11).integers(0, 64, (2, 64), dtype=np.uint64)
    proofs = [prover.prove(RangeAir(), gl.to_fp(vals, d),
                           [gl.to_fp(int(vals[0, 0]), d)], cfg)
              for d in ("cpu", card)]
    assert serialize.payload(proofs[0]) == serialize.payload(proofs[1])
    assert verifier.verify(RangeAir(), proofs[1],
                           [gl.to_fp(int(vals[0, 0]), card)], 6, cfg)


def test_kernel_wrapper_rejects_what_it_cannot_launch_on_card(card):
    x = _states(22, 8).to(card)
    with pytest.raises(TypeError):
        poseidon_cuda.permute(x.to(torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x[:, :8].contiguous())
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x.t().contiguous().t())
    state, data = x[0], x[1:].reshape(-1)
    with pytest.raises(TypeError):
        poseidon_cuda.duplex(state.to(torch.int32), data, False, 0)
    with pytest.raises(ValueError):
        poseidon_cuda.duplex(state.cpu(), data, False, 0)      # a CPU tensor
    with pytest.raises(ValueError):
        poseidon_cuda.duplex(state, data.cpu(), False, 0)
    with pytest.raises(ValueError):
        poseidon_cuda.duplex(x[:, 0], data, False, 0)          # wrong shape
    with pytest.raises(ValueError):
        poseidon_cuda.duplex(state, data[::2], False, 0)       # strided data
    with pytest.raises(ValueError):
        poseidon_cuda.duplex(state, data, True, -1)
    with pytest.raises(TypeError):
        poseidon_cuda.sponge_rows(x.to(torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.sponge_rows(x.cpu())
    with pytest.raises(ValueError):
        poseidon_cuda.sponge_rows(x.reshape(2, 4, 12))         # not a matrix


def test_fibonacci_proof_same_on_card_and_cpu(card):
    cfg = prover.StarkConfig(rate_bits=2, num_queries=6, final_poly_len=4,
                             pow_bits=8)
    trace, publics = FibonacciAir.make_trace(32, device="cpu")
    pubs = [gl.to_fp(p, "cpu") for p in publics]
    on_cpu = prover.prove(FibonacciAir(), trace, pubs, cfg)
    before = dict(poseidon_cuda.launches)
    on_card = prover.prove(FibonacciAir(), trace.to(card),
                           [p.to(card) for p in pubs], cfg)
    assert all(poseidon_cuda.launches[k] > before[k] for k in before)
    assert serialize.payload(on_card) == serialize.payload(on_cpu)
    assert verifier.verify(FibonacciAir(), on_card, [p.to(card) for p in pubs],
                           5, cfg)


def _chip_smoke():
    """chip_smoke.py, for its signer (RFC 8032 on Python ints)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recursion_small_same_on_card_and_cpu(card):
    """chip_smoke.py's recursion-small proofs (FibonacciAir(8) recursed:
    prove_recursive plain and streamed, a two-child reduce with links and
    expose, map_reduce_prove over two shards, the level-1 proof of the
    two-level case) on the card and on the CPU: identical payloads, and the
    same level-2 recording."""
    smoke = _chip_smoke()
    on_card, _, (_, digest_card) = smoke.recursion_small(card)
    on_cpu, _, (_, digest_cpu) = smoke.recursion_small(torch.device("cpu"))
    assert list(on_card) == ["recursive", "streamed", "reduce", "map_reduce",
                             "level1"]
    for name, payload in on_card.items():
        assert payload == on_cpu[name], name
    assert digest_card == digest_cpu


def test_dsl_small_same_on_card_and_cpu(card):
    """chip_smoke.py's dsl-small proofs (the DSL's Poseidon chain AIR and
    the GF(2^255-19) gadgets' fp-ops AIR) on the card and on the CPU: each
    verified, identical payloads; the CPU side refuses both tampered
    publics."""
    smoke = _chip_smoke()
    on_card, _ = smoke.dsl_small(card, tamper=())
    on_cpu, _ = smoke.dsl_small(torch.device("cpu"))
    assert list(on_card) == list(smoke.DSL_PROOFS)
    for name, payload in on_card.items():
        assert payload == on_cpu[name], name


@pytest.fixture(scope="module")
def ed25519_shard():
    """Ed25519VerifyAir(B=13) over 32 lanes signed by 32 seeded keys."""
    smoke = _chip_smoke()
    message = smoke.precommit(np.random.default_rng(24))
    lanes = smoke.signed_lanes(np.random.default_rng(25), 32, message)[2]
    return Ed25519VerifyAir(lanes, B=13), smoke.STATEMENT_CFG


def test_ed25519_witness_same_on_card_and_cpu(card, ed25519_shard):
    air = ed25519_shard[0]
    on_card, publics = air.make_trace_vec(card)
    on_cpu, cpu_publics = air.make_trace_vec("cpu")
    assert on_card.is_cuda and on_card.shape == (3336, 8192)
    assert torch.equal(on_card.cpu(), on_cpu) and publics == cpu_publics


def test_ed25519_shard_proves_and_verifies_on_card(card, ed25519_shard):
    air, cfg = ed25519_shard
    trace, publics = air.make_trace_vec(card)
    pubs = [gl.to_fp(p, card) for p in publics]
    proof = prover.prove(air, trace, pubs, cfg)
    assert prover.total_aux_cols(air) == 3188
    assert verifier.verify(air, proof, pubs, 13, cfg)
    bad = proof.aux_rows_a.clone()
    bad[0, 0] ^= 1
    assert not verifier.verify(air, dataclasses.replace(proof, aux_rows_a=bad),
                               pubs, 13, cfg)


def test_prove_sigs_and_verify_sigs_on_card(card, ed25519_shard):
    """Two B = 8 shards of one lane each: proved on the card, verified, and
    a shard with a wrong challenge rejected."""
    from vectorx_tpu_torch.stark import ed25519_prove
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=4)
    lanes = ed25519_shard[0].sigs[:2]
    shards = ed25519_prove.prove_sigs(lanes, 8, cfg, device=card)
    assert len(shards) == 2 and shards[0][1].trace_cap.is_cuda
    assert ed25519_prove.verify_sigs(shards, cfg)
    air, proof, publics = shards[1]
    a, r, s, h = air.sigs[0]
    forged = (Ed25519VerifyAir([(a, r, s, (h + 1) % (1 << 252))], B=8),
              proof, publics)
    assert not ed25519_prove.verify_sigs([shards[0], forged], cfg)


# -- the witness-level programs' torch ops on the card ------------------------

def _limbs(seed, n):
    from vectorx_tpu_torch.field import field25519 as fe
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n - 4)]
    vals += [0, fe.P25519 - 1, fe.P25519, (1 << 256) - 1]
    return torch.tensor([fe.int_limbs(v) for v in vals])


@pytest.mark.parametrize("name", ["mul", "sub", "pow_p58"])
def test_field25519_on_card_equals_cpu(card, name):
    from vectorx_tpu_torch.field import field25519 as fe
    a, b = _limbs(81, 600), _limbs(82, 600)
    args = (a,) if name == "pow_p58" else (a, b)
    on_card = getattr(fe, name)(*(x.to(card) for x in args))
    assert on_card.is_cuda
    assert torch.equal(on_card.cpu(), getattr(fe, name)(*args))


def test_blake2b_256_slots_of_280_chunks_on_card_equals_cpu(card):
    import hashlib
    from vectorx_tpu_torch.hashes import blake2b as b2
    from vectorx_tpu_torch.parallel import subchain
    rng = np.random.default_rng(83)
    sizes = rng.integers(0, 280 * 128 + 1, 256)
    sizes[:4] = (0, 1, 1990, 280 * 128)
    buf = np.zeros((256, 280 * 128), np.uint8)
    for i, n in enumerate(sizes):
        buf[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    x, n = torch.from_numpy(buf), torch.from_numpy(sizes)
    on_card = subchain.hash_headers(x.to(card), n.to(card))
    assert torch.equal(on_card.cpu(), subchain.hash_headers(x, n))
    for i in (0, 1, 2, 3, 100):
        assert bytes(on_card[i].cpu().numpy()) == hashlib.blake2b(
            buf[i, :sizes[i]].tobytes(), digest_size=32).digest()
    lo, hi = (torch.from_numpy(a.astype(np.int64)) for a in b2.pack_message(
        buf[2, :1990].tobytes(), 280)[:2])
    planes = b2.blake2b256_variable(lo[None].to(card), hi[None].to(card),
                                    torch.tensor([1990], device=card))
    assert bytes(subchain._digest_planes_to_bytes32(*planes)[0].cpu().numpy()) \
        == bytes(on_card[2].cpu().numpy())


def test_verify_batch_300_lanes_on_card_equals_cpu(card):
    """240 signed lanes, 60 disabled, one forged: the card's flags equal
    the CPU's."""
    from vectorx_tpu_torch.circuits import ed25519 as ed
    smoke = _chip_smoke()
    message = smoke.precommit(np.random.default_rng(84))
    pubs, sigs = smoke.authority_set(np.random.default_rng(85), message, 300,
                                     240)
    sigs[7] = sigs[7][:40] + bytes([sigs[7][40] ^ 1]) + sigs[7][41:]
    pk = torch.tensor([list(p) for p in pubs], dtype=torch.uint8)
    sg = torch.tensor([list(s) for s in sigs], dtype=torch.uint8)
    ch = torch.from_numpy(ed.compute_challenges(
        [s[:32] for s in sigs], pubs, message, card))
    enabled = torch.arange(300) < 240
    args = (pk, sg[:, :32], sg[:, 32:], ch, enabled)
    on_card = ed.verify_batch(*(a.to(card) for a in args))
    on_cpu = ed.verify_batch(*args)
    assert torch.equal(on_card.cpu(), on_cpu)
    assert on_cpu.sum() == 299 and not on_cpu[7]


def test_out_of_range_window_reads_the_fill_on_card(card):
    """The record window of a short set runs past the buffer: on the card
    the gather neither raises nor trips a device assert, and reads 255."""
    from vectorx_tpu_torch.circuits import rotate as rot
    arr = torch.arange(200, dtype=torch.uint8, device=card)[None]
    got = rot._window(arr, torch.tensor([150], device=card), 12004)
    torch.cuda.synchronize()
    assert torch.equal(got[0, :50].cpu(), torch.arange(150, 200, dtype=torch.uint8))
    assert bool((got[0, 50:] == 255).all())
    low = rot._window(arr, torch.tensor([-210], device=card), 20)
    assert low[0, :10].tolist() == [255] * 10 and low[0, 10:].tolist() == list(range(10))


def test_dryrun_multichip_on_a_mesh_of_the_card(card):
    """The sharded subchain, NTT and sharded-NTT prove on 4 shards of the
    card (dryrun_multichip raises if a phase fails)."""
    from vectorx_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4, card)
    assert out["ntt"].device == card and bool(out["subchain"].links_ok)


@pytest.mark.parametrize("log_n", [11, 14])
def test_sharded_ntt_on_the_card_equals_cpu(card, log_n):
    """The [collective-prove] transform sizes, 4 shards of the card."""
    from vectorx_tpu_torch.parallel import ntt_dist
    from vectorx_tpu_torch.parallel.mesh import Mesh
    from vectorx_tpu_torch.poly import ntt as pntt
    rng = np.random.default_rng(log_n)
    x = torch.from_numpy(rng.integers(0, P, (3, 1 << log_n), dtype=np.uint64)
                         .view(np.int64))
    mesh = Mesh([card] * 4)
    for inverse in (False, True):
        got = ntt_dist.ntt_sharded(x.to(card), mesh, inverse=inverse)
        assert torch.equal(got.cpu(), pntt.ntt(x, inverse))
