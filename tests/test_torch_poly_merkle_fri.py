"""Port vs reference: NTT/LDE, barycentric evaluation, the Challenger,
Poseidon Merkle trees and the FRI fold and grind (exact equality)."""

import numpy as np
import pytest
import torch

from vectorx_tpu.field import ext as jext
from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.poly import domain as jdom
from vectorx_tpu.poly import ntt as jntt
from vectorx_tpu.stark import fri as jfri
from vectorx_tpu.stark import merkle as jmerkle
from vectorx_tpu.stark.challenger import Challenger as JChallenger
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.poly import domain as dom
from vectorx_tpu_torch.poly import ntt
from vectorx_tpu_torch.stark import fri, merkle
from vectorx_tpu_torch.stark.challenger import Challenger

from oracle import P, ntt_naive

torch.set_num_threads(1)


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _port(x: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _jax(x: np.ndarray):
    return jgl.to_fp(x.astype(object))


def _u64(j):
    return (np.asarray(j[0], np.uint64) | (np.asarray(j[1], np.uint64) << np.uint64(32)))


def _same(port, j):
    return np.array_equal(gl.to_u64(port), _u64(j))


def _same_ext(port, j):
    return _same(port[0], j[0]) and _same(port[1], j[1])


# -- NTT / LDE ---------------------------------------------------------------

@pytest.mark.parametrize("log_n", [0, 1, 3, 6])
def test_ntt_matches_naive_and_butterfly(log_n):
    x = _rand(log_n, (2, 1 << log_n))
    got = ntt.ntt(_port(x))
    root = gl.primitive_root_of_unity(log_n)
    assert [int(v) for v in gl.from_fp(got[0])] == ntt_naive(
        [int(v) for v in x[0]], root)
    assert _same(got, jntt._ntt_butterfly(_jax(x)))
    assert _same(ntt.intt(_port(x)), jntt._ntt_butterfly(_jax(x), inverse=True))
    assert np.array_equal(gl.to_u64(ntt.intt(got)), x)


@pytest.mark.parametrize("rate_bits", [1, 3])
def test_coset_lde_and_coset_intt_match_reference(rate_bits):
    x = _rand(10 + rate_bits, (3, 16))
    lde = ntt.coset_lde(_port(x), rate_bits)
    assert lde.shape == (3, 16 << rate_bits)
    assert _same(lde, jntt.coset_lde(_jax(x), rate_bits))
    shift = 7
    assert _same(ntt.coset_intt(lde, shift),
                 jntt.coset_intt(jntt.coset_lde(_jax(x), rate_bits), shift))
    c = _rand(20, (2, 8))
    assert _same(ntt.coeffs_to_coset_evals(_port(c), 2),
                 jntt.coeffs_to_coset_evals(_jax(c), 2))


def test_domain_points_and_vanishing_match_reference():
    assert _same(dom.domain_points(5, 7, "cpu"), jdom.domain_points(5, 7))
    assert _same(dom.vanishing_on_coset(4, 2, device="cpu"), jdom.vanishing_on_coset(4, 2))


def test_barycentric_eval_matches_reference():
    evals = _rand(30, (5, 32))
    zeta = tuple(int(v) for v in _rand(31, 2))
    z_port = (gl.to_fp(zeta[0], "cpu"), gl.to_fp(zeta[1], "cpu"))
    z_jax = (jgl.to_fp(zeta[0]), jgl.to_fp(zeta[1]))
    for shift in (1, 7):
        got = dom.barycentric_eval(_port(evals), z_port, 5, shift)
        want = jdom.barycentric_eval(_jax(evals), z_jax, 5, shift)
        assert _same_ext(got, want)


# -- Challenger ----------------------------------------------------------------

def test_challenger_sequence_matches_reference():
    """Observations of 3, 13 and 5 elements leave pending remainders; the
    squeezes, extension squeezes and index draws must agree."""
    port, ref = Challenger.new("cpu"), JChallenger.new()
    outs = []
    for step, k in enumerate((3, 13, 5)):
        v = _rand(40 + step, k)
        port.observe(_port(v))
        ref.observe(_jax(v))
        assert port.pending.shape[0] == len(ref.pending)
        outs.append((port.squeeze(3), ref.squeeze(3)))
    d = _rand(50, (2, 4))
    port.observe_digests(_port(d))
    ref.observe_digests(_jax(d))
    for got, want in outs:
        assert _same(got, want)
    assert _same_ext(port.squeeze_ext(2), ref.squeeze_ext(2))
    assert np.array_equal(port.squeeze_indices(9, 10).numpy(),
                          np.asarray(ref.squeeze_indices(9, 10)))
    assert _same(port.state, ref.state)


# -- Merkle --------------------------------------------------------------------

@pytest.mark.parametrize("cap_height", [0, 2])
def test_merkle_caps_and_paths_match_reference(cap_height):
    cols = _rand(60, (9, 16))                      # column-major (w, n)
    tree = merkle.build_cols(_port(cols), cap_height)
    jtree = jmerkle.build(_jax(cols.T), cap_height)
    assert len(tree.levels) == len(jtree.levels)
    for a, b in zip(tree.levels, jtree.levels):
        assert _same(a, b)
    idx = torch.tensor([0, 5, 15])
    paths = merkle.prove(tree, idx)
    for i, ix in enumerate(idx.tolist()):
        assert _same(paths[i], jmerkle.prove(jtree, ix))
    rows = _port(cols.T[idx.numpy()])
    assert bool(torch.all(merkle.verify_batch(tree.cap, idx, rows, paths)))
    assert merkle.verify(tree.cap, 5, rows[1], paths[1])
    bad = rows.clone()
    bad[1, 0] ^= 1
    assert merkle.verify_batch(tree.cap, idx, bad, paths).tolist() == [True, False, True]


# -- FRI -----------------------------------------------------------------------

def test_fri_fold_matches_reference():
    cw = (_rand(70, 32), _rand(71, 32))
    beta = tuple(int(v) for v in _rand(72, 2))
    got = fri.fold((_port(cw[0]), _port(cw[1])),
                   (gl.to_fp(beta[0], "cpu"), gl.to_fp(beta[1], "cpu")), 6, 1)
    want = jfri.fold((_jax(cw[0]), _jax(cw[1])),
                     (jgl.to_fp(beta[0]), jgl.to_fp(beta[1])), 6, 1)
    assert _same_ext(got, want)
    leaves = fri._pack_leaves((_port(cw[0]), _port(cw[1])))
    assert _same(leaves, jfri._pack_leaves((_jax(cw[0]), _jax(cw[1]))))


def test_grind_returns_the_lowest_nonce_like_reference():
    v = _rand(80, 11)
    port, ref = Challenger.new("cpu"), JChallenger.new()
    port.observe(_port(v))
    ref.observe(_jax(v))
    nonce = fri._grind_nonce(port, 8)
    jnonce = jfri._grind_nonce(ref, 8)
    assert int(nonce) == int(jnonce[0]) and int(jnonce[1]) == 0
    # lowest: no smaller nonce passes the check
    from vectorx_tpu_torch.hashes import poseidon as ps
    states = port.state.expand(int(nonce) + 1, 12).clone()
    states[:, 0] = torch.arange(int(nonce) + 1)
    ok = (ps.permute(states)[:, 0] & 0xFF) == 0
    assert ok.nonzero()[0, 0].item() == int(nonce)


@pytest.mark.parametrize("pow_bits", [0, 4])
def test_fri_prove_verify_round_trip_and_reject(pow_bits):
    """A low-degree codeword proves and verifies; a tampered leaf fails.
    With grinding, the 4 final coefficients leave a pending remainder that
    the grind absorbs before the nonce: the verifier must do the same."""
    cfg = fri.FriConfig(rate_bits=2, num_queries=4, final_poly_len=2,
                        pow_bits=pow_bits)
    coeffs = _rand(90, (2, 8))
    cw = (ntt.coeffs_to_coset_evals(_port(coeffs[0]), 2),
          ntt.coeffs_to_coset_evals(_port(coeffs[1]), 2))
    proof, idx = fri.prove(cw, Challenger.new("cpu"), cfg)
    ok, vidx, _ = fri.verify(proof, 5, Challenger.new("cpu"), cfg)
    assert bool(ok) and torch.equal(vidx, idx)
    proof.query_leaves[1] = proof.query_leaves[1].clone()
    proof.query_leaves[1][0, 0] ^= 1
    assert not bool(fri.verify(proof, 5, Challenger.new("cpu"), cfg)[0])
