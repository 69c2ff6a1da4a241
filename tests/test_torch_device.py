"""The port's device default: the card unless the caller asks for the CPU.

Without a CUDA device ``default_device()`` and every entry point called
with ``device=None`` raise (the port never moves to the CPU on its own);
with ``device="cpu"`` the same calls run and give CPU tensors. Also: no
module of the port, and not chip_smoke.py, imports ``jax``, the JAX
package or ``cryptography`` (their sources are scanned; the card's
machine has no ``cryptography``).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import vectorx_tpu_torch as vt
from vectorx_tpu_torch import convert
from vectorx_tpu_torch.circuits import ed25519 as ed
from vectorx_tpu_torch.circuits import justification as just
from vectorx_tpu_torch.field import ext
from vectorx_tpu_torch.field import field25519 as fe
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.parallel.dryrun import dryrun_multichip
from vectorx_tpu_torch.parallel.mesh import make_mesh
from vectorx_tpu_torch.poly import domain as dom
from vectorx_tpu_torch.hashes import blake2b as hb2
from vectorx_tpu_torch.hashes import sha256 as s2
from vectorx_tpu_torch.hashes import sha512 as s5
from vectorx_tpu_torch.stark import air_blake2b as b2
from vectorx_tpu_torch.stark import air_header as ah
from vectorx_tpu_torch.stark import air_poseidon as apos
from vectorx_tpu_torch.stark import air_sha256 as sha
from vectorx_tpu_torch.stark import air_sha256_chain as chain
from vectorx_tpu_torch.stark import air_sha256_merkle as merkle
from vectorx_tpu_torch.stark import air_sha512 as a512
from vectorx_tpu_torch.stark import dsl, prover, serialize
from vectorx_tpu_torch.stark.air import (BaseVecAlgebra, ExtAlgebra,
                                         FibonacciAir)
from vectorx_tpu_torch.stark.challenger import Challenger

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HEADER = bytes(range(1, 101))
CONST_AIR = b2.Blake2bVarAir(max_chunks=1)
LO = np.arange(4, dtype=np.uint32)

# name -> (call taking a device, the tensor of its result)
ENTRY_POINTS = {
    "gl.to_fp": (lambda d: gl.to_fp([1, 2, 3], d), lambda r: r),
    "gl.zeros": (lambda d: gl.zeros((3,), d), lambda r: r),
    "gl.ones": (lambda d: gl.ones((3,), d), lambda r: r),
    "gl.full": (lambda d: gl.full((3,), 7, d), lambda r: r),
    "ext.zeros": (lambda d: ext.zeros((2,), d), lambda r: r[1]),
    "ext.ones": (lambda d: ext.ones((2,), d), lambda r: r[0]),
    "ext.to_fp2": (lambda d: ext.to_fp2([(1, 2)], d), lambda r: r[0]),
    "convert.fp_from_pairs": (lambda d: convert.fp_from_pairs(LO, LO, d),
                              lambda r: r),
    "domain_points": (lambda d: dom.domain_points(3, 7, d), lambda r: r),
    "vanishing_on_coset": (lambda d: dom.vanishing_on_coset(2, 1, device=d),
                           lambda r: r),
    "Challenger.new": (lambda d: Challenger.new(d), lambda r: r.state),
    "BaseVecAlgebra": (lambda d: BaseVecAlgebra((4,), d).one(), lambda r: r),
    "ExtAlgebra": (lambda d: ExtAlgebra(d).one(), lambda r: r[0]),
    "FibonacciAir.make_trace": (
        lambda d: FibonacciAir.make_trace(8, device=d), lambda r: r[0]),
    "Sha256CompressAir.make_trace": (
        lambda d: sha.Sha256CompressAir.make_trace(
            list(range(8)), list(range(16)), d), lambda r: r[0]),
    "Blake2bAir.make_trace": (
        lambda d: b2.Blake2bAir.make_trace(b"abc", d), lambda r: r[0]),
    "HeaderAir.make_trace": (
        lambda d: ah.HeaderAir(max_chunks=1).make_trace(HEADER, d),
        lambda r: r[0]),
    "PoseidonChainAir.make_trace": (
        lambda d: apos.PoseidonChainAir.make_trace(list(range(12)), 1, d),
        lambda r: r[0]),
    "ChainedSha256Air.make_trace": (
        lambda d: chain.ChainedSha256Air(1).make_trace([list(range(8))], 1, d),
        lambda r: r[0]),
    "MerkleSha256Air.make_trace": (
        lambda d: merkle.MerkleSha256Air(
            [list(range(8)), list(range(8))]).make_trace(d), lambda r: r[0]),
    "Sha512ChallengeAir.make_trace": (
        lambda d: a512.Sha512ChallengeAir([], bytes(53)).make_trace(d),
        lambda r: r[0]),
    "sha256_bytes": (
        lambda d: torch.from_numpy(s2.sha256_bytes([b"abc"], d).astype(np.int64)),
        lambda r: r),
    "sha512_bytes": (
        lambda d: torch.tensor(list(s5.sha512_bytes([b"abc"], d)[0])),
        lambda r: r),
    "field25519.zeros": (lambda d: fe.zeros((2,), d), lambda r: r),
    "field25519.const": (lambda d: fe.const((2,), 5, d), lambda r: r),
    "field25519.to_limbs": (lambda d: fe.to_limbs([3, 4], d), lambda r: r),
    "ed25519.identity": (lambda d: ed.identity((2,), d), lambda r: r.y),
    "ed25519.base_point": (lambda d: ed.base_point((2,), d), lambda r: r.x),
    "ed25519.compute_challenges": (
        lambda d: torch.from_numpy(ed.compute_challenges(
            [bytes(32)], [bytes(32)], b"m", d).astype(np.int64)),
        lambda r: r),
    "blake2b256_bytes": (
        lambda d: torch.tensor(list(hb2.blake2b256_bytes([b"abc"], 1, d)[0])),
        lambda r: r),
    "prepare_justification": (
        lambda d: just.prepare_justification(
            [bytes(32).hex()], [bytes(64).hex()], [False], 1, bytes(53), 2, d),
        lambda r: r.num_authorities),
    "constant_vk": (
        lambda d: prover.constant_vk(
            CONST_AIR, 7, prover.StarkConfig(rate_bits=1), d),
        lambda r: r[2]),
    "dsl.TraceWriter.finish": (
        lambda d: _trace_writer().finish(d), lambda r: r),
    "make_mesh": (
        lambda d: make_mesh(1, device=d),
        lambda r: r.put(torch.zeros(4, dtype=torch.int64))[0]),
    "dryrun_multichip": (lambda d: dryrun_multichip(2, d), lambda r: r["ntt"]),
}


def _trace_writer():
    b = dsl.AirBuilder()
    x = b.u8("x")
    w = dsl.TraceWriter(b, 4)
    w.set_uint(x, 0, 7)
    return w


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.default_device(None)


@pytest.mark.parametrize("asked", ["cpu", torch.device("cpu")])
def test_default_device_keeps_what_the_caller_names(asked, no_card):
    assert vt.default_device(asked) == torch.device("cpu")
    assert vt.default_device("cuda:1") == torch.device("cuda", 1)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_raises_on_default_device_without_a_card(name, no_card):
    call, _ = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        call(None)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name, no_card):
    call, tensor_of = ENTRY_POINTS[name]
    out = tensor_of(call("cpu"))
    assert out.device.type == "cpu" and out.dtype == torch.int64


def test_gamma_transcript_follows_the_named_device(no_card):
    publics = list(range(87))
    with pytest.raises(RuntimeError, match="CUDA"):
        ah.derive_gammas(publics)
    g1, g2 = ah.derive_gammas(publics, "cpu")
    assert 0 <= g1 < gl.MODULUS and 0 <= g2 < gl.MODULUS and g1 != g2


def test_deserialize_follows_the_named_device(no_card):
    cfg = prover.StarkConfig(rate_bits=1, num_queries=2, final_poly_len=2)
    like = serialize.empty_proof_like_shapes(FibonacciAir(), cfg, 4)
    data = serialize.serialize_proof(like)
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize.deserialize_proof(data, like)
    back = serialize.deserialize_proof(data, like, "cpu")
    assert back.trace_cap.device.type == "cpu"


def _imports(path: Path):
    """(module, level) of every import statement in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


PORT_SOURCES = sorted((ROOT / "vectorx_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    for module, level in _imports(path):
        if level:                       # relative: stays inside the port
            continue
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "vectorx_tpu",
                           "cryptography"), f"{path.name} imports {module}"
