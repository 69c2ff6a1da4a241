"""The port's multi-process tier (parallel/multihost.py) on gloo.

Two OS processes run ``python -m vectorx_tpu_torch.parallel.dcn_demo`` on
the CPU (``--device cpu --backend gloo``), each with a local mesh of 4
shards of the CPU, as the JAX package's tests/test_multihost.py runs
scripts/dcn_demo.py with 4 virtual CPU devices a process. Phase 1 alone:
the 16-header chain over (dcn=2, batch=4) prints ``DCN_DEMO_OK`` with the
root of the port's single-device check of the same chain. The full demo
also proves a FibonacciAir(16) shard in each process and reduces both in
process 0 (``DCN_MAP_OK``). In this process: a group of one on gloo, the
two-tier mesh over it, and the backend rule of ``init_distributed``.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from vectorx_tpu_torch.parallel import dcn_demo, multihost, subchain
from vectorx_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_device_root() -> str:
    headers, trusted = dcn_demo.demo_chain()
    buf, sizes = subchain.pack_headers(headers, dcn_demo.N_HEADERS,
                                       dcn_demo.SLOT_BYTES)
    res = subchain.verify_subchain(
        torch.from_numpy(buf), torch.from_numpy(sizes), dcn_demo.N_HEADERS,
        torch.frombuffer(bytearray(trusted), dtype=torch.uint8), 0)
    assert bool(res.links_ok) and bool(res.blocks_sequential)
    return dcn_demo.root_hex(res.state_root_words)


def _run_demo(extra, timeout_s):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vectorx_tpu_torch.parallel.dcn_demo",
         str(port), str(pid), *extra, "--device", "cpu", "--backend", "gloo"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for out in outs:
        assert "DCN_BACKEND gloo" in out, out
    root = outs[0].split("DCN_DEMO_OK", 1)[1].split()[0]
    assert root == _single_device_root()
    assert "DCN_DEMO_OK" not in outs[1]
    return outs


def test_two_process_chain_equals_one_device():
    _run_demo([], 120)


def test_two_process_demo_reduces_both_shards(tmp_path):
    outs = _run_demo([str(tmp_path)], 600)
    assert "DCN_MAP_OK" in outs[0], outs[0]
    assert sorted(os.listdir(tmp_path)) == ["reduce.done", "shard0.bin",
                                            "shard1.bin"]


def test_group_of_one_on_gloo_equals_one_device():
    assert not dist.is_initialized()
    backend = multihost.init_distributed(f"localhost:{_free_port()}", 1, 0,
                                         device="cpu")
    try:
        assert backend == "gloo"
        assert multihost.init_distributed("unused", 1, 0, "gloo") == "gloo"
        mesh = multihost.dcn_mesh(Mesh(["cpu"] * 4))
        assert mesh.shape == {"dcn": 1, "batch": 4} and mesh.size == 4
        ok, root = dcn_demo.phase_chain(mesh, torch.device("cpu"))
        assert ok and root == _single_device_root()
        x = torch.arange(16)
        assert torch.equal(mesh.gather(multihost.shard_headers(mesh).put(x)),
                           x)
    finally:
        dist.destroy_process_group()


def test_backend_follows_the_device_and_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.init_distributed("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="init_distributed"):
        multihost.dcn_mesh(Mesh(["cpu"]))
