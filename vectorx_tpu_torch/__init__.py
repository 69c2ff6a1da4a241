"""vectorx_tpu_torch — the STARK prover of vectorx_tpu in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

Mirrors the JAX package's layout (which stays the reference):

- ``field``    — Goldilocks GF(p) / GF(p^2) on int64 tensors; GF(2^255 - 19)
                 and the scalars mod L as 16-bit limbs
- ``hashes``   — Poseidon (transcript and Merkle hash), batched SHA-256,
                 SHA-512 and variable-length Blake2b-256
- ``ops``      — CUDA kernels (``csrc/``) and their wrappers
- ``poly``     — NTT / LDE / barycentric evaluation
- ``stark``    — AIRs, Merkle commitments, FRI, prover/verifier (with the
                 LogUp range lookups and the RAM multiset), the statement
                 bundles, the hint runtime, value watching
- ``circuits`` — the SCALE codec (host and batched), size bounds, the
                 public commitments, batched Ed25519 verification, the
                 witness-level header_range and rotate programs, the ABI
- ``parallel`` — device meshes, the sharded NTT (the prover's NTT seam),
                 the header-subchain check on one device or sharded
                 over a mesh, processes on torch.distributed, the map
                 and reduce of proofs
- ``services`` — the CLI (``python -m vectorx_tpu_torch``; fixtures or
                 the live Avail node), the dummy programs, the
                 justification store (in memory, Redis), GRANDPA decoding
                 and finality proofs, the Avail RPC client, the indexer
                 (batched signature check on the device), the operator,
                 the contract model and its gateway, the events indexer
                 and the operator tools
- ``utils``    — Keccak-256, xxHash/twox128, PhaseTimer and the
                 torch.profiler hooks
- ``runtime``  — the ctypes loader of the native host library
                 (``native/vxnative.cpp``)
- ``convert``  — carries arrays and proofs to and from the JAX package

Entry points that create tensors take ``device=None`` and resolve it with
``default_device``: the current CUDA device, unless the caller names
another (``device="cpu"`` for the plain versions). Functions that take
tensors follow their inputs' device.
"""

import torch

__version__ = "0.4.0"


def default_device(device=None) -> torch.device:
    """The device an entry point works on: ``device`` if the caller names
    one, else the current CUDA device. Without a CUDA device ``None`` raises:
    the port never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vectorx_tpu_torch runs on a CUDA device and found none; pass "
            "device=\"cpu\" to run the plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
