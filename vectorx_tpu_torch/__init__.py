"""vectorx_tpu_torch — the STARK prover of vectorx_tpu in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

Mirrors the JAX package's layout (which stays the reference):

- ``field``    — Goldilocks GF(p) / GF(p^2) on int64 tensors
- ``hashes``   — Poseidon (transcript and Merkle hash)
- ``ops``      — CUDA kernels (``csrc/``) and their wrappers
- ``poly``     — NTT / LDE / barycentric evaluation
- ``stark``    — AIRs, Merkle commitments, FRI, prover/verifier
- ``circuits`` — the SCALE host codec
- ``convert``  — carries arrays and proofs to and from the JAX package
"""

__version__ = "0.1.0"
