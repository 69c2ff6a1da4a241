"""Proof serialization: ``MAGIC | len | JSON header | payload``.

The payload is the concatenation of each Fp leaf's uint32 lo plane then hi
plane, little-endian, in the JAX package's pytree flatten order — byte for
byte the payload of ``vectorx_tpu.stark.serialize.serialize_proof`` for the
same proof. The header differs: the JAX package embeds its own pytree
repr, the port a structure tag of its own (convert.structure).
"""

from __future__ import annotations

import json
from dataclasses import asdict

import numpy as np
import torch

from .. import convert
from . import fri, prover

MAGIC = b"VXTP"
VERSION = 1


def payload(proof) -> bytes:
    return b"".join(lo.tobytes() + hi.tobytes()
                    for lo, hi in convert.proof_to_pairs(proof))


def serialize_proof(proof) -> bytes:
    leaves = convert.tensor_leaves(proof)
    header = json.dumps({
        "version": VERSION,
        "structure": convert.structure(proof),
        "leaves": [{"shape": list(t.shape), "dtype": "uint32"}
                   for t in leaves for _ in range(2)],
    }).encode()
    return MAGIC + len(header).to_bytes(4, "little") + header + payload(proof)


def split_payload(data: bytes) -> bytes:
    """The payload of a serialized proof (either package's)."""
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    hlen = int.from_bytes(data[4:8], "little")
    return data[8 + hlen:]


def deserialize_proof(data: bytes, like, device=None):
    """Reconstruct a proof with the same structure as `like`."""
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    hlen = int.from_bytes(data[4:8], "little")
    header = json.loads(data[8:8 + hlen].decode())
    if header["version"] != VERSION:
        raise ValueError(f"proof version {header['version']}")
    if header["structure"] != convert.structure(like):
        raise ValueError("proof structure mismatch")
    off = 8 + hlen
    planes = []
    for meta in header["leaves"]:
        count = int(np.prod(meta["shape"])) if meta["shape"] else 1
        planes.append(np.frombuffer(data[off:off + 4 * count], dtype="<u4")
                      .reshape(meta["shape"]))
        off += 4 * count
    if off != len(data):
        raise ValueError("trailing bytes")
    pairs = list(zip(planes[0::2], planes[1::2]))
    return convert.proof_from_pairs(pairs, like, device)


def serialize_config(config) -> bytes:
    """The StarkConfig as sorted JSON, byte for byte the reference's."""
    return json.dumps({"version": VERSION, **asdict(config)},
                      sort_keys=True).encode()


def deserialize_config(data: bytes, cls):
    """serialize_config's inverse (``cls``: the StarkConfig class)."""
    blob = json.loads(data.decode())
    if blob.pop("version") != VERSION:
        raise ValueError("config version mismatch")
    return cls(**blob)


def empty_proof_like_shapes(air, config, log_n: int):
    """A zero StarkProof with the structure/shapes that ``prover.prove``
    emits for a 2^log_n-row trace — the deserialization template (host
    tensors: only their structure and shapes are read)."""
    q = config.num_queries
    C = air.num_cols
    chunks = prover.num_quotient_chunks(air)
    cap = 1 << config.cap_height
    log_n0 = log_n + config.rate_bits
    depth = log_n0 - config.cap_height

    def fp(*shape):
        return torch.zeros(shape, dtype=torch.int64)

    def fp2(*shape):
        return fp(*shape), fp(*shape)

    fc = config.fri_config
    n_layers = fc.num_layers(log_n0)
    fri_proof = fri.FriProof(
        caps=[fp(cap, 4) for _ in range(n_layers)],
        final_coeffs=fp2(fc.final_poly_len),
        query_leaves=[fp(q, 4) for _ in range(n_layers)],
        query_paths=[fp(q, log_n0 - layer - 1 - config.cap_height, 4)
                     for layer in range(n_layers)],
        pow_nonce=fp())
    n_consts = np.asarray(air.constant_columns(1 << log_n)).shape[0]
    has_consts = n_consts > 0
    n_aux = prover.total_aux_cols(air)
    has_aux = n_aux > 0
    return prover.StarkProof(
        trace_cap=fp(cap, 4), quotient_cap=fp(cap, 4),
        trace_zeta=fp2(C), trace_gzeta=fp2(C), quotient_zeta=fp2(chunks),
        fri_proof=fri_proof,
        trace_rows_a=fp(q, C), trace_rows_b=fp(q, C),
        trace_paths_a=fp(q, depth, 4), trace_paths_b=fp(q, depth, 4),
        quot_rows_a=fp(q, 2 * chunks), quot_rows_b=fp(q, 2 * chunks),
        quot_paths_a=fp(q, depth, 4), quot_paths_b=fp(q, depth, 4),
        aux_cap=fp(cap, 4) if has_aux else None,
        aux_zeta=fp2(n_aux) if has_aux else None,
        aux_gzeta=fp2(n_aux) if has_aux else None,
        aux_rows_a=fp(q, n_aux) if has_aux else None,
        aux_rows_b=fp(q, n_aux) if has_aux else None,
        aux_paths_a=fp(q, depth, 4) if has_aux else None,
        aux_paths_b=fp(q, depth, 4) if has_aux else None,
        const_zeta=fp2(n_consts) if has_consts else None,
        const_gzeta=fp2(n_consts) if has_consts else None,
        const_rows_a=fp(q, n_consts) if has_consts else None,
        const_rows_b=fp(q, n_consts) if has_consts else None,
        const_paths_a=fp(q, depth, 4) if has_consts else None,
        const_paths_b=fp(q, depth, 4) if has_consts else None,
    )
