"""Full-statement STARK bundles — header_range and rotate, end to end.

A statement is a **bundle of DEEP-ALI STARKs whose public values
interlock**:

  per header i in (trusted, target] ......... HeaderAir proof
      (Blake2b digest + parent/block#/state_root/data_root extraction)
  state/data range commitments .............. MerkleSha256Air proofs
      (leaves = the extracted roots, zero-padded to the tree size)
  authority-set commitment .................. ChainedSha256Air proof
  GRANDPA precommit signatures .............. Ed25519VerifyAir shard proofs
  their challenges h = SHA-512(R‖A‖M) mod L . Sha512ChallengeAir shards

`verify_header_range` checks every proof AND the cross-proof links
(adjacency digest == parent chains, sequential block numbers, Merkle-leaf
equality, signer-set membership, the 53-byte precommit, the 2/3
threshold): all host link checks first (phase A), then every STARK
(phase B). The rotate statement proves that a justified epoch-end header
schedules the new authority set, and outputs the new set's hash.

The proofs of a bundle run on ``device``: one torch device (the current
CUDA device when None), or a list of them, over which the sub-proofs go
round-robin as in the JAX package (header i, then the two range trees and
the chain after the headers; signature and challenge shard i on device
i). The bundle's bytes do not depend on the devices. ``header_range`` with
``procs > 1`` scatters the per-header proofs over worker processes on the
first device (parallel/map_prove.prove_headers_procs), which hand them
back through the checkpoint; ``rotate`` takes ``procs`` and drops it (its
map phase is one header).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .. import default_device
from ..circuits import scale
from ..circuits.commitments import authority_set_hash
from ..circuits.consts import ENCODED_PRECOMMIT_LENGTH
from ..circuits.ed25519 import L_ORDER
from ..field import goldilocks as gl
from . import prover, verifier
from . import serialize as _ser
from .air_ed25519 import Ed25519VerifyAir, dummy_sig
from .air_header import HeaderAir, header_publics_fields
from .air_rotate import P_WLEN, RotateHeaderAir, rotate_window_fields
from .air_sha256_chain import ChainedSha256Air
from .air_sha256_merkle import MerkleSha256Air
from .air_sha512 import Sha512ChallengeAir
from .checkpoint import Checkpoint
from .ed25519_prove import device_list, shard_sigs, sigs_from_justification
from .prover import StarkConfig, StarkProof

Sig = Tuple[bytes, bytes, int, int]


class VerificationError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise VerificationError(msg)


def _sig_ckpt_bytes(shard) -> bytes:
    """Stable byte identity of a signature shard (checkpoint keying)."""
    return b"".join(a + r + int(s).to_bytes(32, "little")
                    + int(h).to_bytes(64, "little")
                    for (a, r, s, h) in shard)


def _pubs_fp(publics, device):
    return [gl.to_fp(int(p), device) for p in publics]


def _leaf_words(leaf: bytes) -> List[int]:
    return [int.from_bytes(leaf[4 * i:4 * i + 4], "big") for i in range(8)]


def _words_leaf(words: Sequence[int]) -> bytes:
    return b"".join(int(w).to_bytes(4, "big") for w in words)


def _log_n(air) -> int:
    return air.n_rows.bit_length() - 1


def _verify_one(air, proof, publics, config) -> bool:
    return bool(verifier.verify(air, proof,
                                _pubs_fp(publics, proof.trace_cap.device),
                                _log_n(air), config))


@dataclass
class HeaderRangeStarkProof:
    """The statement proof: interlocking STARKs + the public witness data
    the verifier needs to rebuild instance-bound constant columns."""
    tree_size: int
    max_chunks: int
    max_authorities: int
    ed_B: int
    # subchain
    header_publics: List[List[int]]
    header_proofs: List[StarkProof]
    # range commitments
    state_merkle_publics: List[int]
    state_merkle_proof: StarkProof
    data_merkle_publics: List[int]
    data_merkle_proof: StarkProof
    # justification
    authorities: List[bytes]          # full active set, canonical order
    signed: List[bool]
    round_: int
    shard_sigs: List[List[Sig]]       # per-lane (A, R, s, h)
    sig_publics: List[List[int]]
    sig_proofs: List[StarkProof]
    # in-STARK challenge binding: h = SHA-512(R‖A‖M) mod L per lane
    # (Sha512ChallengeAir over the SAME shard lane tuples)
    sha512_publics: List[List[int]]
    sha512_proofs: List[StarkProof]
    chain_publics: List[int]
    chain_proof: StarkProof


def _prove_unit(cp, label, config, parts, air, build, device):
    """A checkpointed sub-proof: (proof, publics) from the store, else
    ``build()`` -> (trace, publics) proved on ``device`` and stored."""
    hit = cp.load(label, config, parts, air, device)
    if hit is not None:
        return hit
    trace, publics = build()
    proof = prover.prove(air, trace, _pubs_fp(publics, device), config)
    cp.store(label, config, parts, proof, publics)
    return proof, list(publics)


def _prove_sig_shards(sigs, message: bytes, ed_B: int, config, cp, devices):
    """One Ed25519VerifyAir proof per shard of 2^(ed_B-8) lanes, shard i
    on devices[i % len(devices)]."""
    sig_publics, sig_proofs, shard_list = [], [], []
    for i, shard in enumerate(shard_sigs(sigs, ed_B)):
        air = Ed25519VerifyAir(shard, B=ed_B)
        parts = (_sig_ckpt_bytes(shard), message, str(ed_B).encode())
        dev = devices[i % len(devices)]
        proof, publics = _prove_unit(
            cp, "sig", config, parts, air,
            lambda air=air, dev=dev: air.make_trace_vec(dev), dev)
        sig_proofs.append(proof)
        sig_publics.append(publics)
        shard_list.append(list(air.sigs))
    return sig_publics, sig_proofs, shard_list


def _prove_challenge_shards(shard_list, message: bytes, ed_B: int,
                            config: StarkConfig, cp, devices):
    """One Sha512ChallengeAir proof per signature shard: every lane's
    h = SHA-512(R‖A‖M) mod L proven in-STARK; shard i on
    devices[i % len(devices)]."""
    publics_l, proofs = [], []
    for i, shard in enumerate(shard_list):
        air = Sha512ChallengeAir(shard, message, B=ed_B)
        parts = (_sig_ckpt_bytes(shard), message, b"sha512",
                 str(ed_B).encode())
        dev = devices[i % len(devices)]
        proof, publics = _prove_unit(
            cp, "sha512", config, parts, air,
            lambda air=air, dev=dev: air.make_trace(dev), dev)
        proofs.append(proof)
        publics_l.append(list(publics))
    return publics_l, proofs


def _justification(authorities, signatures, message: bytes):
    signed = [s is not None for s in signatures]
    sigs = sigs_from_justification(
        list(authorities),
        [s if s is not None else bytes(64) for s in signatures],
        signed, message)
    return signed, sigs


def prove_header_range(
    trusted_block: int,
    target_block: int,
    headers: Sequence[bytes],         # SCALE headers for (trusted, target]
    authorities: Sequence[bytes],     # active set, canonical order
    signatures: Sequence[Optional[bytes]],  # 64-byte sig or None per lane
    authority_set_id: int,
    round_: int,
    config: StarkConfig,
    *,
    tree_size: int,
    max_chunks: int,
    max_authorities: int,
    ed_B: int = 8,
    device=None,
    checkpoint: Optional[str] = None,
    procs: int = 1,
) -> HeaderRangeStarkProof:
    n = len(headers)
    assert n == target_block - trusted_block and 0 < n <= tree_size
    devices = device_list(device)

    def slot(i):
        return devices[i % len(devices)]

    cp = Checkpoint(checkpoint)

    if procs > 1:
        # the map phase over worker processes: they prove the per-header
        # shards and hand them back through the checkpoint store, so the
        # loop below hits cp for every header
        if not checkpoint:
            raise AssertionError(
                "procs > 1 needs a checkpoint dir for handoff")
        from ..parallel.map_prove import prove_headers_procs
        prove_headers_procs([bytes(h) for h in headers], max_chunks,
                            config, checkpoint, procs, device=devices[0])

    # -- per-header hash+decode proofs -----------------------------------
    air_h = HeaderAir(max_chunks)
    header_publics, header_proofs = [], []
    state_roots, data_roots = [], []
    for i, hdr in enumerate(headers):
        parts = (bytes(hdr), str(max_chunks).encode())
        dev = slot(i)
        proof, publics = _prove_unit(
            cp, "hdr", config, parts, air_h,
            lambda hdr=hdr, dev=dev: air_h.make_trace(bytes(hdr), dev)[:2],
            dev)
        header_proofs.append(proof)
        header_publics.append(publics)
        f = header_publics_fields(publics, device=dev)
        state_roots.append(f["state_root"])
        data_roots.append(f["data_root"])
    target_hash = hashlib.blake2b(bytes(headers[-1]),
                                  digest_size=32).digest()

    # -- range-commitment Merkle proofs -----------------------------------
    def merkle(leaves: List[bytes], dev):
        parts = (b"".join(leaves), str(tree_size).encode())
        words = [_leaf_words(lf) for lf in
                 leaves + [bytes(32)] * (tree_size - len(leaves))]
        air = MerkleSha256Air(words)
        proof, publics = _prove_unit(
            cp, "merkle", config, parts, air,
            lambda: air.make_trace(dev)[:2], dev)
        return publics, proof

    state_pub, state_prf = merkle(state_roots, slot(n))
    data_pub, data_prf = merkle(data_roots, slot(n + 1))

    # -- authority-set commitment proof ------------------------------------
    chain_air = ChainedSha256Air(max_authorities)
    words = ChainedSha256Air.pubkeys_to_words(list(authorities),
                                              max_authorities)
    parts = (b"".join(authorities), str(max_authorities).encode())
    chain_prf, chain_pub = _prove_unit(
        cp, "chain", config, parts, chain_air,
        lambda: chain_air.make_trace(words, len(authorities), slot(n + 2))[:2],
        slot(n + 2))

    # -- precommit signatures ----------------------------------------------
    message = scale.encode_precommit_bytes(target_hash, target_block,
                                           round_, authority_set_id)
    signed, sigs = _justification(authorities, signatures, message)
    sig_publics, sig_proofs, shard_list = _prove_sig_shards(
        sigs, message, ed_B, config, cp, devices)
    sha_publics, sha_proofs = _prove_challenge_shards(
        shard_list, message, ed_B, config, cp, devices)

    return HeaderRangeStarkProof(
        tree_size=tree_size, max_chunks=max_chunks,
        max_authorities=max_authorities, ed_B=ed_B,
        header_publics=header_publics, header_proofs=header_proofs,
        state_merkle_publics=state_pub, state_merkle_proof=state_prf,
        data_merkle_publics=data_pub, data_merkle_proof=data_prf,
        authorities=list(authorities), signed=signed, round_=round_,
        shard_sigs=shard_list, sig_publics=sig_publics,
        sig_proofs=sig_proofs,
        sha512_publics=sha_publics, sha512_proofs=sha_proofs,
        chain_publics=list(chain_pub), chain_proof=chain_prf)


def _verify_challenge_shards(bundle, message: bytes,
                             config: StarkConfig) -> None:
    _check(len(bundle.sha512_proofs) == len(bundle.sha512_publics)
           == len(bundle.shard_sigs), "sha512 shard counts")
    for i, shard in enumerate(bundle.shard_sigs):
        air = Sha512ChallengeAir(shard, message, B=bundle.ed_B)
        _check([int(p) for p in bundle.sha512_publics[i]]
               == air.publics_list(), f"sha512 shard {i} publics")
        _check(_verify_one(air, bundle.sha512_proofs[i],
                           bundle.sha512_publics[i], config),
               f"sha512 shard {i} proof")


def verify_header_range(
    bundle: HeaderRangeStarkProof,
    trusted_block: int,
    trusted_header_hash: bytes,
    authority_set_id: int,
    authority_set_hash_pub: bytes,
    target_block: int,
    config: StarkConfig,
    device=None,
) -> Tuple[bytes, bytes, bytes]:
    """Raises VerificationError on any failed check. Returns the contract
    outputs (target_header_hash, state_root_commitment,
    data_root_commitment). The γ transcripts of the header claims run on
    ``device``; each STARK verifies on its proof's device."""
    device = default_device(device)
    n = target_block - trusted_block
    _check(0 < n <= bundle.tree_size, "bad range size")
    _check(len(bundle.header_proofs) == n == len(bundle.header_publics),
           "header proof count")

    # ===== phase A: host-side claim/link checks (cheap — run them ALL
    # before any STARK verification so malformed bundles fail fast) =======

    # subchain adjacency links
    prev_hash = trusted_header_hash
    state_roots, data_roots = [], []
    for i in range(n):
        try:
            f = header_publics_fields(bundle.header_publics[i],
                                      device=device)
        except AssertionError as e:
            raise VerificationError(f"header {i} publics: {e}")
        _check(f["parent_hash"] == prev_hash, f"chain link at header {i}")
        _check(f["block_number"] == trusted_block + 1 + i,
               f"block number at header {i}")
        prev_hash = f["digest"]
        state_roots.append(f["state_root"])
        data_roots.append(f["data_root"])
    target_hash = prev_hash

    # range-commitment leaves must be the extracted roots, zero-padded
    def merkle_claim(publics, leaves, label):
        words = [_leaf_words(lf) for lf in
                 leaves + [bytes(32)] * (bundle.tree_size - len(leaves))]
        flat = [w for row in words for w in row]
        _check([int(p) for p in publics[:len(flat)]] == flat,
               f"{label} merkle leaves")
        air = MerkleSha256Air(words)
        _check(len(publics) == air.num_publics, f"{label} publics size")
        return air, _words_leaf([int(p) for p in publics[len(flat):]])

    state_air, state_commit = merkle_claim(bundle.state_merkle_publics,
                                           state_roots, "state")
    data_air, data_commit = merkle_claim(bundle.data_merkle_publics,
                                         data_roots, "data")

    # authority set
    n_auth = len(bundle.authorities)
    _check(0 < n_auth <= bundle.max_authorities, "authority count")
    _check(authority_set_hash(bundle.authorities) == authority_set_hash_pub,
           "authority-set commitment")
    _check(int(bundle.chain_publics[0]) == n_auth, "chain num_active")
    _check(_words_leaf([int(p) for p in bundle.chain_publics[1:9]])
           == authority_set_hash_pub, "chain digest")

    # precommit lanes + 2/3 threshold
    message = scale.encode_precommit_bytes(target_hash, target_block,
                                           bundle.round_, authority_set_id)
    assert len(message) == ENCODED_PRECOMMIT_LENGTH
    _check_lanes(bundle, message)

    # ===== phase B: STARK verification of every bundled proof =============
    air_h = HeaderAir(bundle.max_chunks)
    for i in range(n):
        _check(_verify_one(air_h, bundle.header_proofs[i],
                           bundle.header_publics[i], config),
               f"header proof {i}")
    for air, proof, publics, label in (
            (state_air, bundle.state_merkle_proof,
             bundle.state_merkle_publics, "state merkle"),
            (data_air, bundle.data_merkle_proof,
             bundle.data_merkle_publics, "data merkle")):
        _check(_verify_one(air, proof, publics, config), f"{label} proof")
    chain_air = ChainedSha256Air(bundle.max_authorities)
    _check(_verify_one(chain_air, bundle.chain_proof, bundle.chain_publics,
                       config), "authority-chain proof")
    _verify_sig_shards(bundle, config)
    _verify_challenge_shards(bundle, message, config)

    return target_hash, state_commit, data_commit


def _check_lanes(bundle, message: bytes) -> None:
    """Host checks on the signature lanes: signer-set membership,
    canonical s, dummy padding, 2/3 threshold. The challenge
    h = SHA-512(R‖A‖M) mod L is proven in-STARK per shard (checked by
    _verify_challenge_shards over the same lane tuples)."""
    n_auth = len(bundle.authorities)
    _check(len(bundle.signed) == n_auth, "signed flags length")
    lanes = [sig for shard in bundle.shard_sigs for sig in shard]
    _check(len(lanes) >= n_auth, "missing signature lanes")
    dmy = dummy_sig()
    n_signed = 0
    for i in range(len(lanes)):
        a, r, s, h = lanes[i]
        if i < n_auth and bundle.signed[i]:
            n_signed += 1
            _check(a == bundle.authorities[i], f"lane {i} pubkey")
            _check(0 <= s < L_ORDER, f"lane {i} malleable s")
        else:
            _check((a, r, s, h) == dmy, f"lane {i} must be dummy")
    _check(n_signed * 3 > n_auth * 2, "2/3 threshold")


def _verify_sig_shards(bundle, config: StarkConfig) -> None:
    _check(len(bundle.shard_sigs) == len(bundle.sig_proofs)
           == len(bundle.sig_publics), "shard counts")
    for i, shard in enumerate(bundle.shard_sigs):
        air = Ed25519VerifyAir(shard, B=bundle.ed_B)
        _check([int(p) for p in bundle.sig_publics[i]]
               == air.publics_list(), f"sig shard {i} publics")
        _check(_verify_one(air, bundle.sig_proofs[i], bundle.sig_publics[i],
                           config), f"sig shard {i} proof")


# ===========================================================================
# rotate — authority-set handoff statement
# ===========================================================================


@dataclass
class RotateStarkProof:
    """Proof that a justified epoch-end header schedules the new set."""
    max_chunks: int
    max_authorities: int
    ed_B: int
    epoch_end_block: int
    header_publics: List[int]
    header_proof: StarkProof
    window: bytes                      # claimed ScheduledChange region
    # justification by the CURRENT set
    authorities: List[bytes]
    signed: List[bool]
    round_: int
    shard_sigs: List[List[Sig]]
    sig_publics: List[List[int]]
    sig_proofs: List[StarkProof]
    sha512_publics: List[List[int]]
    sha512_proofs: List[StarkProof]
    cur_chain_publics: List[int]
    cur_chain_proof: StarkProof
    # commitment of the NEW set
    new_chain_publics: List[int]
    new_chain_proof: StarkProof


def prove_rotate(
    epoch_end_block: int,
    header: bytes,                     # epoch-end SCALE header
    authorities: Sequence[bytes],      # CURRENT active set
    signatures: Sequence[Optional[bytes]],
    authority_set_id: int,
    round_: int,
    config: StarkConfig,
    *,
    max_chunks: int,
    max_authorities: int,
    ed_B: int = 8,
    device=None,
    checkpoint: Optional[str] = None,
    procs: int = 1,                    # accepted for CLI symmetry; the
                                       # rotate map phase is one header
) -> RotateStarkProof:
    del procs
    devices = device_list(device)
    cp = Checkpoint(checkpoint)

    air_r = RotateHeaderAir(max_chunks)
    trace, publics, digest, (start, n_new, new_pubkeys) = \
        air_r.make_trace(bytes(header), devices[0])
    parts_h = (bytes(header), str(max_chunks).encode())
    header_proof, _ = _prove_unit(cp, "rot-hdr", config, parts_h, air_r,
                                  lambda: (trace, publics), devices[0])
    end = start + int(publics[P_WLEN])
    window = bytes(header)[start:end]

    def chain(keys, slot):
        air = ChainedSha256Air(max_authorities)
        parts = (b"".join(keys), str(max_authorities).encode())
        words = ChainedSha256Air.pubkeys_to_words(list(keys),
                                                  max_authorities)
        dev = devices[slot % len(devices)]
        proof, pub = _prove_unit(
            cp, "rot-chain", config, parts, air,
            lambda: air.make_trace(words, len(keys), dev)[:2], dev)
        return pub, proof

    cur_pub, cur_prf = chain(authorities, 1)
    new_pub, new_prf = chain(new_pubkeys, 2)

    message = scale.encode_precommit_bytes(digest, epoch_end_block,
                                           round_, authority_set_id)
    signed, sigs = _justification(authorities, signatures, message)
    sig_publics, sig_proofs, shard_list = _prove_sig_shards(
        sigs, message, ed_B, config, cp, devices)
    sha_publics, sha_proofs = _prove_challenge_shards(
        shard_list, message, ed_B, config, cp, devices)

    return RotateStarkProof(
        max_chunks=max_chunks, max_authorities=max_authorities, ed_B=ed_B,
        epoch_end_block=epoch_end_block,
        header_publics=list(publics), header_proof=header_proof,
        window=window,
        authorities=list(authorities), signed=signed, round_=round_,
        shard_sigs=shard_list, sig_publics=sig_publics,
        sig_proofs=sig_proofs,
        sha512_publics=sha_publics, sha512_proofs=sha_proofs,
        cur_chain_publics=cur_pub, cur_chain_proof=cur_prf,
        new_chain_publics=new_pub, new_chain_proof=new_prf)


def verify_rotate(
    bundle: RotateStarkProof,
    authority_set_id: int,
    authority_set_hash_pub: bytes,
    config: StarkConfig,
    device=None,
) -> bytes:
    """Raises VerificationError on failure. Returns the contract output
    new_authority_set_hash. The window's γ transcript runs on ``device``;
    each STARK verifies on its proof's device."""
    device = default_device(device)
    # ===== phase A: host-side claim/link checks (fail fast) ===============
    try:
        f = rotate_window_fields(bundle.header_publics, bundle.window,
                                 device)
    except AssertionError as e:
        raise VerificationError(f"rotate header publics: {e}")
    _check(f["block_number"] == bundle.epoch_end_block,
           "epoch-end block number")
    digest = f["digest"]

    # current authority set
    n_auth = len(bundle.authorities)
    _check(0 < n_auth <= bundle.max_authorities, "authority count")
    _check(authority_set_hash(bundle.authorities) == authority_set_hash_pub,
           "current authority-set commitment")
    _check(int(bundle.cur_chain_publics[0]) == n_auth, "cur chain count")
    _check(_words_leaf([int(p) for p in bundle.cur_chain_publics[1:9]])
           == authority_set_hash_pub, "cur chain digest")

    # justification lanes over the epoch-end precommit
    message = scale.encode_precommit_bytes(
        digest, bundle.epoch_end_block, bundle.round_, authority_set_id)
    _check_lanes(bundle, message)

    # new set commitment claim (the contract output)
    new_keys = f["new_pubkeys"]
    _check(0 < len(new_keys) <= bundle.max_authorities, "new set size")
    new_hash = authority_set_hash(new_keys)
    _check(int(bundle.new_chain_publics[0]) == len(new_keys),
           "new chain count")
    _check(_words_leaf([int(p) for p in bundle.new_chain_publics[1:9]])
           == new_hash, "new chain digest")

    # ===== phase B: STARK verification =====================================
    air_r = RotateHeaderAir(bundle.max_chunks)
    _check(_verify_one(air_r, bundle.header_proof, bundle.header_publics,
                       config), "rotate header proof")
    chain_air = ChainedSha256Air(bundle.max_authorities)
    _check(_verify_one(chain_air, bundle.cur_chain_proof,
                       bundle.cur_chain_publics, config), "cur chain proof")
    _check(_verify_one(chain_air, bundle.new_chain_proof,
                       bundle.new_chain_publics, config), "new chain proof")
    _verify_sig_shards(bundle, config)
    _verify_challenge_shards(bundle, message, config)
    return new_hash


# ===========================================================================
# bundle (de)serialization
# ===========================================================================
# A bundle round-trips through a self-describing artifact: a JSON header
# (witness/public data + per-proof byte lengths) followed by the port's
# serialize_proof blobs, whose deserialization templates are rebuilt from
# the config alone (serialize.empty_proof_like_shapes).

_BMAGIC = b"VXB1"


def _sig_to_json(sig: Sig):
    a, r, s, h = sig
    return [a.hex(), r.hex(), hex(s), hex(h)]


def _sig_from_json(row) -> Sig:
    return (bytes.fromhex(row[0]), bytes.fromhex(row[1]),
            int(row[2], 16), int(row[3], 16))


def _pack(meta: dict, proofs: List[StarkProof]) -> bytes:
    blobs = [_ser.serialize_proof(p) for p in proofs]
    meta["proof_lengths"] = [len(b) for b in blobs]
    header = json.dumps(meta).encode()
    return (_BMAGIC + len(header).to_bytes(4, "little") + header
            + b"".join(blobs))


def _unpack(data: bytes):
    if data[:4] != _BMAGIC:
        raise ValueError("bad bundle magic")
    hlen = int.from_bytes(data[4:8], "little")
    meta = json.loads(data[8:8 + hlen].decode())
    off = 8 + hlen
    blobs = []
    for ln in meta["proof_lengths"]:
        blobs.append(data[off:off + ln])
        off += ln
    if off != len(data):
        raise ValueError("trailing bytes")
    return meta, blobs


def _config(meta) -> StarkConfig:
    cfg_d = dict(meta["config"])
    cfg_d.pop("version", None)
    return StarkConfig(**cfg_d)


def _deser(blob, air, config, device):
    like = _ser.empty_proof_like_shapes(air, config, _log_n(air))
    return _ser.deserialize_proof(blob, like, device)


def _deser_shards(blobs, shard_sigs_l, meta, config, device):
    """The Ed25519 shard proofs, then the SHA-512 ones. A SHA-512 template
    depends only on B (its shapes are lane- and message-independent), so
    a placeholder instance serves as `like`."""
    k = len(shard_sigs_l)
    sig_proofs = [_deser(blobs[i], Ed25519VerifyAir(sh, B=meta["ed_B"]),
                         config, device)
                  for i, sh in enumerate(shard_sigs_l)]
    like_air = Sha512ChallengeAir([], bytes(ENCODED_PRECOMMIT_LENGTH),
                                  B=meta["ed_B"])
    sha_proofs = [_deser(blobs[k + i], like_air, config, device)
                  for i in range(k)]
    return sig_proofs, sha_proofs


def _lanes_meta(bundle) -> dict:
    return dict(
        authorities=[a.hex() for a in bundle.authorities],
        signed=list(map(bool, bundle.signed)), round=bundle.round_,
        shard_sigs=[[_sig_to_json(s) for s in sh]
                    for sh in bundle.shard_sigs],
        sig_publics=[[int(p) for p in ps] for ps in bundle.sig_publics],
        sha512_publics=[[int(p) for p in ps]
                        for ps in bundle.sha512_publics])


def serialize_header_range(bundle: HeaderRangeStarkProof,
                           config: StarkConfig) -> bytes:
    meta = dict(
        kind="header_range",
        config=json.loads(_ser.serialize_config(config).decode()),
        tree_size=bundle.tree_size, max_chunks=bundle.max_chunks,
        max_authorities=bundle.max_authorities, ed_B=bundle.ed_B,
        header_publics=[[int(p) for p in ps]
                        for ps in bundle.header_publics],
        state_merkle_publics=[int(p) for p in bundle.state_merkle_publics],
        data_merkle_publics=[int(p) for p in bundle.data_merkle_publics],
        **_lanes_meta(bundle),
        chain_publics=[int(p) for p in bundle.chain_publics],
    )
    proofs = (list(bundle.header_proofs)
              + [bundle.state_merkle_proof, bundle.data_merkle_proof,
                 bundle.chain_proof] + list(bundle.sig_proofs)
              + list(bundle.sha512_proofs))
    return _pack(meta, proofs)


def deserialize_header_range(data: bytes, device=None
                             ) -> Tuple[HeaderRangeStarkProof, StarkConfig]:
    """-> (bundle with its proofs on ``device``, config)."""
    meta, blobs = _unpack(data)
    if meta["kind"] != "header_range":
        raise ValueError(f"not a header_range bundle: {meta['kind']}")
    config = _config(meta)

    air_h = HeaderAir(meta["max_chunks"])
    n = len(meta["header_publics"])
    header_proofs = [_deser(blobs[i], air_h, config, device)
                     for i in range(n)]
    ts = meta["tree_size"]

    def merkle_air(publics):
        return MerkleSha256Air([[int(w) for w in publics[8 * i:8 * i + 8]]
                                for i in range(ts)])

    state_prf = _deser(blobs[n], merkle_air(meta["state_merkle_publics"]),
                       config, device)
    data_prf = _deser(blobs[n + 1], merkle_air(meta["data_merkle_publics"]),
                      config, device)
    chain_prf = _deser(blobs[n + 2], ChainedSha256Air(meta["max_authorities"]),
                       config, device)
    shard_sigs_l = [[_sig_from_json(s) for s in sh]
                    for sh in meta["shard_sigs"]]
    sig_proofs, sha_proofs = _deser_shards(blobs[n + 3:], shard_sigs_l,
                                           meta, config, device)

    return HeaderRangeStarkProof(
        tree_size=ts, max_chunks=meta["max_chunks"],
        max_authorities=meta["max_authorities"], ed_B=meta["ed_B"],
        header_publics=meta["header_publics"],
        header_proofs=header_proofs,
        state_merkle_publics=meta["state_merkle_publics"],
        state_merkle_proof=state_prf,
        data_merkle_publics=meta["data_merkle_publics"],
        data_merkle_proof=data_prf,
        authorities=[bytes.fromhex(a) for a in meta["authorities"]],
        signed=list(meta["signed"]), round_=meta["round"],
        shard_sigs=shard_sigs_l, sig_publics=meta["sig_publics"],
        sig_proofs=sig_proofs,
        sha512_publics=meta["sha512_publics"], sha512_proofs=sha_proofs,
        chain_publics=meta["chain_publics"], chain_proof=chain_prf), config


def serialize_rotate(bundle: RotateStarkProof, config: StarkConfig) -> bytes:
    meta = dict(
        kind="rotate",
        config=json.loads(_ser.serialize_config(config).decode()),
        max_chunks=bundle.max_chunks,
        max_authorities=bundle.max_authorities, ed_B=bundle.ed_B,
        epoch_end_block=bundle.epoch_end_block,
        header_publics=[int(p) for p in bundle.header_publics],
        window=bundle.window.hex(),
        **_lanes_meta(bundle),
        cur_chain_publics=[int(p) for p in bundle.cur_chain_publics],
        new_chain_publics=[int(p) for p in bundle.new_chain_publics],
    )
    proofs = ([bundle.header_proof, bundle.cur_chain_proof,
               bundle.new_chain_proof] + list(bundle.sig_proofs)
              + list(bundle.sha512_proofs))
    return _pack(meta, proofs)


def deserialize_rotate(data: bytes, device=None
                       ) -> Tuple[RotateStarkProof, StarkConfig]:
    """-> (bundle with its proofs on ``device``, config)."""
    meta, blobs = _unpack(data)
    if meta["kind"] != "rotate":
        raise ValueError(f"not a rotate bundle: {meta['kind']}")
    config = _config(meta)

    header_proof = _deser(blobs[0], RotateHeaderAir(meta["max_chunks"]),
                          config, device)
    chain_air = ChainedSha256Air(meta["max_authorities"])
    cur_prf = _deser(blobs[1], chain_air, config, device)
    new_prf = _deser(blobs[2], chain_air, config, device)
    shard_sigs_l = [[_sig_from_json(s) for s in sh]
                    for sh in meta["shard_sigs"]]
    sig_proofs, sha_proofs = _deser_shards(blobs[3:], shard_sigs_l, meta,
                                           config, device)

    return RotateStarkProof(
        max_chunks=meta["max_chunks"],
        max_authorities=meta["max_authorities"], ed_B=meta["ed_B"],
        epoch_end_block=meta["epoch_end_block"],
        header_publics=meta["header_publics"], header_proof=header_proof,
        window=bytes.fromhex(meta["window"]),
        authorities=[bytes.fromhex(a) for a in meta["authorities"]],
        signed=list(meta["signed"]), round_=meta["round"],
        shard_sigs=shard_sigs_l, sig_publics=meta["sig_publics"],
        sig_proofs=sig_proofs,
        sha512_publics=meta["sha512_publics"], sha512_proofs=sha_proofs,
        cur_chain_publics=meta["cur_chain_publics"],
        cur_chain_proof=cur_prf,
        new_chain_publics=meta["new_chain_publics"],
        new_chain_proof=new_prf), config
