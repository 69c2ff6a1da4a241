"""Function entrypoints — the build/prove CLI of the port.

``python -m vectorx_tpu_torch <program> build|prove ...``: a ``build``
verb that writes the circuit artifacts (manifest and config) and a
``prove input.json`` verb that runs a program on a hex input and emits a
hex output, as VectorX's function entrypoints do. Programs:

  dummy_header_range / dummy_rotate  — byte-ABI-exact programs, no proof
  header_range / rotate              — the witness-level verified programs
                                        (``--stark``: the STARK bundles of
                                        stark/statements.py)
  genesis                            — the deployment parameters of a block

``prove`` reads {"input": "0x..."} and writes {"output": "0x...", "ok": true};
a failed check exits non-zero. Chain data comes from ``--fixtures <dir>``
(offline snapshots: {block}.header hex files, meta.json,
justifications.json) or, without it, from the Avail node at ``AVAIL_URL``
(``LiveSource``; the stored justifications from the Redis at
``REDIS_URL`` where one is set). The device programs run on the current
CUDA device unless ``--device`` names another (``--device cpu`` for the
CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..circuits import consts
from ..circuits.abi import HeaderRangeInput, RotateInput
from . import dummy


class FixtureSource:
    """Offline chain snapshots for hermetic prove runs.

    Layout: {block}.header hex files; meta.json for last_justified /
    authorities; justifications.json mapping block number -> the
    StoredJustification record fields (the indexer's canonical format)."""

    def __init__(self, path: str,
                 max_authorities: int = consts.MAX_AUTHORITY_SET_SIZE,
                 device=None):
        self.path = path
        self.max_authorities = max_authorities
        self.device = device
        meta_path = os.path.join(path, "meta.json")
        self.meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
        jpath = os.path.join(path, "justifications.json")
        self._justifications = (json.load(open(jpath))
                                if os.path.exists(jpath) else {})

    def get_header(self, block_number: int) -> bytes:
        with open(os.path.join(self.path, f"{block_number}.header")) as f:
            return bytes.fromhex(f.read().strip().removeprefix("0x"))

    def get_roots_range(self, start_block: int, end_block: int):
        from ..circuits import scale
        state_roots, data_roots = [], []
        for b in range(start_block + 1, end_block + 1):
            dec = scale.decode_header_bytes(self.get_header(b))
            state_roots.append(dec["state_root"])
            data_roots.append(dec["data_root"])
        return state_roots, data_roots

    def last_justified_block(self, authority_set_id: int) -> int:
        return self.meta["last_justified"][str(authority_set_id)]

    def get_authorities(self, block_number: int):
        return [bytes.fromhex(h) for h in self.meta["authorities"][str(block_number)]]

    def get_authority_set_id(self, block_number: int) -> int:
        return self.meta["authority_set_id"][str(block_number)]

    def get_justification_record(self, block_number: int):
        from ..services.store import StoredJustification
        return StoredJustification(**self._justifications[str(block_number)])

    def get_justification_data(self, block_number: int):
        from .grandpa import to_device_justification
        return to_device_justification(self.get_justification_record(block_number),
                                       self.max_authorities, self.device)

    def get_rotate_data(self, authority_set_id: int):
        """-> (epoch_end_block, header, start_pos, num_auth, pubkeys) —
        the rotate hint."""
        from ..circuits.rotate import find_scheduled_change
        block = self.last_justified_block(authority_set_id)
        header = self.get_header(block)
        found = find_scheduled_change(header)
        if found is None:
            raise LookupError(f"no ScheduledChange log in header {block}")
        return (block, header) + found


class LiveSource:
    """Chain data from an Avail node (``avail_rpc.AvailClient`` at
    ``url``), with the methods of ``FixtureSource``. Justifications come
    from ``grandpa.JustificationProvider`` over the Redis store at
    ``REDIS_URL`` (an empty in-memory store without one), verified on
    ``device``. The source owns its event loop; the hint runtime may call
    it from worker threads, one call at a time. ``close`` ends the loop."""

    def __init__(self, url: str, device=None):
        from .avail_rpc import AvailClient
        self.device = device
        self._loop = asyncio.new_event_loop()
        self.client = AvailClient(url)
        try:
            self._run(self.client.connect())
        except BaseException:
            self._loop.close()
            raise

    def _run(self, coro):
        return self._loop.run_until_complete(coro)

    def close(self) -> None:
        try:
            self._run(self.client.close())
        finally:
            self._loop.close()

    def get_header(self, n):
        return self._run(self.client.get_header_scale(n))

    def get_roots_range(self, start, end):
        from ..circuits import scale
        headers = self._run(self.client.get_headers_range(start + 1, end))
        decs = [scale.decode_header_bytes(h) for h in headers]
        return ([d["state_root"] for d in decs],
                [d["data_root"] for d in decs])

    def last_justified_block(self, sid):
        return self._run(self.client.last_justified_block(sid))

    def get_authorities(self, n):
        return self._run(self.client.get_authorities(n))

    def get_authority_set_id(self, n):
        return self._run(self.client.get_authority_set_id(n))

    def get_justification_record(self, block):
        from .grandpa import JustificationProvider
        from .store import InMemoryStore, RedisStore
        redis_url = os.environ.get("REDIS_URL")
        store = RedisStore(redis_url) if redis_url else InMemoryStore()
        return self._run(
            JustificationProvider(self.client, store, self.device).get(block))

    def get_justification_data(self, block):
        from .grandpa import to_device_justification
        return to_device_justification(
            self.get_justification_record(block),
            consts.MAX_AUTHORITY_SET_SIZE, self.device)

    def get_rotate_data(self, authority_set_id):
        from ..circuits.rotate import find_scheduled_change
        block = self.last_justified_block(authority_set_id)
        header = self.get_header(block)
        found = find_scheduled_change(header)
        if found is None:
            raise LookupError(f"no ScheduledChange log in header {block}")
        return (block, header) + found


def _load_input(path: str) -> bytes:
    blob = json.load(open(path))
    if isinstance(blob, dict):
        raw = blob.get("input") or blob.get("data", {}).get("input")
    else:
        raw = blob
    return bytes.fromhex(raw.removeprefix("0x"))


def run_program(program: str, input_bytes: bytes, source,
                tree_size: int = consts.HEADER_RANGE_TREE_SIZE_SMALL,
                stark: bool = False, proof_path: Optional[str] = None,
                max_chunks: Optional[int] = None,
                checkpoint: Optional[str] = None,
                procs: int = 1, device=None) -> bytes:
    if program == "dummy_header_range":
        return dummy.dummy_header_range(input_bytes, source, tree_size)
    if program == "dummy_rotate":
        return dummy.dummy_rotate(input_bytes, source)
    if program == "header_range":
        if stark:
            return _prove_header_range_stark(input_bytes, source, tree_size,
                                             proof_path, max_chunks,
                                             checkpoint, procs=procs,
                                             device=device)
        return _prove_header_range(input_bytes, source, tree_size, device)
    if program == "rotate":
        if stark:
            return _prove_rotate_stark(input_bytes, source, proof_path,
                                       max_chunks, checkpoint, procs=procs,
                                       device=device)
        return _prove_rotate(input_bytes, source, device)
    raise SystemExit(f"unknown program: {program}")


def _justification_host_inputs(rec):
    """StoredJustification -> (authorities, signatures-or-None, round)."""
    from ..circuits import scale
    pubs = [bytes.fromhex(p) for p in rec.pubkeys]
    sigs = [bytes.fromhex(s) if signed else None
            for s, signed in zip(rec.signatures, rec.validator_signed)]
    _, _, round_, _ = scale.decode_precommit_bytes(
        bytes.fromhex(rec.signed_message))
    return pubs[:rec.num_authorities], sigs[:rec.num_authorities], round_


def _stark_config():
    from ..stark.prover import StarkConfig
    return StarkConfig()


def _default_max_chunks(headers) -> int:
    need = max((len(h) + 4 + 127) // 128 for h in headers)
    return max(need, 2)


def _prove_header_range_stark(input_bytes: bytes, source, tree_size: int,
                              proof_path: Optional[str],
                              max_chunks: Optional[int],
                              checkpoint: Optional[str] = None,
                              procs: int = 1, device=None) -> bytes:
    """Full STARK bundle for header_range (stark/statements.py): proves,
    self-verifies, writes the serialized bundle artifact, returns the
    96-byte contract output."""
    from ..stark import statements as st
    from ..stark.hints import fetch_header_range_witness

    inp = HeaderRangeInput.decode(input_bytes)
    headers, rec = fetch_header_range_witness(source, inp.trusted_block,
                                              inp.target_block)
    authorities, signatures, round_ = _justification_host_inputs(rec)
    config = _stark_config()
    bundle = st.prove_header_range(
        inp.trusted_block, inp.target_block, headers, authorities,
        signatures, inp.authority_set_id, round_, config,
        tree_size=tree_size,
        max_chunks=max_chunks or _default_max_chunks(headers),
        max_authorities=consts.MAX_AUTHORITY_SET_SIZE,
        device=device, checkpoint=checkpoint, procs=procs)
    target_hash, state_c, data_c = st.verify_header_range(
        bundle, inp.trusted_block, inp.trusted_header_hash,
        inp.authority_set_id, inp.authority_set_hash, inp.target_block,
        config, device)
    if proof_path:
        with open(proof_path, "wb") as f:
            f.write(st.serialize_header_range(bundle, config))
    return target_hash + state_c + data_c


def _prove_rotate_stark(input_bytes: bytes, source,
                        proof_path: Optional[str],
                        max_chunks: Optional[int],
                        checkpoint: Optional[str] = None,
                        procs: int = 1, device=None) -> bytes:
    from ..stark import statements as st
    from ..stark.hints import fetch_rotate_witness

    inp = RotateInput.decode(input_bytes)
    (block, header, _start, _n, _pks), rec = fetch_rotate_witness(
        source, inp.authority_set_id)
    authorities, signatures, round_ = _justification_host_inputs(rec)
    config = _stark_config()
    bundle = st.prove_rotate(
        block, header, authorities, signatures, inp.authority_set_id,
        round_, config,
        max_chunks=max_chunks or _default_max_chunks([header]),
        max_authorities=consts.MAX_AUTHORITY_SET_SIZE,
        device=device, checkpoint=checkpoint, procs=procs)
    new_hash = st.verify_rotate(bundle, inp.authority_set_id,
                                inp.authority_set_hash, config, device)
    if proof_path:
        with open(proof_path, "wb") as f:
            f.write(st.serialize_rotate(bundle, config))
    return new_hash


def _bytes_tensor(raw: bytes, device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(device)


def _set_id_halves(set_id: int):
    return set_id & 0xFFFFFFFF, set_id >> 32


def _prove_header_range(input_bytes: bytes, source, tree_size: int,
                        device=None) -> bytes:
    """Witness-level verified header_range (the whole device program)."""
    from ..circuits import header_range as hr
    from ..parallel import subchain
    from ..stark.hints import fetch_header_range_witness
    from .grandpa import to_device_justification

    dev = default_device(device)
    inp = HeaderRangeInput.decode(input_bytes)
    headers, rec = fetch_header_range_witness(source, inp.trusted_block,
                                              inp.target_block)
    buf, sizes = subchain.pack_headers(headers, tree_size, consts.MAX_HEADER_SIZE)

    jd = to_device_justification(rec, consts.MAX_AUTHORITY_SET_SIZE, dev)
    res = hr.header_range(
        inp.trusted_block, _bytes_tensor(inp.trusted_header_hash, dev),
        _set_id_halves(inp.authority_set_id),
        _bytes_tensor(inp.authority_set_hash, dev), inp.target_block,
        torch.from_numpy(buf).to(dev), torch.from_numpy(sizes).to(dev), jd)
    if not bool(res.ok):
        raise SystemExit("header_range verification FAILED")
    return b"".join(bytes(t.cpu().numpy()) for t in (
        res.target_header_hash, res.state_root_commitment,
        res.data_root_commitment))


def _prove_rotate(input_bytes: bytes, source, device=None) -> bytes:
    """Witness-level verified rotate: justify the epoch-end header by the
    CURRENT set, check the ScheduledChange encoding, output the NEW set's
    chained hash (32-byte ABI)."""
    from ..circuits import header_range as hr

    dev = default_device(device)
    inp = RotateInput.decode(input_bytes)
    block, header, start_pos, n_auth, pubkeys = source.get_rotate_data(
        inp.authority_set_id)

    padded = header + bytes((-len(header)) % consts.BLAKE2B_CHUNK_SIZE_BYTES)
    pk = np.zeros((consts.MAX_AUTHORITY_SET_SIZE, 32), np.uint8)
    for i, p in enumerate(pubkeys):
        pk[i] = np.frombuffer(p, np.uint8)

    jd = source.get_justification_data(block)
    res = hr.rotate(
        _set_id_halves(inp.authority_set_id),
        _bytes_tensor(inp.authority_set_hash, dev), block,
        _bytes_tensor(padded, dev), len(header), n_auth, start_pos,
        torch.from_numpy(pk).to(dev), jd)
    if not bool(res.ok):
        raise SystemExit("rotate verification FAILED")
    return bytes(res.new_authority_set_hash.cpu().numpy())


def _program_airs(program: str, tree_size: int, max_chunks: int,
                  max_authorities: int, ed_B: int = 8):
    """The AIR set a program's statement bundle proves against, at its
    configured shapes."""
    from ..stark.air_ed25519 import Ed25519VerifyAir, dummy_sig
    from ..stark.air_header import HeaderAir
    from ..stark.air_rotate import RotateHeaderAir
    from ..stark.air_sha256_chain import ChainedSha256Air
    from ..stark.air_sha256_merkle import MerkleSha256Air

    def leaf_words(leaf: bytes):
        return [int.from_bytes(leaf[i:i + 4], "big") for i in range(0, 32, 4)]

    from ..stark.air_sha512 import Sha512ChallengeAir

    ed_air = Ed25519VerifyAir([dummy_sig()] * (1 << (ed_B - 8)), B=ed_B)
    sha512_air = Sha512ChallengeAir([], bytes(53), B=ed_B)
    chain_air = ChainedSha256Air(max_authorities)
    if program == "header_range":
        return {
            "header": HeaderAir(max_chunks),
            "range_merkle": MerkleSha256Air(
                [leaf_words(bytes(32))] * tree_size),
            "authority_chain": chain_air,
            "ed25519_shard": ed_air,
            "sha512_challenge_shard": sha512_air,
        }
    if program == "rotate":
        return {
            "rotate_header": RotateHeaderAir(max_chunks),
            "authority_chain": chain_air,
            "ed25519_shard": ed_air,
            "sha512_challenge_shard": sha512_air,
        }
    raise SystemExit(f"no circuit artifacts for program: {program}")


def build_program(program: str, tree_size: int, max_chunks: int,
                  artifacts_dir: str, config=None, warm: bool = False,
                  max_authorities: int = consts.MAX_AUTHORITY_SET_SIZE,
                  device=None) -> dict:
    """The `build` verb: write the artifacts a prove step validates
    against.

    Writes to `artifacts_dir`:
      manifest.json — per-AIR shapes (rows/cols/publics/constraints) and a
        verifying-key digest: SHA-256 over the AIR's public constant
        columns + layout, the commitment a verifier (or a future
        recursive aggregator) pins the circuit identity to.
      config.json   — the serialized StarkConfig.

    With `warm=True` additionally runs one throwaway proof per AIR shape on
    ``device`` (the current CUDA device unless named), so that the
    constant VKs, the kernel build and the allocator are ready before
    serving proves."""
    import hashlib as hl

    from ..stark import serialize
    from ..stark.prover import num_quotient_chunks

    config = config or _stark_config()
    airs = _program_airs(program, tree_size, max_chunks, max_authorities)
    os.makedirs(artifacts_dir, exist_ok=True)

    manifest = {"program": program, "tree_size": tree_size,
                "max_chunks": max_chunks, "max_authorities": max_authorities,
                "airs": {}}
    for name, air in airs.items():
        n_rows = air.n_rows
        cvals = np.asarray(air.constant_columns(n_rows), dtype=np.uint64)
        vk = hl.sha256()
        vk.update(f"{type(air).__name__}/{air.num_cols}/{n_rows}/"
                  f"{getattr(air, 'num_publics', 0)}".encode())
        vk.update(cvals.tobytes())
        vk.update(bytes(np.asarray(air.lookup_range_columns(),
                                   dtype=np.int64).tobytes()))
        manifest["airs"][name] = {
            "air": type(air).__name__,
            "rows": int(n_rows),
            "cols": int(air.num_cols),
            "publics": int(getattr(air, "num_publics", 0)),
            "constraints": int(air.num_constraints()),
            "quotient_chunks": int(num_quotient_chunks(air)),
            "lookups": len(air.lookup_range_columns()),
            "vk_sha256": vk.hexdigest(),
        }

    with open(os.path.join(artifacts_dir, "config.json"), "wb") as f:
        f.write(serialize.serialize_config(config))
    with open(os.path.join(artifacts_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)

    if warm:
        _warm_airs(airs, config, default_device(device))
    return manifest


def _warm_airs(airs: dict, config, device) -> None:
    """One throwaway prove per AIR shape that has a probe witness (the
    JAX package unpacks the missing probe of RotateHeaderAir and raises, so
    its `rotate build --warm` fails; the port skips that AIR)."""
    from ..field import goldilocks as gl
    from ..stark import prover as pv

    for name, air in airs.items():
        probe = _probe_trace(air, device)
        if probe is None:
            continue
        trace, publics = probe
        pubs = [gl.to_fp(int(p), device) for p in publics]
        pv.prove(air, trace, pubs, config)


def _probe_trace(air, device):
    """A valid witness for warming, using each AIR's own trace builder."""
    from ..stark.air_header import HeaderAir
    from ..stark.air_rotate import RotateHeaderAir
    from ..stark.air_sha256_chain import ChainedSha256Air
    from ..stark.air_sha256_merkle import MerkleSha256Air
    from ..stark.air_ed25519 import Ed25519VerifyAir

    if isinstance(air, RotateHeaderAir):
        return None          # needs a structured epoch-end header witness
    if isinstance(air, HeaderAir):
        hdr = bytes(32) + b"\x04" + bytes(32) + bytes(8) + bytes(32)
        trace, publics, _ = air.make_trace(hdr, device)
        return trace, publics
    if isinstance(air, MerkleSha256Air):
        trace, publics, _ = air.make_trace(device)
        return trace, publics
    if isinstance(air, ChainedSha256Air):
        words = ChainedSha256Air.pubkeys_to_words([b"\x01" * 32], air.n_max)
        trace, publics, _ = air.make_trace(words, 1, device)
        return trace, publics
    if isinstance(air, Ed25519VerifyAir):
        trace, _ = air.make_trace_vec(device)
        return trace, air.publics_list()
    from ..stark.air_sha512 import Sha512ChallengeAir
    if isinstance(air, Sha512ChallengeAir):
        trace, publics = air.make_trace(device)
        return trace, publics
    return None


def _genesis(source, block: Optional[int]) -> dict:
    """Deployment parameters for a trusted starting block: height, header
    hash, authority set id and hash. Keys match the env names of
    contracts/script/Deploy.s.sol."""
    import hashlib
    from ..circuits.commitments import authority_set_hash

    header = source.get_header(block)
    hash_ = hashlib.blake2b(header, digest_size=32).digest()
    set_id = source.get_authority_set_id(block)
    auths = source.get_authorities(block)
    set_hash = authority_set_hash(auths)
    return {
        "GENESIS_HEIGHT": block,
        "GENESIS_HEADER": "0x" + hash_.hex(),
        "GENESIS_AUTHORITY_SET_ID": set_id,
        "GENESIS_AUTHORITY_SET_HASH": "0x" + set_hash.hex(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vectorx_tpu_torch")
    p.add_argument("program", choices=["dummy_header_range", "dummy_rotate",
                                       "header_range", "rotate", "genesis"])
    p.add_argument("verb", nargs="?", choices=["build", "prove"])
    p.add_argument("input", nargs="?", help="input.json for prove")
    p.add_argument("--fixtures", help="offline fixture dir")
    p.add_argument("--block", type=int, help="genesis block number")
    p.add_argument("--tree-size", type=int,
                   default=consts.HEADER_RANGE_TREE_SIZE_SMALL)
    p.add_argument("--output", default="output.json")
    p.add_argument("--stark", action="store_true",
                   help="emit a full STARK bundle (default: witness-level)")
    p.add_argument("--proof", help="path for the serialized proof bundle")
    p.add_argument("--checkpoint",
                   help="checkpoint dir: persist per-unit sub-proofs so an "
                        "interrupted bundle prove resumes (SURVEY.md 5.4)")
    p.add_argument("--max-chunks", type=int,
                   help="HeaderAir Blake2b chunk capacity override")
    p.add_argument("--procs", type=int, default=1,
                   help="map-proof worker processes; needs --checkpoint")
    p.add_argument("--artifacts", help="build-artifact directory")
    p.add_argument("--warm", action="store_true",
                   help="build: also run one throwaway prove per AIR shape")
    p.add_argument("--device",
                   help="torch device of the device programs (default: the "
                        "current CUDA device; cpu for the CPU)")
    args = p.parse_args(argv)
    try:
        device = default_device(args.device)
    except RuntimeError as err:
        p.error(str(err))

    if args.program == "genesis":
        if args.block is None:
            p.error("genesis requires --block")
        with _source(args, device) as source:
            print(json.dumps(_genesis(source, args.block), indent=2))
        return 0

    if args.verb is None:
        p.error("build or prove verb required")

    if args.verb == "build":
        if args.program.startswith("dummy_"):
            print(json.dumps({"built": args.program, "airs": {}}))
            return 0
        manifest = build_program(
            args.program, args.tree_size,
            args.max_chunks or consts.MAX_HEADER_CHUNK_SIZE,
            args.artifacts or f"build/{args.program}_{args.tree_size}",
            warm=args.warm, device=device)
        print(json.dumps({"built": args.program,
                          "airs": list(manifest["airs"])}))
        return 0

    if not args.input:
        p.error("prove requires input.json")
    with _source(args, device) as source:
        out = run_program(args.program, _load_input(args.input), source,
                          args.tree_size, stark=args.stark,
                          proof_path=args.proof, max_chunks=args.max_chunks,
                          checkpoint=args.checkpoint, procs=args.procs,
                          device=device)
    result = {"output": "0x" + out.hex(), "ok": True}
    with open(args.output, "w") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return 0


@contextlib.contextmanager
def _source(args, device):
    """The CLI's chain data: ``--fixtures DIR``, else the node at
    ``AVAIL_URL`` (closed on the way out)."""
    if args.fixtures:
        yield FixtureSource(args.fixtures, device=device)
        return
    source = _live_source(device)
    try:
        yield source
    finally:
        source.close()


def _live_source(device=None) -> LiveSource:
    url = os.environ.get("AVAIL_URL")
    if not url:
        raise SystemExit("set AVAIL_URL or pass --fixtures")
    return LiveSource(url, device)


if __name__ == "__main__":
    sys.exit(main())
