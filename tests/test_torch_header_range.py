"""Port vs reference: the witness-level header_range and rotate programs.

At the JAX test's sizes (TREE = 8 slots of S = 512 bytes, MAX_N = 8
authorities), seeded headers and keys (cryptography's
``from_private_bytes`` on seeded bytes) go through the JAX package's
``verify_subchain``, ``header_range``, ``rotate`` and
``verify_epoch_end_header`` — eagerly, each once, in a module fixture —
and through the port's (torch, CPU). Every field of every result must be
equal (tolerance 0): the honest cases, a minority justification, a wrong
set hash, a broken link, a wrong block number, a range across the u32
wrap of the block numbers, and an epoch-end header whose record window
runs past the end of its buffer, where the JAX package's gather reads 255
(a port that read zeros there would accept the truncated buffer below).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from vectorx_tpu.circuits import header_range as jhr
from vectorx_tpu.circuits import justification as jjust
from vectorx_tpu.circuits import rotate as jrot
from vectorx_tpu.parallel import subchain as jsub
from vectorx_tpu_torch.circuits import commitments, header_range as hr
from vectorx_tpu_torch.circuits import justification as just
from vectorx_tpu_torch.circuits import rotate as rot
from vectorx_tpu_torch.circuits import scale
from vectorx_tpu_torch.parallel import subchain

torch.set_num_threads(1)

MAX_N = 8
TREE = 8
S = 512
U32 = 1 << 32


def _keys(n, rng):
    keys = [Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
            for _ in range(n)]
    return keys, [k.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        for k in keys]


def _chain(rng, trusted_hash, trusted_block, n, size=300, numbers=None):
    """Chained SCALE-shaped headers -> (headers, hash of the last)."""
    headers, parent = [], trusted_hash
    for i in range(n):
        bn = numbers[i] if numbers else (trusted_block + 1 + i) % U32
        body = parent + scale.encode_compact_u32(bn) + rng.bytes(32)
        hdr = body + rng.bytes(size - len(body) - 32) + rng.bytes(32)
        headers.append(hdr)
        parent = hashlib.blake2b(hdr, digest_size=32).digest()
    return headers, parent


def _record(keys, pubs, block_hash, block_number, set_id, n_sign):
    """The indexer's record fields of a justification."""
    msg = scale.encode_precommit_bytes(block_hash, block_number, 1, set_id)
    sigs = [k.sign(msg).hex() if i < n_sign else bytes(64).hex()
            for i, k in enumerate(keys)]
    return ([p.hex() for p in pubs], sigs, [i < n_sign for i in range(len(keys))],
            len(keys), msg)


def _header_range_case(seed, trusted_block=1000, n=5, n_auth=4, n_sign=None,
                       wrong_set=False, break_link=False, bad_number=False):
    rng = np.random.default_rng(seed)
    trusted_hash = rng.bytes(32)
    numbers = [(trusted_block + 1 + i) % U32 for i in range(n)]
    if bad_number:
        numbers[2] += 1
    headers, target_hash = _chain(rng, trusted_hash, trusted_block, n,
                                  numbers=numbers)
    if break_link:
        h = bytearray(headers[3])
        h[5] ^= 1
        headers[3] = bytes(h)
    keys, pubs = _keys(n_auth, rng)
    target = (trusted_block + n) % U32
    rec = _record(keys, pubs, target_hash, target, 9,
                  n_auth if n_sign is None else n_sign)
    set_hash = (bytes(32) if wrong_set
                else commitments.authority_set_hash(pubs))
    buf, sizes = subchain.pack_headers(headers, TREE, S)
    return dict(trusted=trusted_block, trusted_hash=trusted_hash,
                set_id=9, set_hash=set_hash, target=target, buf=buf,
                sizes=sizes, rec=rec, n=n)


def _epoch_end_header(rng, new_pubs, tail=b""):
    """A header whose digest holds a ScheduledChange for new_pubs, with
    `tail` after the log -> (header, start_position)."""
    validators = b"".join(p + b"\x01" + bytes(7) for p in new_pubs)
    sched = (b"\x01" + scale.encode_compact_u32(len(new_pubs)) + validators
             + bytes(4))
    log = b"\x04" + b"FRNK" + scale.encode_compact_u32(len(sched)) + sched
    body = rng.bytes(32) + scale.encode_compact_u32(123) + rng.bytes(32)
    filler = rng.bytes(40)
    return body + filler + b"\x00" + log + tail, len(body) + len(filler)


def _rotate_case(seed, n_new, padded_to=None):
    """padded_to: the buffer's size (None: the header zero-padded to whole
    128-byte chunks, as the CLI pads it)."""
    rng = np.random.default_rng(seed)
    keys, pubs = _keys(4, rng)
    _, new_pubs = _keys(n_new, rng)
    tail = rng.bytes(S - 64 - 150 - 40 * n_new) if padded_to else b""
    hdr, start = _epoch_end_header(rng, new_pubs, tail)
    size = padded_to or len(hdr) + (-len(hdr)) % 128
    hb = np.zeros((size,), np.uint8)
    hb[:len(hdr)] = np.frombuffer(hdr, np.uint8)
    pk = np.zeros((MAX_N, 32), np.uint8)
    for i, p in enumerate(new_pubs):
        pk[i] = np.frombuffer(p, np.uint8)
    target_hash = hashlib.blake2b(hdr, digest_size=32).digest()
    rec = _record(keys, pubs, target_hash, 4321, 10, 4)
    return dict(set_id=10, set_hash=commitments.authority_set_hash(pubs),
                block=4321, hb=hb, size=len(hdr), n_new=n_new, start=start,
                pk=pk, rec=rec, new_hash=commitments.authority_set_hash(new_pubs))


HR_CASES = {
    "honest": dict(seed=1),
    "minority": dict(seed=2, n_auth=6, n_sign=4),
    "wrong_set_hash": dict(seed=3, wrong_set=True),
    "broken_link": dict(seed=4, break_link=True),
    "wrong_block_number": dict(seed=5, bad_number=True),
    "u32_wrap": dict(seed=6, trusted_block=U32 - 3),
}
ROT_CASES = {
    "honest": dict(seed=7, n_new=5, padded_to=S),
    "window_past_end": dict(seed=8, n_new=2),
}
HR_OK = {"honest": True, "u32_wrap": True}


def _jax_justification(rec):
    return jjust.prepare_justification(*rec, MAX_N)


def _u8(raw):
    return jnp.asarray(np.frombuffer(raw, np.uint8))


def _jax_header_range(c):
    return jhr.header_range(
        jnp.uint32(c["trusted"]), _u8(c["trusted_hash"]),
        (jnp.uint32(c["set_id"]), jnp.uint32(0)), _u8(c["set_hash"]),
        jnp.uint32(c["target"]), jnp.asarray(c["buf"]),
        jnp.asarray(c["sizes"]), _jax_justification(c["rec"]))


def _jax_rotate(c):
    return jhr.rotate(
        (jnp.uint32(c["set_id"]), jnp.uint32(0)), _u8(c["set_hash"]),
        jnp.uint32(c["block"]), jnp.asarray(c["hb"]), jnp.int32(c["size"]),
        jnp.int32(c["n_new"]), jnp.int32(c["start"]), jnp.asarray(c["pk"]),
        _jax_justification(c["rec"]))


def _np(result):
    return {k: np.asarray(v) for k, v in result._asdict().items()}


@pytest.fixture(scope="module")
def ref():
    hr_cases = {k: _header_range_case(**v) for k, v in HR_CASES.items()}
    rot_cases = {k: _rotate_case(**v) for k, v in ROT_CASES.items()}
    c = hr_cases["honest"]
    out = dict(hr_cases=hr_cases, rot_cases=rot_cases,
               subchain=_np(jsub.verify_subchain(
                   jnp.asarray(c["buf"]), jnp.asarray(c["sizes"]),
                   jnp.int32(c["n"]), _u8(c["trusted_hash"]),
                   jnp.uint32(c["trusted"]))),
               hr={k: _np(_jax_header_range(v)) for k, v in hr_cases.items()},
               rot={k: _np(_jax_rotate(v)) for k, v in rot_cases.items()})
    short = _short_epoch_case(rot_cases["window_past_end"])
    out["short"] = bool(jrot.verify_epoch_end_header(
        jnp.asarray(short["hb"]), jnp.int32(short["n_new"]),
        jnp.int32(short["start"]), jnp.asarray(short["pk"])))
    return out


def _short_epoch_case(c):
    """The same header cut where its delay bytes start: the delay window
    lies past the buffer."""
    delay_at = c["size"] - 4
    return dict(c, hb=c["hb"][:delay_at])


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_justification(rec):
    return just.prepare_justification(*rec, MAX_N, device="cpu")


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        g = (g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g))
        assert np.array_equal(g.astype(np.int64), v.astype(np.int64)), k


def test_verify_subchain_equals_reference(ref):
    c = ref["hr_cases"]["honest"]
    got = subchain.verify_subchain(_t(c["buf"]), _t(c["sizes"]), c["n"],
                                   _t(np.frombuffer(c["trusted_hash"], np.uint8)),
                                   c["trusted"])
    _same(got._asdict(), ref["subchain"])
    assert bool(got.links_ok) and bool(got.blocks_sequential)


@pytest.mark.parametrize("name", list(HR_CASES))
def test_header_range_equals_reference(ref, name):
    c = ref["hr_cases"][name]
    got = hr.header_range(
        c["trusted"], _t(np.frombuffer(c["trusted_hash"], np.uint8)),
        (c["set_id"], 0), _t(np.frombuffer(c["set_hash"], np.uint8)),
        c["target"], _t(c["buf"]), _t(c["sizes"]),
        _port_justification(c["rec"]))
    _same(got._asdict(), ref["hr"][name])
    assert bool(got.ok) == HR_OK.get(name, False)


@pytest.mark.parametrize("name", list(ROT_CASES))
def test_rotate_equals_reference(ref, name):
    c = ref["rot_cases"][name]
    got = hr.rotate((c["set_id"], 0), _t(np.frombuffer(c["set_hash"], np.uint8)),
                    c["block"], _t(c["hb"]), c["size"], c["n_new"], c["start"],
                    _t(c["pk"]), _port_justification(c["rec"]))
    _same(got._asdict(), ref["rot"][name])
    assert bool(got.ok)
    assert bytes(got.new_authority_set_hash.numpy()) == c["new_hash"]


def test_window_past_end_reads_the_fill(ref):
    """The record window of the honest two-key case runs past the end of
    its buffer: the bytes read there are 255, as the reference reads them."""
    c = ref["rot_cases"]["window_past_end"]
    start = c["start"] + 13                  # the records' first byte
    window = rot._window(_t(c["hb"])[None], torch.tensor([start]),
                         MAX_N * 40 + 4)[0]
    inside = len(c["hb"]) - start
    assert 0 < inside < MAX_N * 40 + 4
    assert bool((window[inside:] == 255).all())
    assert bytes(window[:inside].numpy()) == c["hb"][start:].tobytes()


def test_epoch_end_delay_past_the_buffer_is_rejected(ref):
    c = _short_epoch_case(ref["rot_cases"]["window_past_end"])
    got = rot.verify_epoch_end_header(_t(c["hb"]), c["n_new"], c["start"],
                                      _t(c["pk"]))
    assert ref["short"] is False
    assert bool(got) is False
