"""Recorded outputs of the frozen JAX package for the port's parity tests.

``record.py`` writes one JSON file per test module; the tests read it with
``load``. A value is plain JSON (ints, lists, strings, booleans), an
integer array as ``array`` records it (its shape and the SHA-256 of its
values), a small array as ``values`` records it (in full), or a proof
payload as ``payload`` records it (one SHA-256 per
uint32 plane of the JAX package's StarkProof, in leaf order, under the
plane's path in the proof). Both sides compute these encodings with the
functions here, so an equal encoding means equal values.
"""

from __future__ import annotations

import base64
import functools
import hashlib
import json
import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[1]


def _feed(h, x) -> None:
    if isinstance(x, (bytes, bytearray)):
        h.update(b"B%d:" % len(x))
        h.update(bytes(x))
    elif isinstance(x, str):
        _feed(h, x.encode())
        h.update(b"S")
    elif isinstance(x, (bool, np.bool_)):
        h.update(b"T" if x else b"F")
    elif isinstance(x, (int, np.integer)):
        h.update(b"I%d;" % int(x))
    elif x is None:
        h.update(b"N")
    elif isinstance(x, np.ndarray):
        h.update(b"A%s" % str(x.shape).encode())
        _feed(h, [int(v) for v in x.ravel()])
    elif isinstance(x, (list, tuple)):
        h.update(b"L%d[" % len(x))
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(x, dict):
        _feed(h, sorted((str(k), v) for k, v in x.items()))
    else:
        raise TypeError(f"no input digest for {type(x).__name__}")


def inputs_digest(inputs) -> str:
    """SHA-256 of nested bytes, ints, strings, lists, dicts and integer
    arrays (an array counts as its shape and values, not its dtype)."""
    h = hashlib.sha256()
    _feed(h, inputs)
    return h.hexdigest()


def array(a) -> dict:
    """An integer array as recorded: shape and SHA-256 of its values as
    little-endian uint64 in C order (negative int64 values wrap)."""
    a = np.asarray(a)
    if a.dtype == object:
        a = np.array([int(v) % (1 << 64) for v in a.ravel()],
                     dtype=np.uint64).reshape(a.shape)
    u = np.ascontiguousarray(a.astype("<u8", copy=False))
    return {"shape": list(u.shape),
            "sha256": hashlib.sha256(u.tobytes()).hexdigest()}


def values(a) -> dict:
    """A small array recorded in full: dtype, shape and values."""
    a = np.asarray(a)
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "values": a.ravel().tolist()}


def from_values(rec: dict) -> np.ndarray:
    """The array that ``values`` recorded."""
    return np.array(rec["values"], dtype=rec["dtype"]).reshape(rec["shape"])


def u64(fp) -> np.ndarray:
    """A JAX (lo, hi) uint32 pair as uint64."""
    return (np.asarray(fp[0]).astype(np.uint64)
            | (np.asarray(fp[1]).astype(np.uint64) << np.uint64(32)))


def machine(jout, consts=True, trace=False) -> dict:
    """What the tests compare of a JAX RecursionAir `jout`: rows, shape,
    publics and schedule digest; the constant columns and make_trace if
    asked."""
    out = {"rows": len(jout.mb.rows),
           "shape": [int(jout.n_rows), int(jout.K), int(jout.num_cols),
                     int(jout.num_consts), bool(jout.has_ram)],
           "publics": [int(p) for p in jout.mb.publics],
           "schedule_digest": jout.schedule_digest()}
    if consts:
        out["constant_columns"] = array(jout.constant_columns(jout.n_rows))
    if trace:
        t, pubs = jout.make_trace()
        out["trace_publics"] = [int(p) for p in pubs]
        out["trace"] = array(u64(t))
    return out


def payload(planes, names, data: bool = False) -> dict:
    """A proof payload as recorded: [path, dtype, shape, SHA-256] for each
    plane of the proof in leaf order; with `data`, the bytes as well
    (base64), for the tests that rebuild the proof."""
    planes = [np.ascontiguousarray(np.asarray(p)) for p in planes]
    out = {"fields": [[name, p.dtype.str, list(p.shape),
                       hashlib.sha256(p.tobytes()).hexdigest()]
                      for name, p in zip(names, planes)]}
    if data:
        out["data"] = base64.b64encode(
            b"".join(p.tobytes() for p in planes)).decode()
    return out


def _field_nbytes(field) -> int:
    _, dtype, shape, _ = field
    return np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64))


def payload_fields(data: bytes, like: dict) -> list:
    """`data` (a port payload) cut where the recorded payload `like` cuts
    its planes: [path, dtype, shape, SHA-256] for each, and the rest of
    `data`, if any, as one more field named "<trailing bytes>"."""
    out, off = [], 0
    for field in like["fields"]:
        n = _field_nbytes(field)
        out.append(field[:3] + [hashlib.sha256(data[off:off + n]).hexdigest()])
        off += n
    if off != len(data):
        out.append(["<trailing bytes>", "", [len(data) - off], ""])
    return out


def payload_planes(like: dict) -> list:
    """The recorded planes (a payload recorded with `data`), in leaf order."""
    raw = base64.b64decode(like["data"])
    planes, off = [], 0
    for field in like["fields"]:
        n = _field_nbytes(field)
        planes.append(np.frombuffer(raw[off:off + n], dtype=field[1])
                      .reshape(field[2]))
        off += n
    return planes


SOURCES = ("vectorx_tpu/**/*.py", "native/*.cpp")


@functools.lru_cache(maxsize=None)
def vectorx_tpu_sources() -> str:
    """SHA-256 of the JAX package's sources as they are on disk: the sorted
    paths (relative to the repo) and bytes of every file ``SOURCES`` names.
    Uncommitted edits count, and no git checkout is needed."""
    h = hashlib.sha256()
    files = sorted({f for pattern in SOURCES for f in REPO.glob(pattern)
                    if f.is_file()})
    for f in files:
        _feed(h, [f.relative_to(REPO).as_posix(), f.read_bytes()])
    return h.hexdigest()


def path_of(module: str, directory=HERE) -> pathlib.Path:
    return pathlib.Path(directory) / f"{module}.json"


def read(module: str, directory=HERE) -> dict:
    return json.loads(path_of(module, directory).read_text())


def load(module: str, inputs) -> dict:
    """The values recorded for test module `module`, after checking that
    `inputs` are the ones they were recorded from and that the JAX
    package's sources are the ones that recorded them."""
    rec = read(module)
    assert inputs_digest(inputs) == rec["inputs_sha256"], (
        f"{module}: the inputs differ from the recorded ones; rerun "
        f"{rec['command']}")
    assert vectorx_tpu_sources() == rec["vectorx_tpu_sources_sha256"], (
        f"{module}: the sources of vectorx_tpu differ from those that "
        f"recorded it; rerun {rec['command']}")
    return rec["values"]
