"""Ed25519 (RFC 8032) on Python ints, and the public values of a shard of
signature lanes as the Ed25519 statement states them.

A lane is (A, R, s, h): the signer's compressed key, the signature's R,
its scalar s and the challenge h = SHA-512(R | A | M) mod L. A lane
holds when A and R decode and [s]B == R + [h]A (the cofactorless
equation). A shard of 2^(B-8) lanes is padded with the disabled lane
(B, identity, 0, 0), which holds for any message. Its public values are
the lane count and the eight big-endian 32-bit words of SHA-256 over
A | R | s (32 bytes LE) | h (32 bytes LE) of every lane.

``sign`` makes the benchmark's signatures (RFC 8032 5.1.6), ``verify``
checks them (5.1.7, cofactorless).

The rest of the statement is its constant columns: each lane of a shard
of 2^B rows owns a block of 256 rows, the setup row 0 (decompress A),
the ladder rows 1-253 (one bit of s and of h each, from the top bit
252 down to bit 0) and the final row 254 (decompress R); row 255 is
idle. ``constant_columns`` lays them out.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_BY = 4 * pow(5, P - 2, P) % P

Point = Tuple[int, int, int, int]          # extended (X, Y, Z, T), a = -1
Lane = Tuple[bytes, bytes, int, int]


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if x & 1 != sign:
        x = P - x
    return x


BASE: Point = (_recover_x(_BY, 0), _BY, 1, _recover_x(_BY, 0) * _BY % P)
IDENTITY: Point = (0, 1, 1, 0)


def add(p1: Point, p2: Point) -> Point:
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def mul(k: int, pt: Point) -> Point:
    acc = IDENTITY
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def equal(p1: Point, p2: Point) -> bool:
    x1, y1, z1, _ = p1
    x2, y2, z2, _ = p2
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def encode(pt: Point) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decode(raw: bytes) -> Optional[Point]:
    v = int.from_bytes(raw, "little")
    y, sign = v & ((1 << 255) - 1), v >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return x, y, 1, x * y % P


def _h512(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def public_key(seed: bytes) -> bytes:
    digest = hashlib.sha512(seed).digest()
    a = int.from_bytes(digest[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    return encode(mul(a, BASE))


def sign(seed: bytes, msg: bytes) -> Tuple[bytes, bytes]:
    """-> (public key, 64-byte signature R | S) of a 32-byte seed."""
    digest = hashlib.sha512(seed).digest()
    a = int.from_bytes(digest[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    pub = encode(mul(a, BASE))
    r = _h512(digest[32:], msg) % L
    r_enc = encode(mul(r, BASE))
    k = _h512(r_enc, pub, msg) % L
    return pub, r_enc + ((r + k * a) % L).to_bytes(32, "little")


def challenge(r_enc: bytes, pub: bytes, msg: bytes) -> int:
    return _h512(r_enc, pub, msg) % L


def lane_holds(lane: Lane) -> bool:
    a_enc, r_enc, s, h = lane
    a, r = decode(a_enc), decode(r_enc)
    if a is None or r is None or not (0 <= s < L and 0 <= h < L):
        return False
    return equal(mul(s, BASE), add(r, mul(h, a)))


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    return lane_holds((pub, sig[:32], s, challenge(sig[:32], pub, msg)))


def dummy_lane() -> Lane:
    return encode(BASE), encode(IDENTITY), 0, 0


def lanes(pubkeys: Sequence[bytes], signatures: Sequence[Optional[bytes]],
          msg: bytes) -> List[Lane]:
    """A justification's lanes: a signed slot's (A, R, s, h), the
    disabled lane for an unsigned one."""
    out = []
    for pub, sig in zip(pubkeys, signatures):
        if sig is None:
            out.append(dummy_lane())
        else:
            out.append((pub, sig[:32], int.from_bytes(sig[32:], "little"),
                        challenge(sig[:32], pub, msg)))
    return out


def shard_publics(shard: Sequence[Lane], n_lanes: int) -> List[int]:
    padded = list(shard) + [dummy_lane()] * (n_lanes - len(shard))
    h = hashlib.sha256()
    for a, r, s, c in padded:
        h.update(a + r + s.to_bytes(32, "little") + c.to_bytes(32, "little"))
    d = h.digest()
    return [n_lanes] + [int.from_bytes(d[4 * i:4 * i + 4], "big")
                        for i in range(8)]


LANE_ROWS, LADDER_ROWS = 256, 253


def _y_sign(enc: bytes) -> Tuple[int, int]:
    v = int.from_bytes(enc, "little")
    return v & ((1 << 255) - 1), v >> 255


def constant_columns(shard: Sequence[Lane], bits: int) -> np.ndarray:
    """The constant columns of a shard of 2^bits rows: selectors of the
    setup, ladder, final, decompression and carry rows; the ladder row's
    one-hot choice of (bit of s, bit of h): 00, 01 (s), 10 (h), 11; the
    sign bit of the point decompressed on the row; then y of that point in
    ceil(255 / bits) limbs of ``bits`` bits, A's on rows 0-253 of the
    lane, R's on row 254."""
    limbs, mask = -(-255 // bits), (1 << bits) - 1
    n = 1 << bits
    padded = list(shard) + [dummy_lane()] * ((n >> 8) - len(shard))
    out = np.zeros((10 + limbs, n), dtype=np.uint64)
    ladder = np.arange(1, LADDER_ROWS + 1)
    for k, (a_enc, r_enc, s, h) in enumerate(padded):
        b0 = k * LANE_ROWS
        fin = b0 + LADDER_ROWS + 1
        (ya, sign_a), (yr, sign_r) = _y_sign(a_enc), _y_sign(r_enc)
        out[0, b0] = out[3, b0] = 1
        out[2, fin] = out[3, fin] = 1
        out[9, b0], out[9, fin] = sign_a, sign_r
        out[4, b0:b0 + LADDER_ROWS] = 1
        out[1, b0 + ladder] = 1
        bs = np.array([(s >> t) & 1 for t in range(LADDER_ROWS - 1, -1, -1)])
        bh = np.array([(h >> t) & 1 for t in range(LADDER_ROWS - 1, -1, -1)])
        for col, (want_s, want_h) in zip((5, 6, 7, 8),
                                         ((0, 0), (1, 0), (0, 1), (1, 1))):
            out[col, b0 + ladder] = (bs == want_s) & (bh == want_h)
        for i in range(limbs):
            out[10 + i, b0:fin] = (ya >> (bits * i)) & mask
            out[10 + i, fin] = (yr >> (bits * i)) & mask
    return out
