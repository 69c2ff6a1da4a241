"""Ed25519: the curve constants (host, exact Python ints) and the batched
verification on the device.

The justification check verifies up to 300 signatures over one 53-byte
precommit message as ONE batched tensor program: point coordinates are
(batch, 16)-limb tensors (``field/field25519.py``), a scalar
multiplication is 64 steps of four doubles and one add with a 4-bit window
whose table lookup is a gather, and the EdDSA challenge
h = SHA-512(R || A || M) mod L is the batched SHA-512 followed by the
device's reduction mod L (``field/scalar25519.py``).

Verification equation (cofactorless, as ed25519-dalek's ``verify``):

    [s]B == R + [h]A,   h = SHA-512(R || A || M) mod L

Doubling and addition: extended twisted-Edwards coordinates (X:Y:Z:T),
a = -1 (dbl-2008-hwcd / add-2008-hwcd-3). Every function follows its
inputs' device; its limbs equal the JAX package's limb for limb.

``verify_host`` is one RFC 8032 verification on Python ints (no
dependency): the indexer's host route.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import default_device
from ..field import field25519 as fe
from ..field import scalar25519 as sc
from ..hashes import sha512 as s512

P = (1 << 255) - 19
L_ORDER = (1 << 252) + 27742317777372353535851937790883648493
D_CONST = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# base point
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int:
    u = (y * y - 1) % P
    v = (D_CONST * y * y + 1) % P
    x = (u * pow(v, 3, P)) % P * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P) % P
    if (v * x * x) % P == (-u) % P:
        x = (x * SQRT_M1) % P
    assert (v * x * x) % P == u % P
    if x % 2 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)


class Point(NamedTuple):
    """Extended coordinates, each (..., 16) limbs."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(shape, device=None) -> Point:
    return Point(fe.zeros(shape, device), fe.const(shape, 1, device),
                 fe.const(shape, 1, device), fe.zeros(shape, device))


def base_point(shape, device=None) -> Point:
    return Point(fe.const(shape, _BX, device), fe.const(shape, _BY, device),
                 fe.const(shape, 1, device),
                 fe.const(shape, _BX * _BY % P, device))


def point_add(p: Point, q: Point) -> Point:
    a = fe.mul(fe.sub(p.y, p.x), fe.sub(q.y, q.x))
    b = fe.mul(fe.add(p.y, p.x), fe.add(q.y, q.x))
    c = fe.mul(fe.mul_small(fe.mul(p.t, q.t), 2),
               fe.const(p.x.shape[:-1], D_CONST, p.x.device))
    d = fe.mul_small(fe.mul(p.z, q.z), 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_double(p: Point) -> Point:
    a = fe.square(p.x)
    b = fe.square(p.y)
    c = fe.mul_small(fe.square(p.z), 2)
    e = fe.sub(fe.sub(fe.square(fe.add(p.x, p.y)), a), b)
    g = fe.sub(b, a)
    f = fe.sub(g, c)
    h = fe.sub(torch.zeros_like(p.x), fe.add(a, b))
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_select(mask: torch.Tensor, p: Point, q: Point) -> Point:
    return Point(*(fe.select(mask, a, b) for a, b in zip(p, q)))


def scalar_mul_binary(p: Point, bits: torch.Tensor) -> Point:
    """[k]P, binary double-and-add (256 doubles + 256 conditional adds).
    bits: (..., 256) LSB-first."""
    acc = identity(p.x.shape[:-1], p.x.device)
    base = p
    for i in range(bits.shape[-1]):
        acc = point_select(bits[..., i].bool(), point_add(acc, base), acc)
        base = point_double(base)
    return acc


def scalar_mul(p: Point, bits: torch.Tensor) -> Point:
    """[k]P via a 4-bit window: the table T[k] = [k]P, k = 0..15 (T[0] the
    identity, T[k] = T[k-1] + P), then 64 x (4 doubles + 1 add), the
    digit's entry gathered along the table axis. bits: (..., 256)
    LSB-first."""
    shape = p.x.shape[:-1]
    entry = identity(shape, p.x.device)
    entries = []
    for _ in range(16):
        entries.append(torch.stack(entry, dim=-2))      # (..., 4, 16)
        entry = point_add(entry, p)
    table = torch.stack(entries, dim=-3)                # (..., 16, 4, 16)

    b4 = bits.reshape(bits.shape[:-1] + (64, 4)).to(torch.int64)
    digits = b4[..., 0] | (b4[..., 1] << 1) | (b4[..., 2] << 2) | (b4[..., 3] << 3)
    digits = torch.flip(digits, dims=(-1,))             # MSB-first

    acc = identity(shape, p.x.device)
    for i in range(64):
        for _ in range(4):
            acc = point_double(acc)
        idx = digits[..., i, None, None, None].expand(shape + (1, 4, fe.NLIMB))
        acc = point_add(acc, Point(*torch.gather(table, -3, idx)[..., 0, :, :]
                                   .unbind(-2)))
    return acc


def bytes_to_bits_le(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) LSB-first bits (int64)."""
    shifts = torch.arange(8, device=b.device)
    bits = (b[..., :, None].to(torch.int64) >> shifts) & 1
    return bits.reshape(b.shape[:-1] + (256,))


def bytes_to_limbs_le(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> (..., 16) 16-bit limbs."""
    b = b.to(torch.int64)
    return b[..., 0::2] | (b[..., 1::2] << 8)


def limbs_to_bytes_le(l: torch.Tensor) -> torch.Tensor:
    return torch.stack([l & 0xFF, (l >> 8) & 0xFF], dim=-1).reshape(
        l.shape[:-1] + (32,)).to(torch.uint8)


def decompress(compressed: torch.Tensor):
    """(..., 32) uint8 compressed points -> (Point, valid flag)."""
    sign = compressed[..., 31].to(torch.int64) >> 7
    y_bytes = compressed.clone()
    y_bytes[..., 31] &= 0x7F
    y = bytes_to_limbs_le(y_bytes)
    y_valid = ~fe._ge_p(y)
    y = fe.canonicalize(y)

    shape, dev = y.shape[:-1], y.device
    one = fe.const(shape, 1, dev)
    y2 = fe.square(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(y2, fe.const(shape, D_CONST, dev)), one)

    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))

    vxx = fe.mul(v, fe.square(x))
    ok_direct = fe.eq(vxx, u)
    ok_flip = fe.eq(vxx, fe.sub(torch.zeros_like(u), u))
    x_flipped = fe.mul(x, fe.const(shape, SQRT_M1, dev))
    x = fe.select(ok_direct, x, x_flipped)
    valid = y_valid & (ok_direct | ok_flip)

    # x = 0 with sign bit set is invalid
    valid = valid & ~(fe.is_zero(x) & (sign == 1))

    # choose sign (parity needs the canonical representative)
    x = fe.canonicalize(fe.canonicalize(x))
    x_neg = fe.canonicalize(fe.canonicalize(fe.sub(torch.zeros_like(x), x)))
    x = fe.select((x[..., 0] & 1) != sign, x_neg, x)

    return Point(x, y, one, fe.mul(x, y)), valid


def point_eq(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    return (fe.eq(fe.mul(p.x, q.z), fe.mul(q.x, p.z))
            & fe.eq(fe.mul(p.y, q.z), fe.mul(q.y, p.z)))


def verify_batch(pubkeys: torch.Tensor, r_bytes: torch.Tensor,
                 s_bytes: torch.Tensor, h_bytes: torch.Tensor,
                 enabled: torch.Tensor) -> torch.Tensor:
    """Batched cofactorless EdDSA check.

    pubkeys/r_bytes/s_bytes/h_bytes: (n, 32) uint8 (h = SHA512(R||A||M)
    mod L, LE). enabled: (n,) bool — disabled lanes return True (the
    conditional verification of padding signatures). Each lane's limbs
    are those of the JAX package's two decompressions and two scalar
    muls; here each pair runs as one batch of 2n lanes.
    """
    n = pubkeys.shape[0]
    # A and R decompress as one batch; [s]B and [h]A as one scalar mul
    pts, valid = decompress(torch.cat([pubkeys, r_bytes]))
    base = base_point((n,), pubkeys.device)
    prods = scalar_mul(Point(*(torch.cat([b, a[:n]]) for b, a in zip(base, pts))),
                       bytes_to_bits_le(torch.cat([s_bytes, h_bytes])))
    lhs = Point(*(c[:n] for c in prods))                          # [s]B
    rhs = point_add(Point(*(c[n:] for c in pts)),                 # R + [h]A
                    Point(*(c[n:] for c in prods)))

    ok = valid[:n] & valid[n:] & point_eq(lhs, rhs)
    return torch.where(enabled, ok, torch.ones_like(ok))


def compute_challenges(r_list, a_list, msg: bytes, device=None) -> np.ndarray:
    """h = SHA512(R || A || M) mod L for each signature -> (n, 32) uint8 LE:
    the batched SHA-512, then the reduction mod L, on the current CUDA
    device unless ``device`` names another."""
    msgs = [bytes(r) + bytes(a) + msg for r, a in zip(r_list, a_list)]
    digests = s512.sha512_bytes(msgs, device)
    d = torch.from_numpy(np.stack([np.frombuffer(x, np.uint8) for x in digests]))
    return sc.sc_reduce512(d.to(default_device(device))).cpu().numpy()


# ---------------------------------------------------------------------------
# One signature on the host (exact Python ints)
# ---------------------------------------------------------------------------

HostPoint = Tuple[int, int, int, int]


def _host_add(p: HostPoint, q: HostPoint) -> HostPoint:
    """Extended-coordinate addition, a = -1 (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D_CONST * t1 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _host_mul(k: int, pt: HostPoint) -> HostPoint:
    acc = (0, 1, 1, 0)
    while k:
        if k & 1:
            acc = _host_add(acc, pt)
        pt = _host_add(pt, pt)
        k >>= 1
    return acc


def _host_encode(pt: HostPoint) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _host_decode(raw: bytes) -> Optional[HostPoint]:
    """RFC 8032 point decoding; None for an encoding of no point."""
    y = int.from_bytes(raw, "little")
    sign, y = y >> 255, y & ((1 << 255) - 1)
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D_CONST * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    if v * x * x % P == -u % P:
        x = x * SQRT_M1 % P
    if v * x * x % P != u or (x == 0 and sign):
        return None
    if x % 2 != sign:
        x = P - x
    return x, y, 1, x * y % P


def verify_host(pubkey: bytes, signature: bytes, msg: bytes) -> bool:
    """RFC 8032 Ed25519 verification of one signature: s < L and
    encode([s]B - [h]A) == R, h = SHA-512(R || A || M) mod L."""
    if len(pubkey) != 32 or len(signature) != 64:
        return False
    a = _host_decode(pubkey)
    s = int.from_bytes(signature[32:], "little")
    if a is None or s >= L_ORDER:
        return False
    h = int.from_bytes(hashlib.sha512(signature[:32] + pubkey + msg).digest(),
                       "little") % L_ORDER
    minus_a = (P - a[0], a[1], a[2], P - a[3])
    r = _host_add(_host_mul(s, (_BX, _BY, 1, _BX * _BY % P)),
                  _host_mul(h, minus_a))
    return _host_encode(r) == signature[:32]
