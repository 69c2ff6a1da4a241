"""Ed25519 signature lanes — the host helpers shared with the SHA-512
challenge AIR.

A signature lane is (a_bytes, r_bytes, s, h): compressed public key,
compressed R, scalar s and challenge h. This module holds the point
(de)compression on Python ints and the disabled-lane filler;
``Ed25519VerifyAir`` itself (the in-STARK check [s]B − [h]A == R over the
limb gadgets) follows in the next slice of the port.
"""

from __future__ import annotations

from typing import Tuple

from ..circuits.ed25519 import P, _BX, _BY, _recover_x

BX, BY = _BX, _BY


def decompress_host(comp: bytes) -> Tuple[int, int, int]:
    """Compressed 32B -> (x, y, sign); asserts validity (honest witness)."""
    v = int.from_bytes(comp, "little")
    y = v & ((1 << 255) - 1)
    sign = v >> 255
    assert y < P, "non-canonical y"
    x = _recover_x(y, sign)
    assert not (x == 0 and sign == 1)
    return x, y, sign


def compress_host(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def dummy_sig() -> Tuple[bytes, bytes, int, int]:
    """Disabled-lane filler satisfying the signature check unconditionally:
    [0]B == O + [0]B (VectorX pads with dummy keys/sigs the same way)."""
    a = compress_host(BX, BY)
    r = compress_host(0, 1)     # identity
    return (a, r, 0, 0)
