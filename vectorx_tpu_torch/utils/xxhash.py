"""Pure-Python xxHash64 and substrate's twox128 — storage-key hashing.

Substrate storage keys are ``twox128(pallet) ++ twox128(item)`` where
twox128(x) = xxhash64(x, seed=0) || xxhash64(x, seed=1), both little-endian
(the live source reads ``Grandpa.CurrentSetId`` by its raw key). Host ints
only.
"""

from __future__ import annotations

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, inp: int) -> int:
    acc = (acc + inp * _P2) & _M
    acc = _rotl(acc, 31)
    return (acc * _P1) & _M


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return ((acc * _P1) + _P4) & _M


def xxhash64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    idx = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        while idx <= n - 32:
            v1 = _round(v1, int.from_bytes(data[idx:idx + 8], "little")); idx += 8
            v2 = _round(v2, int.from_bytes(data[idx:idx + 8], "little")); idx += 8
            v3 = _round(v3, int.from_bytes(data[idx:idx + 8], "little")); idx += 8
            v4 = _round(v4, int.from_bytes(data[idx:idx + 8], "little")); idx += 8
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while idx <= n - 8:
        h ^= _round(0, int.from_bytes(data[idx:idx + 8], "little"))
        h = ((_rotl(h, 27) * _P1) + _P4) & _M
        idx += 8
    if idx <= n - 4:
        h ^= (int.from_bytes(data[idx:idx + 4], "little") * _P1) & _M
        h = ((_rotl(h, 23) * _P2) + _P3) & _M
        idx += 4
    while idx < n:
        h ^= (data[idx] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        idx += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def twox128(data: bytes) -> bytes:
    return (xxhash64(data, 0).to_bytes(8, "little")
            + xxhash64(data, 1).to_bytes(8, "little"))


def storage_key(pallet: str, item: str) -> bytes:
    return twox128(pallet.encode()) + twox128(item.encode())
