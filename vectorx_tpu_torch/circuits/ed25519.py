"""Ed25519 curve constants (host side, exact Python ints).

The constants and the x-recovery that the SHA-512 challenge AIR
(stark/air_sha512.py) and the lane helpers (stark/air_ed25519.py) need.
The batched point arithmetic of this module's JAX counterpart (extended
twisted-Edwards coordinates over 16-limb field elements, the batched
verification [s]B == R + [h]A) follows in the next slice of the port,
together with field25519.
"""

from __future__ import annotations

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
