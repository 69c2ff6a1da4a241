"""Checkpoint/resume for long multi-proof bundles.

A bundle is many independent sub-proofs; a crash (preemption, OOM,
restart) must not restart the whole batch. Each sub-proof is persisted
under a key that binds its full identity — unit inputs, AIR label and the
serialized StarkConfig — so a checkpoint can never be replayed against
different inputs or parameters; stale or corrupt entries fail closed
(reprove). Writes are atomic (tmp + rename).

The key is the reference package's; the blobs are the port's own
``serialize_proof`` (a reference blob carries its own structure header and
is refused by the port's deserializer, so it reads as a miss).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

from . import serialize as _ser


def _like(air, config):
    return _ser.empty_proof_like_shapes(air, config,
                                        air.n_rows.bit_length() - 1)


class Checkpoint:
    """Disabled when constructed with path=None (zero overhead)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(path, exist_ok=True)

    def _key(self, label: str, config, parts: Sequence[bytes]) -> str:
        h = hashlib.sha256()
        h.update(label.encode())
        h.update(_ser.serialize_config(config))
        for p in parts:
            h.update(len(p).to_bytes(8, "little"))
            h.update(p)
        return h.hexdigest()[:40]

    def load(self, label: str, config, parts: Sequence[bytes], air,
             device=None) -> Optional[Tuple[object, List[int]]]:
        """-> (proof on ``device``, publics) or None (miss / stale /
        corrupt)."""
        if not self.path:
            return None
        key = self._key(label, config, parts)
        f = os.path.join(self.path, key + ".vxp")
        j = f + ".json"
        if not (os.path.exists(f) and os.path.exists(j)):
            return None
        try:
            with open(f, "rb") as fh:
                proof = _ser.deserialize_proof(fh.read(), _like(air, config),
                                               device)
            with open(j) as fh:
                publics = [int(x) for x in json.load(fh)]
            return proof, publics
        except (OSError, ValueError, KeyError, TypeError, RuntimeError):
            return None        # fail closed: reprove the unit

    def store(self, label: str, config, parts: Sequence[bytes],
              proof, publics: Sequence[int]) -> None:
        if not self.path:
            return
        key = self._key(label, config, parts)
        f = os.path.join(self.path, key + ".vxp")
        blob = _ser.serialize_proof(proof)
        tmp = f + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, f)
        tmp = f + ".json.tmp"
        with open(tmp, "w") as fh:
            json.dump([int(p) for p in publics], fh)
        os.replace(tmp, f + ".json")
