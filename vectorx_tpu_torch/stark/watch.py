"""In-pipeline value watching — the ``builder.watch`` debugging aid.

VectorX prints circuit variables during witness generation with
plonky2x's ``builder.watch``. The port runs eagerly (it has no ``jit``),
so a watch logs a host copy of the tensor at once, under the
``vectorx.watch`` logger; ``watch_fp`` prints Goldilocks elements as
canonical integers.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..field import goldilocks as gl

log = logging.getLogger("vectorx.watch")


def watch(label: str, value) -> None:
    """Log a host copy of a tensor (or array-like)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    log.info("watch %s: %s", label, np.asarray(value))


def watch_fp(label: str, fp: torch.Tensor) -> None:
    """Log Goldilocks elements (int64 bit patterns) as canonical integers."""
    log.info("watch %s: %s", label, gl.to_u64(gl.canonicalize(fp)))
