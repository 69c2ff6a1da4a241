"""Faults planted under the timed path, and the control: each must make a
run's ``correct`` come out false. The tests drive a run with one of them
in place; the benchmark's own runs never use this module.

- ``control``: the program proves and verifies at a configuration below
  the one the cell states (two thirds of the queries: 42 -> 28, about 72
  conjectured bits for 100), the step that would tempt a change that
  wants a faster prove;
- ``answer_altered``: one public output word of the witness changed where
  it is produced, and proved as if it were right;
- ``half_batch_dropped``: the witness of half the job's batch (its
  signature lanes, or its keys) left out;
- ``state_unchanged``: the prove returns the proof it returned before;
- ``proof_altered``: one bit of an opened row flipped after the prove;
- ``verifier_accepts_all``: the verifier's answer is always yes;
- ``verifier_skips_ali``: the verifier leaves out the constraints at ζ
  (its ALI check) and makes every other check.
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

from . import proofs, stark_job


def _control(cell):
    weak = {}

    def weaker(cfg):
        if cfg not in weak:
            weak[cfg] = dataclasses.replace(
                cfg, num_queries=cfg.num_queries * 2 // 3)
        return weak[cfg]

    prove, verify = stark_job.prove, stark_job.verify
    return [mock.patch.object(
                stark_job, "prove",
                lambda air, trace, publics, cfg, timer=None:
                prove(air, trace, publics, weaker(cfg), timer)),
            mock.patch.object(
                stark_job, "verify",
                lambda air, proof, publics, cfg:
                verify(air, proof, publics, weaker(cfg)))]


def _answer_altered(cell):
    witness = cell.kind.witness

    def altered(job, ctx):
        air, trace, publics = witness(job, ctx)
        return air, trace, publics[:1] + [publics[1] ^ 1] + publics[2:]
    return [mock.patch.object(cell.kind, "witness", altered)]


def _half_batch_dropped(cell):
    witness = cell.kind.witness

    def dropped(job, ctx):
        job = dict(job)
        if "lanes" in job:
            from vectorx_tpu_torch.stark.air_ed25519 import dummy_sig
            half = len(job["lanes"]) // 2
            job["lanes"] = job["lanes"][:half] + [dummy_sig()] * (
                len(job["lanes"]) - half)
        else:
            job["active"] = job["active"] // 2
        return witness(job, ctx)
    return [mock.patch.object(cell.kind, "witness", dropped)]


def _state_unchanged(cell):
    prove, first = stark_job.prove, []

    def stale(air, trace, publics, cfg, timer=None):
        if not first:
            first.append(prove(air, trace, publics, cfg, timer))
        return first[0]
    return [mock.patch.object(stark_job, "prove", stale)]


def _proof_altered(cell):
    prove = stark_job.prove
    return [mock.patch.object(
        stark_job, "prove",
        lambda *a, **k: proofs.tampered(prove(*a, **k), "trace_rows_b"))]


def _verifier_accepts_all(cell):
    return [mock.patch.object(stark_job, "verify",
                              lambda air, proof, publics, cfg: True)]


def _verifier_skips_ali(cell):
    import torch
    from vectorx_tpu_torch.stark import verifier
    return [mock.patch.object(verifier, "_ali_check",
                              lambda *a, **k: torch.tensor(True))]


FAULTS = {"control": _control, "answer_altered": _answer_altered,
          "half_batch_dropped": _half_batch_dropped,
          "state_unchanged": _state_unchanged,
          "proof_altered": _proof_altered,
          "verifier_accepts_all": _verifier_accepts_all,
          "verifier_skips_ali": _verifier_skips_ali}


@contextlib.contextmanager
def planted(name: str, cell):
    """Run the block with the named fault in place."""
    with contextlib.ExitStack() as stack:
        for patch in FAULTS[name](cell):
            stack.enter_context(patch)
        yield
