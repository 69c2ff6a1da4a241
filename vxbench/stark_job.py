"""The prove and verify calls of a job, as the statement bundles make them
(``vectorx_tpu_torch/stark/statements.py``: ``_prove_unit``,
``_verify_one``), at the configuration's StarkConfig."""

from __future__ import annotations

from typing import List

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import prover, verifier


def stark_config(config: dict) -> prover.StarkConfig:
    g = config["guarantee"]
    return prover.StarkConfig(rate_bits=g["rate_bits"],
                              num_queries=g["num_queries"],
                              final_poly_len=g["final_poly_len"],
                              cap_height=g["cap_height"],
                              pow_bits=g["pow_bits"])


def _publics(publics: List[int], device):
    return [gl.to_fp(int(p), device) for p in publics]


def prove(air, trace, publics: List[int], cfg, timer=None):
    return prover.prove(air, trace, _publics(publics, trace.device), cfg,
                        timer=timer)


def verify(air, proof, publics: List[int], cfg) -> bool:
    log_n = air.n_rows.bit_length() - 1
    return bool(verifier.verify(air, proof,
                                _publics(publics, proof.trace_cap.device),
                                log_n, cfg))


def vk_cap(air, cfg, device):
    """The constants' cap that the program's verifier computes for the
    air, as numpy; None when the air has no constant columns."""
    vk = prover.constant_vk(air, air.n_rows.bit_length() - 1, cfg, device)
    if vk is None:
        return None
    return vk[0].cap.detach().cpu().numpy().view("uint64").copy()
