"""Port vs reference: the witness-level header_range and rotate programs.

At the JAX test's sizes (TREE = 8 slots of S = 512 bytes, MAX_N = 8
authorities), seeded headers and keys (an RFC 8032 signer on Python ints
over seeded bytes; the cases are built in tests/reference_data/inputs.py)
go through the JAX package's ``verify_subchain``, ``header_range``,
``rotate`` and ``verify_epoch_end_header`` (recorded: tests/
reference_data/test_torch_header_range.json, made by tests/reference_data/
record.py) and through the port's (torch, CPU). Every field of every result must be
equal (tolerance 0): the honest cases, a minority justification, a wrong
set hash, a broken link, a wrong block number, a range across the u32
wrap of the block numbers, and an epoch-end header whose record window
runs past the end of its buffer, where the JAX package's gather reads 255
(a port that read zeros there would accept the truncated buffer below).
"""

import numpy as np
import pytest
import torch

from vectorx_tpu_torch.circuits import header_range as hr
from vectorx_tpu_torch.circuits import justification as just
from vectorx_tpu_torch.circuits import rotate as rot
from vectorx_tpu_torch.parallel import subchain

import reference_data as rd
from reference_data import inputs

torch.set_num_threads(1)

MAX_N = inputs.HR_MAX_N


HR_CASES = inputs.HR_CASES
ROT_CASES = inputs.ROT_CASES
HR_OK = {"honest": True, "u32_wrap": True}


@pytest.fixture(scope="module")
def ref():
    """The cases, and the JAX package's results on them, as recorded."""
    hr_cases, rot_cases = inputs.header_range_cases()
    want = rd.load("test_torch_header_range",
                   inputs.test_torch_header_range((hr_cases, rot_cases)))

    def np_result(r):
        return {k: rd.from_values(v) for k, v in r.items()}

    return dict(hr_cases=hr_cases, rot_cases=rot_cases,
                subchain=np_result(want["subchain"]),
                hr={k: np_result(v) for k, v in want["hr"].items()},
                rot={k: np_result(v) for k, v in want["rot"].items()},
                short=want["short"])


_short_epoch_case = inputs.short_epoch_case


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_justification(rec):
    return just.prepare_justification(*rec, MAX_N, device="cpu")


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        g = (g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g))
        assert np.array_equal(g.astype(np.int64), v.astype(np.int64)), k


def test_verify_subchain_equals_reference(ref):
    c = ref["hr_cases"]["honest"]
    got = subchain.verify_subchain(_t(c["buf"]), _t(c["sizes"]), c["n"],
                                   _t(np.frombuffer(c["trusted_hash"], np.uint8)),
                                   c["trusted"])
    _same(got._asdict(), ref["subchain"])
    assert bool(got.links_ok) and bool(got.blocks_sequential)


@pytest.mark.parametrize("name", list(HR_CASES))
def test_header_range_equals_reference(ref, name):
    c = ref["hr_cases"][name]
    got = hr.header_range(
        c["trusted"], _t(np.frombuffer(c["trusted_hash"], np.uint8)),
        (c["set_id"], 0), _t(np.frombuffer(c["set_hash"], np.uint8)),
        c["target"], _t(c["buf"]), _t(c["sizes"]),
        _port_justification(c["rec"]))
    _same(got._asdict(), ref["hr"][name])
    assert bool(got.ok) == HR_OK.get(name, False)


@pytest.mark.parametrize("name", list(ROT_CASES))
def test_rotate_equals_reference(ref, name):
    c = ref["rot_cases"][name]
    got = hr.rotate((c["set_id"], 0), _t(np.frombuffer(c["set_hash"], np.uint8)),
                    c["block"], _t(c["hb"]), c["size"], c["n_new"], c["start"],
                    _t(c["pk"]), _port_justification(c["rec"]))
    _same(got._asdict(), ref["rot"][name])
    assert bool(got.ok)
    assert bytes(got.new_authority_set_hash.numpy()) == c["new_hash"]


def test_window_past_end_reads_the_fill(ref):
    """The record window of the honest two-key case runs past the end of
    its buffer: the bytes read there are 255, as the reference reads them."""
    c = ref["rot_cases"]["window_past_end"]
    start = c["start"] + 13                  # the records' first byte
    window = rot._window(_t(c["hb"])[None], torch.tensor([start]),
                         MAX_N * 40 + 4)[0]
    inside = len(c["hb"]) - start
    assert 0 < inside < MAX_N * 40 + 4
    assert bool((window[inside:] == 255).all())
    assert bytes(window[:inside].numpy()) == c["hb"][start:].tobytes()


def test_epoch_end_delay_past_the_buffer_is_rejected(ref):
    c = _short_epoch_case(ref["rot_cases"]["window_past_end"])
    got = rot.verify_epoch_end_header(_t(c["hb"]), c["n_new"], c["start"],
                                      _t(c["pk"]))
    assert ref["short"] is False
    assert bool(got) is False
