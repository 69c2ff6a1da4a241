"""Device traces of the benchmark's spans, from torch.profiler (CUPTI).

A traced run profiles each step of a job (witness, prove, verify) in a
profiler session of its own, so every device operation of a session
belongs to that span. A span's host time ends in a synchronize. The
reduction here is plain: the union of operation intervals (busy time),
the gaps between them (idle time), kernel counts, and the device time of
named kernels.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

#: the hand-written Poseidon kernels of csrc/poseidon.cu, which lie in an
#: anonymous namespace: "void (anonymous namespace)::permute_kernel(...)",
#: or mangled "_ZN12_GLOBAL__N_114permute_kernelE..."
_POSEIDON_NAMES = ("permute_kernel|permute_coop_kernel|sponge_rows_kernel|"
                   "sponge_rows_coop_kernel|duplex_kernel")
POSEIDON_KERNEL = re.compile(
    rf"^(?:void\s+)?(?:\(anonymous namespace\)::)?(?:{_POSEIDON_NAMES})[<(]"
    rf"|^_ZN12_GLOBAL__N_1\d+(?:{_POSEIDON_NAMES})E")
_COPY = re.compile(r"^(?:Memcpy|Memset)\b", re.IGNORECASE)


@dataclass
class Span:
    """One profiled step: its host seconds and its device operations
    (names; starts and ends in ns on the profiler's clock)."""
    step: str
    seconds: float
    names: List[str] = field(default_factory=list)
    starts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ends: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    phases: Dict[str, float] = field(default_factory=dict)

    def kernels(self) -> int:
        """Kernel launches (copies and fills left out)."""
        return sum(1 for n in self.names if not _COPY.match(n))

    def busy_s(self) -> float:
        return union_ns(self.starts, self.ends) / 1e9

    def device_s(self, pattern: re.Pattern) -> float:
        """Device seconds of the operations whose name matches."""
        return sum(int(e - s) for n, s, e in zip(self.names, self.starts,
                                                  self.ends)
                   if pattern.match(n)) / 1e9


def union_ns(starts: np.ndarray, ends: np.ndarray) -> int:
    """Length of the union of [start, end) intervals."""
    if len(starts) == 0:
        return 0
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts)[order]
    e = np.maximum.accumulate(np.asarray(ends)[order])
    # an interval opens a new run where it starts after every earlier end
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    run_id = np.cumsum(new) - 1
    run_start = s[new]
    run_end = np.zeros(len(run_start), dtype=np.int64)
    np.maximum.at(run_end, run_id, e)
    return int((run_end - run_start).sum())


def device_ops(prof):
    """-> (names, starts, ends) of the device operations of a finished
    profiler session."""
    from torch.autograd import DeviceType
    names, starts, ends = [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        names.append(ev.name())
        starts.append(ev.start_ns())
        ends.append(ev.start_ns() + ev.duration_ns())
    return (names, np.array(starts, dtype=np.int64),
            np.array(ends, dtype=np.int64))


def profiled(step: str, fn, sync):
    """Run ``fn()`` in a profiler session of its own (CUDA activity),
    ending in ``sync()``. -> (result, Span)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        seconds = time.perf_counter() - t0
    names, starts, ends = device_ops(prof)
    return out, Span(step, seconds, names, starts, ends)


def breakdown(spans: List[Span], top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time by what the host was doing (the step)."""
    by_name: Dict[str, int] = {}
    for sp in spans:
        for n, s, e in zip(sp.names, sp.starts, sp.ends):
            key = n if len(n) <= 120 else n[:117] + "..."
            by_name[key] = by_name.get(key, 0) + int(e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = {}
    for sp in spans:
        idle[sp.step] = idle.get(sp.step, 0.0) + max(
            0.0, sp.seconds - sp.busy_s())
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
