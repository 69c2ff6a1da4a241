"""Tracing and profiling: per-phase timing and torch.profiler hooks.

Hierarchical phase timers, with a device synchronize at each phase end so
that the times are honest, and optional ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

log = logging.getLogger("vectorx.prof")


def _cuda_devices(args) -> set:
    """The CUDA devices of the tensors (and torch.devices) in args,
    searched through tuples, lists and dicts."""
    found = set()
    for a in args:
        if isinstance(a, torch.Tensor):
            a = a.device
        if isinstance(a, torch.device):
            if a.type == "cuda":
                found.add(a)
        elif isinstance(a, dict):
            found |= _cuda_devices(a.values())
        elif isinstance(a, (tuple, list)):
            found |= _cuda_devices(a)
    return found


@dataclass
class PhaseTimer:
    """Hierarchical wall-clock phase timing (a TimingTree)."""

    sync: bool = True      # synchronize the given tensors' devices at phase ends
    _stack: List[str] = field(default_factory=list)
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, *sync_args):
        """Time the block under ``name`` (nested under the open phases).
        ``sync_args``: tensors or torch.devices; at the phase end each
        CUDA device among them is synchronized before the clock is read."""
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and sync_args:
                for dev in _cuda_devices(sync_args):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[key] = self.totals.get(key, 0.0) + dt
            self.counts[key] = self.counts.get(key, 0) + 1
            self._stack.pop()

    def report(self) -> str:
        lines = []
        for key in sorted(self.totals):
            depth = key.count("/")
            lines.append(f"{'  ' * depth}{key.rsplit('/', 1)[-1]}: "
                         f"{self.totals[key]*1e3:.1f} ms x{self.counts[key]}")
        return "\n".join(lines)

    def log_report(self) -> None:
        log.info("phase timings:\n%s", self.report())


@contextlib.contextmanager
def xprof_trace(logdir: str):
    """Trace the block with torch.profiler (host activity, and the CUDA
    activity where there is a card) and export it to
    ``logdir/trace.json`` (chrome://tracing, Perfetto). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region visible in torch.profiler traces."""
    return torch.profiler.record_function(name)
