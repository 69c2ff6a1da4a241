"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells (workloads) and metrics. Everything that belongs to one of them
lives in a file of its own under this folder, found by its name:

- ``configs/<config>.json``   the deployment: source, widths, ``reduced``,
                              ``assumed`` and the proof system's
                              guarantee (its StarkConfig);
- ``workloads/<cell>.json``   the config, the job kind, the traffic's
                              parameters;
- ``jobs/<kind>.py``          the job pool from the seed, the witness,
                              prove and verify calls, and the reference's
                              expected public values;
- ``metrics/<metric>.py``     the reader of one per-layer metric.

A metric with a ``workloads`` key is reported only in the cells it names;
one without it, in every cell.

A new cell or metric is new files plus new entries in BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _entry(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, bench: dict, name: str, base: Path = HERE):
        self.bench = bench
        self.entry = _entry(bench["workloads"], check_name(name), "workload")
        self.name = name
        self.base = Path(base)
        self.traffic = json.loads(
            (self.base / "workloads" / f"{name}.json").read_text())
        config_name = check_name(self.entry["config"])
        if self.traffic["config"] != config_name:
            raise ValueError(f"{name}: workload file names config "
                             f"{self.traffic['config']!r}, BENCHMARK.json "
                             f"{config_name!r}")
        _entry(bench["configs"], config_name, "config")
        self.config = json.loads(
            (self.base / "configs" / f"{config_name}.json").read_text())
        self.kind = load_module(self.base / "jobs" /
                                f"{check_name(self.traffic['job'])}.py",
                                f"vxbench_job_{self.traffic['job']}")

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> list:
        return self._reported(self.bench["end_to_end"])

    def per_layer(self) -> list:
        return self._reported(self.bench["per_layer"])

    def _reported(self, metrics: list) -> list:
        """The metrics this cell reports: those with no ``workloads`` key,
        and those whose ``workloads`` name it."""
        return [m for m in metrics
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.base / "metrics" / f"{check_name(metric)}.py",
                           f"vxbench_metric_{metric.replace('.', '_')}")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
