"""Cells small enough for a CPU: the benchmark's job kinds and readers
over a configuration and a workload written to a temporary folder, as a
later change would add them (new files, new BENCHMARK.json entries)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from vxbench import spec

HERE = Path(spec.__file__).resolve().parent

#: Ed25519VerifyAir(B=8): 256 rows, one lane, 32 limbs of 8 bits
ED8_COLS, ED8_AUX = 6683, 6450

#: a guarantee a CPU proves in seconds (the cells state 42 queries and
#: 16 bits of grinding)
CPU_GUARANTEE = {"rate_bits": 2, "num_queries": 9, "final_poly_len": 8,
                 "cap_height": 0, "pow_bits": 4}


def make_cell(tmp: Path, kind: str) -> spec.Cell:
    """A tiny cell of the job kind ``kind``: "chains" or "shards"."""
    for d in ("jobs", "metrics"):
        shutil.copytree(HERE / d, tmp / d)
    (tmp / "configs").mkdir()
    (tmp / "workloads").mkdir()
    if kind == "chains":
        config = json.loads((HERE / "configs/vectorx_rotate.json").read_text())
        config["max_authority_set_size"] = 4
        config["proofs"]["authority_chain"]["rows"] = 1024
        traffic = {"job": "authority_chains", "active_keys": 4,
                   "rotations": 3, "replaced_per_rotation": 1}
    else:
        config = json.loads(
            (HERE / "configs/vectorx_header_range_256.json").read_text())
        config["ed25519_shard_bits"] = 8
        config["proofs"]["ed25519_shard"].update(
            rows=256, cols=ED8_COLS, aux_cols=ED8_AUX, const_cols=42)
        traffic = {"job": "ed25519_shards", "slots": 2, "signers": 2}
    config["guarantee"] = dict(CPU_GUARANTEE)
    name, cfg_name = f"tiny.{kind}", f"tiny_{kind}"
    traffic["config"] = cfg_name
    (tmp / "configs" / f"{cfg_name}.json").write_text(json.dumps(config))
    (tmp / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": cfg_name, "source": "tests",
                             "file": f"configs/{cfg_name}.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": name, "config": cfg_name,
                               "traffic": kind, "chips": 1, "why": "tests"})
    return spec.Cell(bench, name, tmp)
