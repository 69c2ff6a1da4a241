"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 (NVIDIA's data sheet and the Hopper tuning guide): 132
SMs, 64 INT32 results per SM per clock, 3.35 TB/s of HBM3, 1980 MHz the
highest SM clock, at the full power limit of 700 W. The SM clock a run
reads from ``nvidia-smi`` (``clocks.max.sm``) takes the table's place
when it can be read; the power limit is reported beside every share.
"""

from __future__ import annotations

import subprocess

H100 = {"sms": 132, "int32_lanes_per_sm": 64, "hbm_bytes_per_s": 3.35e12,
        "max_sm_mhz": 1980.0, "power_limit_w": 700.0}


def nvidia_smi(fields: str) -> list:
    """One card's values of ``fields``; [] when nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    lines = out.strip().splitlines()
    return [v.strip() for v in lines[0].split(",")] if lines else []


def max_sm_mhz() -> float:
    vals = nvidia_smi("clocks.max.sm")
    try:
        return float(vals[0])
    except (IndexError, ValueError):
        return H100["max_sm_mhz"]
