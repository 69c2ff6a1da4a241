"""The recordings of tests/reference_data/ are current: record.py, rerun
for each recorded test module into a temporary directory with the
unchanged vectorx_tpu, gives every recorded value again. This is the live
comparison of the port's parity tests with the JAX package (``-m slow``;
minutes per module: the JAX package proves on the CPU)."""

import os
import subprocess
import sys

import pytest

import reference_data as rd

MODULES = sorted(p.stem for p in rd.HERE.glob("test_*.json"))


@pytest.mark.slow
@pytest.mark.parametrize("module", MODULES)
def test_recorded_reference_is_current(module, tmp_path):
    subprocess.run([sys.executable, str(rd.HERE / "record.py"), module,
                    "--out", str(tmp_path)], cwd=rd.REPO, check=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    fresh, kept = rd.read(module, tmp_path), rd.read(module)
    assert fresh["inputs_sha256"] == kept["inputs_sha256"]
    assert (fresh["vectorx_tpu_sources_sha256"]
            == kept["vectorx_tpu_sources_sha256"])
    assert sorted(fresh["values"]) == sorted(kept["values"])
    for key, value in kept["values"].items():
        assert fresh["values"][key] == value, key
