"""What the harness and the reference may import: neither JAX nor the JAX
package (top-level names compared whole, so the port, whose name begins
with the JAX package's, is allowed), and the reference nothing of the
port either."""

import ast
import subprocess
import sys

import pytest

from vxbench import run, spec

HARNESS = sorted(p for p in spec.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(spec.HERE).parts)
REFERENCE = sorted((spec.HERE / "reference").glob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_harness_imports_no_jax(path):
    assert not top_level_imports(path) & run.FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "hashlib", "functools", "typing", "numpy"}
    assert top_level_imports(path) <= allowed


def test_names_are_compared_whole():
    assert run.forbidden_modules(["vectorx_tpu_torch", "vectorx_tpu_torch.x",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["vectorx_tpu.ops", "jax.numpy", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "vectorx_tpu"]


def test_a_run_loads_no_jax():
    """Every module of the harness, and through the job kinds the port's,
    imported in a fresh process: none of the forbidden names loaded."""
    code = ("import sys, vxbench.run as r, vxbench.faults, vxbench.trace, "
            "vxbench.proofs, vxbench.roofline, vxbench.spec as s\n"
            "b = s.load_benchmark()\n"
            "for w in b['workloads']:\n"
            "    c = s.Cell(b, w['name'])\n"
            "    [c.reader(m['name']) for m in c.per_layer()]\n"
            "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
