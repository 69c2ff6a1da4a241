"""BENCHMARK.json against the contract's form, and every cell's files
found by name; a cell added as files only."""

import json
import re
import shutil

import pytest

from vxbench import spec

BENCH = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["vxbench"]
    assert len(BENCH["command"]) <= 32
    assert all(ONE_LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    spec.check_name(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert ONE_LINE.match(entry[key]), key
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            spec.check_name(entry[key])
    for key in entry.get("reduced", []):
        spec.check_name(key)


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = spec.Cell(BENCH, name)
    assert cell.chips == 1
    for fn in ("make_pool", "setup", "witness", "verifier_air", "expected",
               "constants", "false_statement"):
        assert callable(getattr(cell.kind, fn))
    assert cell.kind.PROOF in cell.config["proofs"]
    assert set(cell.config["guarantee"]) >= {
        "rate_bits", "num_queries", "final_poly_len", "cap_height",
        "pow_bits"}
    names = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer()
    for m in cell.per_layer():
        assert callable(cell.reader(m["name"]).read)
        assert m["moves"] in names


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert entry["file"] == f"vxbench/configs/{entry['name']}.json"
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    assert config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_a_cell_is_added_as_files_only(tmp_path):
    base = tmp_path / "vxbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "workloads" / "rotate.chains_half.json").write_text(json.dumps(
        {"config": "vectorx_rotate", "job": "authority_chains",
         "active_keys": 150, "rotations": 3, "replaced_per_rotation": 10}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rotate.chains_half",
                               "config": "vectorx_rotate",
                               "traffic": "chains_half", "chips": 1,
                               "why": "a throwaway cell"})
    cell = spec.Cell(bench, "rotate.chains_half", base)
    warm, jobs = cell.kind.make_pool(5, cell.traffic, cell.config)
    assert len(jobs) == 4 and all(j["active"] == 150 for j in jobs)
    assert {m["name"] for m in cell.per_layer()} == {
        m["name"] for m in BENCH["per_layer"] if "workloads" not in m}
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("cell,e2e,layer", [
    ("rotate.authority_chains", {"prove_s", "verify_s", "setup_s"},
     "verify_kernels_per_job"),
    ("header_range.ed25519_shards", {"prove_s", "setup_s"},
     "verify_s.shards")])
def test_metrics_are_reported_where_their_workloads_say(cell, e2e, layer):
    cell = spec.Cell(BENCH, cell)
    assert {m["name"] for m in cell.end_to_end()} == e2e
    names = {m["name"] for m in cell.per_layer()}
    assert layer in names and "witness_s" in names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
            assert m.get("moves", m["name"]) in {
                e["name"] for e in spec.Cell(BENCH, w).end_to_end()}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.Cell(BENCH, "no.such_cell")
    with pytest.raises(ValueError):
        spec.check_name("a b")
    with pytest.raises(ValueError):
        spec.check_name("a/b")
