"""BENCHMARK.json against the format the benchmark keeps to, and the
sources against its import rules."""
import ast
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", [*BENCH["configs"], *BENCH["workloads"],
                                   *METRICS],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_share():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


def test_every_cell_reports_what_it_must():
    from perfbench.harness import manifest
    for w in BENCH["workloads"]:
        m = manifest.metrics_of(BENCH, w["name"])
        e2e = {x["name"] for x in m["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m["per_layer"]
        for metric in m["per_layer"]:
            assert metric["moves"] in e2e


def test_layer_metrics_name_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


def test_every_named_file_is_there():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        limits = json.loads((ROOT / "perfbench" / "checks"
                             / f"{w['name']}.json").read_text())
        assert all(v is not None for v in limits.values())
    for w in BENCH["workloads"]:
        mix = json.loads((ROOT / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "plans" / f"{mix['plan']}.py").is_file()
    for c in BENCH["configs"]:
        kind = json.loads((ROOT / c["file"]).read_text())["potential"]["kind"]
        assert (ROOT / "perfbench" / "models" / f"{kind}.py").is_file()
    for m in METRICS:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted((ROOT / "perfbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    found = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(ROOT / "perfbench").parts:
        assert "repro_torch" not in _imports(path)
