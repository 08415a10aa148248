"""``BENCHMARK.json`` against the format's limits on names, units and
keys, and every cell's files found by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import check
from portbench.common import CHECKOUT, ROOT, Bench

SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][:3] == ["python3", "-m", "portbench.run"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_metrics_and_cells():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert all(w["chips"] in (1, 4) for w in cells.values())
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for name in cells:
        reported = [m for m in SPEC["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(name in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    bench = Bench()
    w = bench.cell(cell)
    conf = bench.config(w["config"])
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("portbench/") and conf["name"] == w["config"]
    assert conf["reduced"] == entry["reduced"]
    mix = bench.traffic(w["traffic"])
    assert mix["ranks"] == w["chips"]
    assert set(bench.limits(cell)) <= set(check.NUMBERS) and bench.limits(cell)
    kind = importlib.import_module(f"portbench.systems.{conf['system']}")
    assert hasattr(kind, "System") and callable(kind.System.control)
    assert kind.SPANS and set(kind.faults(w["chips"])) and set(kind.TINY_LIMITS) <= set(check.NUMBERS)
    assert callable(kind.tiny_config) and callable(kind.tiny_mix)
    for m in bench.metrics_of("per_layer", cell):
        reader = importlib.import_module(f"portbench.metrics.{m['name'].split('.', 1)[0]}")
        assert callable(reader.read)


def test_paths_hold_only_the_benchmark():
    assert (ROOT / "run.py").exists()
    for path in ROOT.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel
