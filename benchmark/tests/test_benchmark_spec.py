"""BENCHMARK.json against the rules of its format, and every cell's files
found by name."""

import json
import os
import re

import pytest

from benchmark.harness import core

ROOT = core.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in metrics]
             + [w["traffic"] for w in SPEC["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    c = core.Cell.load(cell)
    assert c.chips == 1
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(core.reader(m["name"]))
        moves = m.get("moves")
        assert moves is None or moves in names
    for kind, name in (("stages", c.config["stage"]),
                       ("reference", c.config["stage"]),
                       ("drivers", c.traffic["kind"])):
        assert core.part(kind, name) is not None


def test_configs_state_their_source_and_cuts():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert {"assumed", "deployment", "cfg", "scene", "limits"} <= set(cfg)


def test_check_time_fits_with_24_cells():
    """A full check of 24 cells (2 + 14 runs a cell, each of run_seconds +
    60 s, 180 s a cell to compile, 1,200 s spare) fits in 12 hours."""
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_the_harness_names_no_stage():
    """The drivers and the harness reach a stage's adapter and reference
    only by the configuration's name, so a new stage adds files alone."""
    import ast
    import glob

    for sub in ("drivers", "harness"):
        for path in glob.glob(os.path.join(core.BENCH_DIR, sub, "*.py")):
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.ImportFrom):
                    names = [node.module or ""] + [
                        f"{node.module}.{a.name}" for a in node.names]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                else:
                    continue
                for n in names:
                    assert not n.startswith(("benchmark.stages.",
                                             "benchmark.reference.")), \
                        (path, n)
