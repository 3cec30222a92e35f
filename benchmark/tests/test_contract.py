"""The benchmark's files against their contract: names and units in the
allowed characters, every file a name leads to present, each per-layer
metric's file saying the layer and the metric it moves that
``BENCHMARK.json`` says, and nothing under ``benchmark/`` importing JAX or
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's)."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import common

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _imports(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & set(common.BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"torch", "math", "itertools", "benchmark"}
    assert "dsgan_tpu_torch" not in path.read_text()


def test_whole_name_comparison():
    """``dsgan_tpu_torch`` is not ``dsgan_tpu``, and the run's own check
    finds a loaded ``dsgan_tpu`` submodule by its top-level name."""
    import sys
    import types

    assert "dsgan_tpu_torch" not in common.BANNED
    sys.modules["dsgan_tpu.fake_submodule"] = types.ModuleType("dsgan_tpu.fake_submodule")
    try:
        assert common.banned_modules() == ["dsgan_tpu"]
    finally:
        del sys.modules["dsgan_tpu.fake_submodule"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in SPEC["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / SPEC["command"][1]).is_file()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_text():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_and_metrics(cell):
    """Every file the cell's names lead to exists; it reports setup_s, one
    other end-to-end metric and one per-layer metric; each per-layer
    metric's file agrees with BENCHMARK.json and moves an end-to-end metric
    the cell reports."""
    c = common.load_cell(cell, ROOT)
    assert (BENCH / "drivers" / f"{c.traffic['kind']}.py").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        reader = common.metric_reader(ROOT, m["name"])
        assert (reader.LAYER, reader.MOVES, reader.UNIT) == (m["layer"], m["moves"], m["unit"])
        assert m["moves"] in e2e
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in SPEC["per_layer"]}
    assert {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")} == listed


def test_layers_name_alike():
    """Metrics of one layer give it letter for letter."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)
