"""The benchmark's files: each one that BENCHMARK.json names loads by name,
the file keeps to the contract's shapes, and nothing under portbench/
imports JAX or the JAX package (reference.py not the port either)."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import load
from portbench.traffic import Traffic

HERE = Path(__file__).resolve().parent
BENCH = load.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
DRIVER_FUNCTIONS = ("inputs", "engine", "warm", "call", "mpix", "reference", "compare")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (HERE.parent / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x for x in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_per_layer_metrics_list_cells_that_report_what_they_move():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in load.cell(cell)["end_to_end"]}, (m, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    entry = load.cell(cell)
    cfg = load.config(entry["config"])
    assert cfg["name"] == entry["config"] and cfg["reduced"] == entry["config_entry"]["reduced"]
    traffic = Traffic(load.traffic(entry["traffic"]), 0)
    assert traffic.block
    driver = load.driver(traffic.driver)
    assert all(callable(getattr(driver, f)) for f in DRIVER_FUNCTIONS)
    limits = load.limits(cell)["numbers"]
    assert limits and all(v["lower"] < v["limit"] < v["upper"] for v in limits.values())
    assert all(v["upper"] >= 3 * v["lower"] for v in limits.values())
    reported = {m["name"] for m in entry["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and entry["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(load.metric_reader(metric).read)


def test_kernel_cost_files_load():
    costs = load.kernel_costs()
    want = {"erode3", "preprocess_rhs_t", "fold_minor", "transpose_pair", "unfold_transpose",
            "unfold_clamp_paste", "preprocess_rhs_q", "mg_ud_q", "mg_down_q", "mg_prolong_tq",
            "mg_down_t", "mg_up_t", "clamp_cast_paste_q"}
    assert want <= set(costs)
    for mod in costs.values():
        assert mod.NAMES and all(re.compile(p) for p in mod.NAMES) and callable(mod.cost)


def _imports(path: Path) -> set[str]:
    """Top-level names (before the first dot) of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "seamlesscloneoptimization_tpu"}
    assert not bad, f"{path.name} imports {bad}"


def test_reference_imports_torch_alone():
    assert _imports(HERE / "reference.py") <= {"__future__", "math", "torch"}


def test_import_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    from portbench import harness

    for name in ("seamlesscloneoptimization_tpu.core", "jaxlib.xla_client",
                 "seamlesscloneoptimization_tpu_torch.fake", "jax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert "seamlesscloneoptimization_tpu.core" in found and "jaxlib.xla_client" in found
    assert not [n for n in found if n.startswith(("seamlesscloneoptimization_tpu_torch",
                                                  "jax_like"))]


def test_benchmark_json_is_small_and_whole():
    text = (HERE.parent / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    assert json.loads(text) == BENCH
