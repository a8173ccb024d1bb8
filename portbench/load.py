"""Find what a cell is made of by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's ``workloads`` entry, with its configuration's entry under
    ``"config_entry"``, and the end-to-end and per-layer metrics it reports."""
    bench = bench or benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = dict(by_name[name])
    w["config_entry"] = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    w["end_to_end"] = reported(bench["end_to_end"])
    w["per_layer"] = reported(bench["per_layer"])
    return w


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell_name: str) -> dict:
    return _json("limits", cell_name)


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: ``read(summary) -> float | None``."""
    return _module(HERE / "metrics" / f"{name}.py")


def driver(name: str) -> ModuleType:
    """``drivers/<name>.py``: the entry point a cell's requests go through
    (``drivers/__init__.py`` gives its functions)."""
    if not name.isidentifier() or not (HERE / "drivers" / f"{name}.py").is_file():
        raise KeyError(f"no driver {name!r} under {HERE / 'drivers'}")
    return importlib.import_module(f"portbench.drivers.{name}")


def kernel_costs() -> dict[str, ModuleType]:
    """Every ``kernels/<name>.py``: ``NAMES`` (regexes of the device kernel
    names it stands for) and ``cost(geom, launches) -> (ops, bytes) | None``."""
    return {p.stem: _module(p) for p in sorted((HERE / "kernels").glob("*.py"))
            if not p.stem.startswith("_")}
