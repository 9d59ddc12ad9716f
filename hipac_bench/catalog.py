"""Finds a cell's parts by name: ``workloads/<cell>.json``,
``configs/<config>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py`` under the benchmark's folder, and the manifest
``BENCHMARK.json`` beside it. Adding a cell, a configuration, a driver or
a per-layer metric is adding files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return _json(root.parent / "BENCHMARK.json")


def workload(name: str, root: Path = ROOT) -> dict:
    return _json(root / "workloads" / f"{name}.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    """The module ``drivers/<name>.py``: its ``Cell`` drives the program."""
    return _module(root / "drivers" / f"{name}.py",
                   f"hipac_bench_driver_{name}")


def metric(name: str, root: Path = ROOT):
    """The module ``metrics/<name>.py``: ``read(trace, work)`` gives the
    metric's value, or None where the run has nothing to read."""
    return _module(root / "metrics" / f"{name}.py",
                   "hipac_bench_metric_" + name.replace(".", "_"))


def metrics_of(cell: str, section: str, bench: dict) -> list[dict]:
    """The manifest's metrics of ``section`` that ``cell`` reports: those
    listing it, and those without a list that move (or are) an end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out
