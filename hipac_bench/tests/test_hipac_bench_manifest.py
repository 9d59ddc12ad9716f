"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell's parts from files alone."""

import json
import re
import shutil
import sys

import pytest

from hipac_bench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return catalog.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(bench["command"]) <= 32 and all(_line(w) for w in
                                               bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_part_has_its_file(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert catalog.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        wl = catalog.workload(w["name"])
        assert wl["config"] == w["config"] in configs
        assert wl["chips"] == w["chips"] and wl["why"] == w["why"]
        catalog.driver(wl["driver"]).Cell
        reported = catalog.metrics_of(w["name"], "end_to_end", bench)
        assert len(reported) >= 2
        assert catalog.metrics_of(w["name"], "per_layer", bench)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert callable(catalog.metric(m["name"]).read)


def test_added_files_are_found(tmp_path):
    root = tmp_path / "hipac_bench"
    shutil.copytree(catalog.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = catalog.manifest()
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-cell", "chips": 1,
                               "why": "added by a test"})
    bench["per_layer"].append({"name": "new.metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "a layer", "moves": "setup_s",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "configs" / "new-config.json").write_text(
        json.dumps({"name": "new-config"}))
    (root / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "new-config", "driver": "new_driver", "chips": 1,
         "why": "added by a test", "traffic": {"rate": 3}}))
    (root / "drivers" / "new_driver.py").write_text(
        "class Cell:\n    kind = 'new'\n")
    (root / "metrics" / "new.metric.py").write_text(
        "def read(trace, work):\n    return 42.0\n")
    assert catalog.workload("new-cell", root)["traffic"] == {"rate": 3}
    assert catalog.config("new-config", root) == {"name": "new-config"}
    assert catalog.driver("new_driver", root).Cell.kind == "new"
    assert catalog.metric("new.metric", root).read({}, {}) == 42.0
    got = catalog.metrics_of("new-cell", "per_layer", catalog.manifest(root))
    assert [m["name"] for m in got] == ["new.metric"]
    assert "hipac_bench_driver_new_driver" not in sys.modules
