"""Nothing of the benchmark loads JAX or the JAX package, and its plain
reference loads nothing of the program it judges. Names are compared whole
by their top level (the part before the first dot): the port's name starts
with the JAX package's."""

import ast
from pathlib import Path

from hipac_bench import catalog, run

JAX_PACKAGE = "ss25_hierarchical_multiscale_image_classification_tpu"
PORT = JAX_PACKAGE + "_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", JAX_PACKAGE}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def _sources():
    return sorted(catalog.ROOT.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_run_refuses_by_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, PORT + ".models", types.ModuleType("m"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, JAX_PACKAGE + ".io",
                        types.ModuleType("m"))
    assert run.forbidden_modules() == [JAX_PACKAGE]
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((catalog.ROOT / "reference").rglob("*.py")):
        assert PORT not in _imports(path), path
        assert PORT not in path.read_text(), path
        assert _imports(path) <= {"__future__", "contextlib", "csv", "io",
                                  "collections", "math", "numpy", "torch",
                                  "hipac_bench"}, path
