"""Package-level names resolved at first use (PEP 562).

Each subpackage exports the names that its counterpart in the JAX package
exports, through a module ``__getattr__``: ``import <subpackage>`` imports
none of its modules (so ``evaluation`` loads no scikit-learn and ``ops``
builds nothing), and the module that defines a name is imported when the
name is first read.
"""

from __future__ import annotations

import importlib
import sys


def lazy_exports(package: str, names: dict[str, str]):
    """``(__getattr__, __dir__)`` for ``package``, which exports ``names``
    (name → the module of the package that defines it; a name that is the
    module's own gives the module itself)."""
    def __getattr__(name: str):
        if name not in names:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{names[name]}")
        return module if names[name] == name else getattr(module, name)

    def __dir__() -> list[str]:
        return sorted(set(vars(sys.modules[package])) | set(names))

    return __getattr__, __dir__
