"""The port imports torch and loads nothing of jax, flax or the JAX package.

The test process itself has jax loaded (``conftest.py`` imports it), so the
import check runs in a fresh interpreter, once with ``JAX_PLATFORMS`` unset
and once with it set (the JAX package's ``__init__`` imports jax when it is
set, so loading that package would show there). A static check also reads
every source file of the port, and ``chip_smoke.py``, for an import of jax,
flax or the JAX package.
"""

import os
import re
import subprocess
import sys

import pytest

JAX_PKG = "ss25_hierarchical_multiscale_image_classification_tpu"
PKG = f"{JAX_PKG}_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import {PKG} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "sklearn", "PIL", "cv2",
              "matplotlib", "pyarrow", "{JAX_PKG}"))
new = (".data.prefetch", ".models.quantized", ".ops.fused_stem", ".infer.features",
       ".ops.augment", ".train.trainer", ".evaluation.froc",
       ".evaluation.metrics", ".evaluation.classifier_eval", ".grid.rasterize",
       ".grid.labeling", ".io.download", ".models.torch_import",
       ".infer.multiscale", ".models.hierarchical", ".data.multiscale",
       ".evaluation.calibration", ".io.annotations", ".data.streamed",
       ".data.stain", ".data.extract", ".train.streaming",
       ".train.hard_negatives", ".parallel", ".parallel.mesh",
       ".parallel.feed", ".parallel.collectives", ".infer.fleet",
       ".io.native_lib", ".io.tiff_slide", ".infer.overlay", ".visualization",
       ".visualization.wsi_viz", ".utils", ".utils.structure")
assert set(pkg.__name__ + m for m in new) <= set(names)
print(len(names), bad)
"""

# ``\b`` keeps ``…_tpu_torch`` (the port) out of the match
_JAX_IMPORT = re.compile(rf"^\s*(import|from)\s+(jax|jaxlib|flax|{JAX_PKG})\b",
                         re.M)
# libraries the card's machine lacks: never at a module's top level
_HOST_ONLY_IMPORT = re.compile(
    r"^(import|from)\s+(optax|sklearn|PIL|cv2|matplotlib|pyarrow|requests|"
    r"tqdm)\b", re.M)


def _import_all(jax_platforms):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    if jax_platforms is not None:
        env["JAX_PLATFORMS"] = jax_platforms
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    # every module of the slices was imported: 40 with data.prefetch,
    # models.quantized and ops.fused_stem of the feature-extraction slice,
    # 44 with models.quant_artifact, ops.int8_conv, ops.int8_block and
    # ops.int8_pool of the int8 slice, 53 with the trainer's and FROC's nine,
    # 57 with the multiscale slice's four, 65 with extraction's six, 70 with
    # the parallel package's four and the fleet, 77 with the TIFF slice's
    # seven
    assert int(count) >= 77
    assert bad == "[]"


def test_port_imports_load_no_jax():
    _import_all(None)


def test_port_imports_load_no_jax_with_jax_platforms_set():
    _import_all("cpu")


def test_port_sources_are_not_gitignored():
    """A checkout holds only what git commits, and the kernels build there
    from ``ops/csrc/``: no source of the port may match an ignore rule."""
    if not os.path.exists(os.path.join(REPO, ".git")):
        pytest.skip("not a git checkout")
    files = []
    for root, dirs, names in os.walk(os.path.join(REPO, PKG)):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        files += [os.path.relpath(os.path.join(root, n), REPO) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    assert any(f.endswith(".cu") for f in files)
    assert any(f.endswith("tile_decoder.cpp") for f in files)
    proc = subprocess.run(["git", "check-ignore", "--no-index", *files],
                          cwd=REPO, capture_output=True, text=True)
    assert proc.stdout == "", f"ignored: {proc.stdout}"
    ignored = subprocess.run(
        ["git", "check-ignore", "--no-index", f"{PKG}/ops/_build/lib.so"],
        cwd=REPO, capture_output=True, text=True)
    assert ignored.returncode == 0  # the build output stays out of commits


def test_port_sources_have_no_jax_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PKG)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 18
    for path in files:
        with open(path) as f:
            source = f.read()
        assert not _JAX_IMPORT.search(source), path
        assert not _HOST_ONLY_IMPORT.search(source), path


# torch.distributed (and the collectives over it) at a module's top level:
# only the collectives themselves may import it there
_DIST_IMPORT = re.compile(
    r"^(import|from)\s+(torch\.distributed|"
    rf"{PKG}\.parallel\.collectives)\b", re.M)


def test_single_card_modules_import_torch_distributed_lazily():
    """Every module that a single card runs imports ``torch.distributed``
    and ``parallel/collectives.py`` inside the functions that take a process
    group, never at its top level."""
    allowed = {os.path.join(PKG, "parallel", "collectives.py")}
    checked = 0
    for root, _, names in os.walk(os.path.join(REPO, PKG)):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(root, n)
            rel = os.path.relpath(path, REPO)
            with open(path) as f:
                found = _DIST_IMPORT.search(f.read())
            assert (found is not None) == (rel in allowed), rel
            checked += 1
    assert checked >= 70
