"""The port's public surface against the JAX package's.

- Every name that a JAX ``__init__.py`` exports resolves in the port's
  counterpart package, except four that describe the TPU
  (:data:`TPU_ONLY`), each of which maps to the port's counterpart; the
  names resolve lazily, so importing a subpackage imports none of its
  modules and none of the libraries the card's machine lacks.
- ``config.py``: ``Config().to_dict()`` and ``to_json()`` equal JAX's key
  for key; ``get_config``, ``print_config`` and ``from_dict`` with the mesh
  section.
- ``PatchGrid.coverage_loss_without_padding``: equal.
- ``color_jitter`` and ``random_resized_crop``: the port's math given the
  factors and the box that the JAX function draws from its key, against
  the JAX function's output, within ``AUG_ATOL`` (1e-6 on [0, 1] values:
  float32 in both, summed in other orders). bfloat16 is not compared:
  XLA fuses the chain and rounds once, PyTorch rounds after each op.
- ``--compile_cache_dir``: a directory moves ``library_path()`` and
  ``host_library_path()`` there and a host library builds and is found
  there; ``off`` builds into a temporary directory that is gone after the
  process exits; the default stays ``ops/_build``.
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch import (
    config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
    PatchGrid,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    build,
)

JAX_PKG = "ss25_hierarchical_multiscale_image_classification_tpu"
PKG = f"{JAX_PKG}_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX names that describe the TPU → (subpackage, the port's counterpart)
TPU_ONLY = {
    "nt_xent_loss_pallas": ("ops", "nt_xent_loss_kernel"),
    "polygons_to_mask_jax": ("grid", "polygons_to_mask_device"),
    "batch_sharding": ("parallel", "shard_batch"),
    "replicated_sharding": ("parallel", "replicate"),
}

SUBPACKAGES = ("cli", "data", "evaluation", "grid", "infer", "io", "models",
               "ops", "parallel", "train", "utils", "visualization")

AUG_ATOL = 1e-6


def _jax_exports(sub: str | None) -> set[str]:
    """The names that a JAX package ``__init__.py`` imports from its
    modules (read from the source, so that nothing of JAX is imported)."""
    parts = [REPO, JAX_PKG] + ([sub] if sub else []) + ["__init__.py"]
    tree = ast.parse(open(os.path.join(*parts)).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith(JAX_PKG):
            names.update(a.asname or a.name for a in node.names)
        if (isinstance(node, ast.Assign) and sub is None
                and node.targets[0].id == "_SUBMODULES"):
            names.update(ast.literal_eval(node.value))
    return names


@pytest.mark.parametrize("sub", [None, *SUBPACKAGES],
                         ids=["package", *SUBPACKAGES])
def test_every_jax_export_resolves_in_the_port(sub):
    import importlib

    pkg = importlib.import_module(PKG + (f".{sub}" if sub else ""))
    names = _jax_exports(sub)
    assert names
    for name in sorted(names):
        if name in TPU_ONLY:
            where, counterpart = TPU_ONLY[name]
            assert where == sub
            assert not hasattr(pkg, name)
            assert callable(getattr(pkg, counterpart)), counterpart
        else:
            assert getattr(pkg, name) is not None, name
            assert name in dir(pkg)
    with pytest.raises(AttributeError, match="no attribute 'no_such_name'"):
        getattr(pkg, "no_such_name")


def test_the_tpu_only_names_map_to_the_ports_functions():
    from ss25_hierarchical_multiscale_image_classification_tpu_torch import (
        grid,
        ops,
        parallel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
        polygons_to_mask_device,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        nt_xent_loss_kernel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
        replicate,
        shard_batch,
    )

    assert ops.nt_xent_loss_kernel is nt_xent_loss_kernel
    assert grid.polygons_to_mask_device is polygons_to_mask_device
    assert parallel.shard_batch is shard_batch
    assert parallel.replicate is replicate
    assert sum(where == s for where, _ in TPU_ONLY.values()
               for s in SUBPACKAGES) == len(TPU_ONLY)


def test_cli_main_runs_the_command_line_as_in_jax():
    """The JAX ``cli`` exports its ``main`` function; here ``cli.main`` is
    the module, and calling it runs that function."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch import (
        cli as cli_pkg,
    )

    assert cli_pkg.main is cli
    assert cli_pkg.main(["--device", "cpu"]) == 0  # no action: nothing to do
    assert cli_pkg.build_parser is cli.build_parser


_IMPORT_ONE = """
import sys
import {pkg}.{sub} as p
mods = sorted(m for m in sys.modules if m.startswith("{pkg}.{sub}."))
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "sklearn", "matplotlib", "PIL", "cv2", "pyarrow",
              "requests", "tqdm", "{jax_pkg}"))
print(mods, bad)
"""


@pytest.mark.parametrize("sub", ["evaluation", "ops", "data", "infer"])
def test_importing_a_subpackage_loads_none_of_its_modules(sub, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c",
         _IMPORT_ONE.format(pkg=PKG, sub=sub, jax_pkg=JAX_PKG)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


# ---------------------------------------------------------------------------
# config.py
# ---------------------------------------------------------------------------


def test_config_dict_and_json_equal_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )

    assert config.Config().to_dict() == jconfig.Config().to_dict()
    assert config.Config().to_json() == jconfig.Config().to_json()
    assert (dataclasses.asdict(config.MeshConfig())
            == dataclasses.asdict(jconfig.MeshConfig()))
    assert config.DataConfig().max_samples_per_class == 7480
    d = {"mesh": {"num_devices": 4}, "data": {"max_samples_per_class": 9}}
    got, want = (config.Config.from_dict(d).to_dict(),
                 jconfig.Config.from_dict(d).to_dict())
    assert got == want and got["mesh"]["num_devices"] == 4


def test_get_config_and_print_config():
    assert config.get_config() is config.get_config()
    assert config.get_config().to_dict() == config.Config().to_dict()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        config.Config().print_config()
    assert json.loads(out.getvalue()) == config.Config().to_dict()


# ---------------------------------------------------------------------------
# PatchGrid.coverage_loss_without_padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,level", [((97792, 221184), 0),
                                        ((1000, 700), 3), ((448, 448), 2),
                                        ((12224, 27648), 3)])
def test_coverage_loss_without_padding_equals_jax(dims, level):
    from ss25_hierarchical_multiscale_image_classification_tpu.grid.pyramid import (
        PatchGrid as JPatchGrid,
    )

    ds = 2.0 ** level
    got = PatchGrid.for_slide_level(level, dims, ds).coverage_loss_without_padding()
    want = JPatchGrid.for_slide_level(level, dims, ds).coverage_loss_without_padding()
    assert got == want and 0 <= got < 1


# ---------------------------------------------------------------------------
# color_jitter, random_resized_crop
# ---------------------------------------------------------------------------


def _image(seed, shape=(40, 56, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("strength", [(0.2, 0.2, 0.2, 0.1),
                                      (0.4, 0.4, 0.4, 0.1), (1.5, 0, 0.8, 0.5)],
                         ids=["train", "simclr", "wide"])
def test_color_jitter_equals_jax_given_its_factors(strength):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        augment as jaug,
    )

    b, c, s, h = strength
    img = _image(int(100 * sum(strength)))
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jaug.color_jitter(rng, jnp.asarray(img), b, c, s, h))
    # the factors the JAX function draws from its key
    kb, kc, ks, kh = jax.random.split(rng, 4)
    draws = [float(jax.random.uniform(k, (), minval=lo, maxval=hi))
             for k, (lo, hi) in zip((kb, kc, ks, kh), (
                 (max(0.0, 1 - b), 1 + b), (max(0.0, 1 - c), 1 + c),
                 (max(0.0, 1 - s), 1 + s), (-h, h)))]
    got = augment.adjust_color(torch.from_numpy(img), *draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=AUG_ATOL)
    assert got.min() >= 0 and got.max() <= 1 and want.std() > 0.05


def test_color_jitter_draws_then_adjusts():
    img = torch.from_numpy(_image(3))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = augment.color_jitter(img, 0.4, 0.3, 0.2, 0.1, generator=g1)
    fb, fc, fs, fh = augment.sample_jitter_factors(g2, 0.4, 0.3, 0.2, 0.1)
    assert 0.6 <= fb <= 1.4 and 0.7 <= fc <= 1.3 and 0.8 <= fs <= 1.2
    assert -0.1 <= fh <= 0.1
    torch.testing.assert_close(got, augment.adjust_color(img, fb, fc, fs, fh),
                               rtol=0, atol=0)


@pytest.mark.parametrize("out_size", [24, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_resized_crop_equals_jax_given_its_box(out_size, seed):
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        augment as jaug,
    )

    img = _image(seed)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.random_resized_crop(rng, jax.numpy.asarray(img),
                                               out_size))
    y0, x0, h, w = (float(v) for v in jaug._sample_crop_box(rng, 40, 56))
    got = augment.resample_box(torch.from_numpy(img), y0, x0, h, w,
                               out_size).numpy()
    assert got.shape == want.shape == (out_size, out_size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=AUG_ATOL)


def test_random_resized_crop_draws_a_box_then_resamples():
    img = torch.from_numpy(_image(4))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = augment.random_resized_crop(img, 32, generator=g1)
    y0, x0, h, w = (v[0] for v in augment.sample_crop_boxes(g2, 1, 40, 56))
    assert 0 <= y0 <= 40 - h and 0 <= x0 <= 56 - w
    torch.testing.assert_close(
        got, augment.resample_box(img, y0, x0, h, w, 32), rtol=0, atol=0)
    full = augment.resample_box(img, 0.0, 0.0, 40.0, 56.0, 40)
    assert full.shape == (40, 40, 3)


# ---------------------------------------------------------------------------
# --compile_cache_dir
# ---------------------------------------------------------------------------


@pytest.fixture
def restore_build_dir(monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)


def test_compile_cache_dir_moves_the_library_cache(restore_build_dir,
                                                   tmp_path):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
        get_logger,
    )

    default = build.BUILD_DIR
    assert default == build.CSRC_DIR.parent / "_build"
    assert cli.main(["--device", "cpu"]) == 0  # no flag: unchanged
    assert build.BUILD_DIR == default
    cache = tmp_path / "cache"
    assert cli.main(["--compile_cache_dir", str(cache), "--device", "cpu"]) == 0
    assert build.BUILD_DIR == cache
    for source in build.SOURCES:
        assert build.library_path(source).parent == cache
    assert build.host_library_path("chunk").parent == cache
    # a host library builds there once, and is found there after
    messages = []
    logger = get_logger("torch.ops.build")
    handler = type("H", (), {"level": 0, "handle": lambda self, r:
                             messages.append(r.getMessage())})()
    logger.addHandler(handler)
    try:
        so = build.host_library("chunk")
        stat = so.stat()
        assert build.host_library("chunk") == so
    finally:
        logger.removeHandler(handler)
    assert so.parent == cache and so.exists()
    assert so.stat().st_mtime_ns == stat.st_mtime_ns
    assert [m for m in messages if "building host library chunk" in m] \
        == [m for m in messages if "building" in m] and len(messages) == 1


_OFF = """
import sys
sys.path.insert(0, {repo!r})
from {pkg}.cli import main as cli
from {pkg}.ops import build
assert cli.main(["--compile_cache_dir", "off", "--device", "cpu"]) == 0
d = build.BUILD_DIR
assert d.is_dir() and d != build.CSRC_DIR.parent / "_build"
assert build.host_library_path("chunk").parent == d
(d / "probe").write_text("x")
print(d)
"""


def test_compile_cache_dir_off_builds_into_a_directory_removed_at_exit(
        tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c",
                           _OFF.format(repo=REPO, pkg=PKG)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    used = proc.stdout.strip()
    assert used.startswith(str(tmp_path)) and not os.path.exists(used)
