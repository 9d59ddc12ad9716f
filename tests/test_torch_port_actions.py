"""The port's network-free CLI actions against the JAX package's, on the CPU.

- ``io/download.py::extract_zip`` and ``prepare_data`` (``--prepare``): the
  same extracted tree from the same zip, the same skip/re-extract rule;
- ``--validation``: the same logged slide-level split;
- ``evaluation/features_eval.py``: ``validate_features`` on the CPU
  returns JAX's keys with and without the t-SNE subsample (``--tsne_full``
  lifts it): the split, the logistic regression's accuracy and confusion
  equal, PCA within 1e-6 of its explained variance ratio and 1e-5 of
  max|coord|, and t-SNE, whose trajectory cannot equal sklearn's
  (Barnes–Hut repulsion there, exact here), held by its KL (≤ 1.05 × JAX's
  + 0.02, both under the port's P) and its trustworthiness (within 0.02 of
  JAX's); the same result with scikit-learn blocked; the plots and the
  unlabeled-patch QA write what JAX writes;
- ``utils/profiling.py``: ``trace`` writes a Chrome trace on the CPU, and
  ``--extract_features --profile`` writes it under ``<log_dir>/profile``;
- every option string of the JAX parser, but the four that need the
  network or XLA, parses in the port's.
"""

import importlib
import json
import logging
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.evaluation import (
    features_eval as jfe,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    download as jdownload,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    embedding,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation import (
    features_eval as fe,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    download,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils import (
    profiling,
)

from test_torch_port_features import _data_root, _randomized_state

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def jcli():
    return importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.cli.main")


class _Records:
    def __init__(self, name):
        self.records, self.logger = [], get_logger(name)
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = self.records.append

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _messages(records, prefix):
    return [r.getMessage() for r in records
            if r.getMessage().startswith(prefix)]


# ---------------------------------------------------------------------------
# --prepare
# ---------------------------------------------------------------------------

def _write_zip(path, names, tag=b""):
    """A zip of XMLs, byte for byte the same whenever it is written: each
    entry carries a fixed date (``writestr`` of a name stamps the current
    time, and two zips written across a two-second tick would differ)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with zipfile.ZipFile(path, "w") as zf:
        for n in names:
            zf.writestr(zipfile.ZipInfo(n, date_time=(2020, 1, 1, 0, 0, 0)),
                        b"<ASAP_Annotations>" + n.encode() + tag
                        + b"</ASAP_Annotations>")


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


EXPECTED = [f"tumor_{i:03d}.xml" for i in range(1, 51)]


def _both(tmp_path, build, act):
    """``build(root)`` in two roots, then ``act(module, root)`` with the
    port's and with JAX's module: the two trees."""
    trees = []
    for name, mod in (("port", download), ("jax", jdownload)):
        root = tmp_path / name
        build(str(root))
        act(mod, str(root))
        trees.append(_tree(root))
    return trees


@pytest.mark.parametrize("case", [
    "fresh", "complete_skips", "missing_reextracts", "extra_names",
    "expected_empty_skips"])
def test_extract_zip_equals_jax(tmp_path, case):
    names = EXPECTED + (["notes.txt"] if case == "extra_names" else [])

    def build(root):
        _write_zip(os.path.join(root, "a.zip"), names, tag=b"new")
        out = os.path.join(root, "out")
        if case == "complete_skips":
            _write_zip(os.path.join(root, "old.zip"), EXPECTED, tag=b"old")
            with zipfile.ZipFile(os.path.join(root, "old.zip")) as zf:
                zf.extractall(out)
        elif case == "missing_reextracts":
            os.makedirs(out)
            for n in EXPECTED[:-1] + ["stale.xml"]:
                open(os.path.join(out, n), "w").write("old")
        elif case == "expected_empty_skips":
            os.makedirs(out)
            open(os.path.join(out, "kept.xml"), "w").write("old")

    def act(mod, root):
        kw = {"expected": []} if case == "expected_empty_skips" else {}
        mod.extract_zip(os.path.join(root, "a.zip"), os.path.join(root, "out"),
                        **kw)

    port, jax_tree = _both(tmp_path, build, act)
    assert port == jax_tree
    out = {k: v for k, v in port.items() if k.startswith("out")}
    if case in ("complete_skips", "expected_empty_skips"):
        assert all(b"new" not in v for v in out.values())
    else:
        assert "out/stale.xml" not in out
        assert len(out) == len(names)


@pytest.mark.parametrize("test_zip", [False, True], ids=["train", "train_test"])
def test_prepare_data_equals_jax(tmp_path, test_zip):
    def build(root):
        _write_zip(os.path.join(root, "train", "mask", "lesion_annotations.zip"),
                   EXPECTED)
        if test_zip:
            _write_zip(os.path.join(root, "test", "mask",
                                    "lesion_annotations.zip"),
                       ["test_001.xml", "test_002.xml"])

    def act(mod, root):
        cfg_mod = (config if mod is download else importlib.import_module(
            "ss25_hierarchical_multiscale_image_classification_tpu.config"))
        mod.prepare_data(cfg_mod.DataConfig(data_dir=root))

    port, jax_tree = _both(tmp_path, build, act)
    assert port == jax_tree
    ann = config.DataConfig(data_dir=str(tmp_path / "port")).annotations_dir
    assert sorted(os.listdir(ann)) == EXPECTED
    assert (sum(k.startswith(os.path.join("test", "mask", "annotations"))
                for k in port) == (2 if test_zip else 0))


def test_prepare_without_a_zip_logs_and_extracts_nothing(tmp_path, jcli):
    with _Records("io.download") as records:
        assert cli.main(["--prepare", "--data_dir", str(tmp_path / "p")]) == 0
    assert _messages(records, "Annotation zip not found")
    with _Records("io.download") as jrecords:
        assert jcli.main(["--prepare", "--data_dir", str(tmp_path / "j")]) == 0
    assert [m.replace(str(tmp_path / "p"), "")
            for m in _messages(records, "Annotation")] == [
        m.replace(str(tmp_path / "j"), "")
        for m in _messages(jrecords, "Annotation")]
    assert not (tmp_path / "p").exists()


def test_prepare_cli_equals_jax_cli(tmp_path, jcli):
    for name, main in (("p", cli.main), ("j", jcli.main)):
        _write_zip(str(tmp_path / name / "train" / "mask"
                       / "lesion_annotations.zip"), EXPECTED + ["x.xml"])
        assert main(["-prep", "--data_dir", str(tmp_path / name)]) == 0
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


# ---------------------------------------------------------------------------
# --validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--validation", "-val"])
def test_validation_logs_the_jax_split(tmp_path, jcli, flag):
    data_dir, _ = _data_root(tmp_path, n=16)
    with _Records("torch.cli") as records:
        assert cli.main([flag, "--data_dir", str(data_dir)]) == 0
    with _Records("cli") as jrecords:
        assert jcli.main([flag, "--data_dir", str(data_dir)]) == 0
    got = _messages(records, "Validation split")
    assert got and got == _messages(jrecords, "Validation split")


# ---------------------------------------------------------------------------
# --validate
# ---------------------------------------------------------------------------

def _features(n=60, d=12, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.4).astype(np.int64)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats[labels == 1] += 1.5
    return feats, labels


#: the bounds of the port's ``validate_features`` against JAX's
PCA_RATIO_RTOL = 1e-6
PCA_COORD_TOL = 1e-5  # of max|coord|
TSNE_KL_FACTOR, TSNE_KL_SLACK = 1.05, 0.02
TSNE_TRUST_TOL = 0.02


def _tsne_rows(feats, kw):
    n, cap = len(feats), kw.get("tsne_max_samples", 10_000)
    if n <= cap:
        return feats
    return feats[np.random.default_rng(kw.get("seed", 42)).choice(
        n, cap, replace=False)]


def _assert_close(got, want, feats, kw=None):
    """The port's ``validate_features`` result against JAX's: the same keys
    and dtypes, the split-dependent numbers equal, PCA to its bounds, and
    t-SNE by its KL and trustworthiness (sklearn's, at k = 5 or less on the
    smallest sets)."""
    from sklearn.manifold import trustworthiness

    kw = kw or {}
    assert got.keys() == want.keys()
    for k in ("num_samples", "feature_dim", "logreg_accuracy"):
        if k in want:
            assert got[k] == want[k], k
    if "logreg_confusion" in want:
        np.testing.assert_array_equal(got["logreg_confusion"],
                                      want["logreg_confusion"])
    if "pca_coords" in want:
        np.testing.assert_allclose(got["pca_explained_variance"],
                                   want["pca_explained_variance"],
                                   rtol=PCA_RATIO_RTOL)
        scale = np.abs(want["pca_coords"]).max()
        assert got["pca_coords"].dtype == want["pca_coords"].dtype
        np.testing.assert_allclose(got["pca_coords"], want["pca_coords"],
                                   rtol=0, atol=PCA_COORD_TOL * scale)
        assert got["pca_class_means"].keys() == want["pca_class_means"].keys()
        for c, m in want["pca_class_means"].items():
            np.testing.assert_allclose(got["pca_class_means"][c], m, rtol=0,
                                       atol=PCA_COORD_TOL * scale)
    if "tsne_coords" in want:
        np.testing.assert_array_equal(got["tsne_labels"], want["tsne_labels"])
        assert got["tsne_class_means"].keys() == want["tsne_class_means"].keys()
        y, yj = got["tsne_coords"], want["tsne_coords"]
        assert y.shape == yj.shape and y.dtype == yj.dtype
        assert np.isfinite(y).all()
        rows = _tsne_rows(feats, kw)
        x = torch.from_numpy(np.asarray(rows, np.float64))
        perplexity = min(kw.get("tsne_perplexity", 30.0), (len(rows) - 1) / 3)
        p = embedding.tsne_affinities(x, perplexity)
        kl = embedding.kl_divergence(p, torch.from_numpy(y))
        kl_jax = embedding.kl_divergence(p, torch.from_numpy(yj))
        assert kl <= TSNE_KL_FACTOR * kl_jax + TSNE_KL_SLACK, (kl, kl_jax)
        k = min(5, -(-len(rows) // 2) - 1)
        t, tj = (trustworthiness(rows, e, n_neighbors=k) for e in (y, yj))
        assert abs(t - tj) <= TSNE_TRUST_TOL, (t, tj)


@pytest.mark.parametrize("kw", [
    {"run_tsne": False},
    {},
    {"tsne_max_samples": 40},
    {"tsne_max_samples": 60},
    {"tsne_perplexity": 5.0, "seed": 3},
], ids=["no_tsne", "tsne", "subsample", "full", "perplexity_seed"])
def test_validate_features_equals_jax(kw):
    feats, labels = _features()
    _assert_close(fe.validate_features(feats, labels, device="cpu", **kw),
                  jfe.validate_features(feats, labels, **kw), feats, kw)


@pytest.mark.parametrize("n,classes", [(6, 2), (9, 1), (12, 3)])
def test_validate_features_small_and_odd_sets_equal_jax(n, classes):
    rng = np.random.default_rng(n)
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    labels = np.arange(n) % classes
    _assert_close(fe.validate_features(feats, labels, device="cpu"),
                  jfe.validate_features(feats, labels), feats)


@pytest.mark.parametrize("tsne_full", [False, True])
def test_validate_cli_passes_the_jax_options(tmp_path, jcli, monkeypatch,
                                             tsne_full):
    feats, labels = _features(n=30)
    fdir = tmp_path / "data" / "features"
    os.makedirs(fdir)
    np.save(fdir / "patch_features_3.npy", feats)
    np.save(fdir / "patch_labels_3.npy", labels)
    (fdir / "patch_paths_3.txt").write_text(
        "\n".join(f"s_x{i}_y0_normal.png" for i in range(30)))
    calls = []
    monkeypatch.setattr(fe, "validate_features",
                        lambda f, lab, **kw: calls.append(("port", f, lab, kw)))
    monkeypatch.setattr(jfe, "validate_features",
                        lambda f, lab, **kw: calls.append(("jax", f, lab, kw)))
    argv = ["--validate", "--data_dir", str(tmp_path / "data")] + (
        ["--tsne_full"] if tsne_full else [])
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert jcli.main(argv) == 0
    (_, f1, l1, kw1), (_, f2, l2, kw2) = calls
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(l1, l2)
    assert kw2 == ({"tsne_max_samples": 30} if tsne_full else {})
    assert kw1 == {**kw2, "device": torch.device("cpu")}


def test_validate_without_sklearn_raises_naming_it(monkeypatch):
    """It raised the ``ImportError`` naming sklearn until the stage moved to
    torch; now, with every sklearn module blocked, it returns what it
    returns with sklearn importable, to the bit."""
    feats, labels = _features(n=40)
    want = fe.validate_features(feats, labels, device="cpu")
    for mod in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, mod)
    for mod in ("sklearn", "sklearn.decomposition", "sklearn.linear_model",
                "sklearn.model_selection", "sklearn.manifold"):
        monkeypatch.setitem(sys.modules, mod, None)
    got = fe.validate_features(feats, labels, device="cpu")
    assert not any(m.split(".")[0] == "sklearn" and sys.modules[m] is not None
                   for m in sys.modules)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


@pytest.mark.parametrize("plot", ["pca", "tsne", "confusion"])
def test_plots_write_a_png_where_jax_does(tmp_path, plot):
    pytest.importorskip("matplotlib")
    feats, labels = _features(n=40)
    for name, mod in (("port", fe), ("jax", jfe)):
        path = str(tmp_path / name / f"{plot}.png")
        kw = {"device": "cpu"} if mod is fe else {}
        if plot == "pca":
            mod.plot_pca(feats, labels, path, **kw)
        elif plot == "tsne":
            mod.plot_tsne(feats, labels, path, **kw)
        else:
            pytest.importorskip("seaborn")
            mod.plot_logreg_confusion(np.array([[5, 2], [1, 7]]), path)
        assert os.path.getsize(path) > 0
    from PIL import Image

    shapes = [Image.open(tmp_path / n / f"{plot}.png").size
              for n in ("port", "jax")]
    assert shapes[0] == shapes[1]


def test_unlabeled_patch_qa_equals_jax(tmp_path, synthetic_case):
    pytest.importorskip("PIL")
    from PIL import Image

    level_dir = tmp_path / "level_3"
    os.makedirs(level_dir / "sub")
    for name in ("s_x0_y0_normal.png", "s_x224_y0_tumor.png",
                 "s_x448_y224.png", "sub/s_x0_y448.png", "odd.png"):
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(level_dir / name)
    got = sorted(fe.find_unlabeled_patches(str(level_dir)))
    assert got == sorted(jfe.find_unlabeled_patches(str(level_dir)))
    assert len(got) == 3
    slide = os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")
    fe.overlay_unlabeled_on_wsi(slide, got, 2, str(tmp_path / "p.png"))
    jfe.overlay_unlabeled_on_wsi(slide, got, 2, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("port_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    assert profiling.Timer is not None


def test_trace_disabled_writes_nothing_and_names_a_rank(tmp_path, monkeypatch):
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    monkeypatch.setenv("RANK", "3")
    assert profiling.trace_path("d").endswith("trace_rank3.json")


def test_extract_features_profile_writes_the_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    data_dir, recs = _data_root(tmp_path)
    save_model(str(tmp_path / "models" / "resnet18_patch_classifier"),
               _randomized_state(43))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"log_dir": str(tmp_path / "logs")}))
    assert cli.main(["--extract_features", "--profile", "--config", str(cfg),
                     "--data_dir", str(data_dir), "--batch_size", "8",
                     "--models_dir", str(tmp_path / "models"),
                     "--device", "cpu"]) == 0
    events = json.loads((tmp_path / "logs" / "profile" / "trace.json")
                        .read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert os.path.exists(data_dir / "features" / "patch_features_3.npy")


# ---------------------------------------------------------------------------
# the option strings
# ---------------------------------------------------------------------------

def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


_JAX_OPTIONS = sorted(_options(importlib.import_module(
    "ss25_hierarchical_multiscale_image_classification_tpu.cli.main"
).build_parser()) - {"-h", "--help"})


@pytest.mark.parametrize("option", _JAX_OPTIONS)
def test_jax_option_parses_in_the_port(option):
    assert option in _options(cli.build_parser())
