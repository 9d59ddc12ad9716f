"""The port's command line against the JAX package's, where they share
actions: several actions in one call and their order, the stage gates,
``--config`` / ``--base_dir`` / ``--store`` / ``--batch_size``, and unknown
arguments.

Both command lines are driven on the same arguments where the JAX side runs
on the CPU in no time (argument handling, configs, gates); the actions
themselves run in the port only, on a tiny packed store, and are held to the
order and exit codes that the JAX ``cli/main.py`` states.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    features,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
    save_model,
)
from test_torch_port_features import WIDTH, _randomized_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's command line, config and gates."""
    pytest.importorskip("jax")
    import types

    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )
    # the package's ``cli`` exports the function ``main`` over the module
    jcli = importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.cli.main")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        manifest as jmanifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.io import (
        download as jdownload,
    )

    return types.SimpleNamespace(cli=jcli, config=jconfig, manifest=jmanifest,
                                 download=jdownload)


def _store(jx, data_dir, level=3, slides=6, per_slide=5, edge=16, seed=0):
    """A packed store of ``slides`` slides (alternately normal and tumor) at
    ``level`` under ``<data_dir>/patches`` with its parquet manifest."""
    rng = np.random.default_rng(seed)
    patches_dir = config.DataConfig(data_dir=str(data_dir)).patches_dir
    recs = []
    for i in range(slides):
        kind = "tumor" if i % 2 else "normal"
        w = patch_store.PackedPatchWriter(patches_dir, level,
                                          f"{kind}_{i + 1:03d}", edge)
        coords = np.stack([np.arange(per_slide), np.zeros(per_slide, int)],
                          1) * edge
        labels = np.full(per_slide, i % 2, dtype=np.int64)
        recs += w.write_batch(
            rng.integers(0, 256, (per_slide, edge, edge, 3), dtype=np.uint8),
            coords, labels)
        w.close()
    jx.manifest.PatchManifest(recs).save(
        manifest.manifest_path(patches_dir, level))
    return recs


# ---------------------------------------------------------------------------
# unknown arguments: logged, exit 1 (argparse alone would exit 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--bogus"], ["--train_mil", "--no_such_flag", "3"],
    ["--predict_slide", "s.wsi.npz", "--levelz=2"],
])
def test_unknown_arguments_exit_1_in_both(jx, argv, capsys):
    for main in (jx.cli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(list(argv))
        assert exc.value.code == 1
    assert "usage:" not in capsys.readouterr().err


def test_known_arguments_pass_the_unknown_check(jx):
    argv = ["--train_mil", "--patch_level", "2", "--epochs=3", "--int8"]
    jx.cli._reject_unknown_args(jx.cli.build_parser(), argv)
    cli._reject_unknown_args(cli.build_parser(), argv + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# --config, --base_dir, --store, --batch_size, --models_dir
# ---------------------------------------------------------------------------


def _both_configs(jx, argv):
    jcfg = jx.cli._config_from_args(jx.cli.build_parser().parse_args(argv))
    cfg = cli._config_from_args(cli.build_parser().parse_args(argv))
    return cfg, jcfg


def test_config_json_gives_equal_subtrees(jx, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({
        "mil": {"attention_hidden_dim": 96, "no_such_field": 1},
        "simclr": {"loss_impl": "pallas", "epochs": 7},
        "uncertainty": {"monte_carlo_samples": 25},
        "data": {"data_dir": str(tmp_path / "from_json"),
                 "patch_store_format": "png"},
        "model": {"feature_dim": 256},
        "no_such_section": {"x": 1},
        "models_dir": str(tmp_path / "m"),
    }))
    cfg, jcfg = _both_configs(jx, ["--config", str(path)])
    got, want = cfg.to_dict(), jcfg.to_dict()
    for section in ("mil", "simclr", "uncertainty", "model"):
        assert got[section] == want[section]
    assert got["mil"]["attention_hidden_dim"] == 96
    assert got["simclr"]["loss_impl"] == "pallas"
    assert got["uncertainty"]["monte_carlo_samples"] == 25
    assert got["models_dir"] == want["models_dir"] == str(tmp_path / "m")
    # the data root comes from the JSON; the data section is rebuilt around it
    assert cfg.data.data_dir == jcfg.data.data_dir == str(tmp_path / "from_json")
    assert cfg.data.patch_store_format == jcfg.data.patch_store_format == "packed"
    for key, value in got["data"].items():
        assert want["data"][key] == value
    for key, value in got["train"].items():
        assert want["train"][key] == value


@pytest.mark.parametrize("argv,data_dir", [
    (["--base_dir", "/b"], "/b"),
    (["--base_dir", "/b", "--data_dir", "/d"], "/d"),
    ([], os.path.join(os.getcwd(), "data", "camelyon16")),
])
def test_base_dir_stands_for_data_dir(jx, argv, data_dir):
    cfg, jcfg = _both_configs(jx, argv)
    assert cfg.data.data_dir == jcfg.data.data_dir == data_dir
    assert cfg.data.patches_dir == jcfg.data.patches_dir


def test_store_batch_size_and_models_dir_override(jx, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"train": {"batch_size": 64},
                                "simclr": {"batch_size": 32},
                                "models_dir": "from_json"}))
    cfg, jcfg = _both_configs(jx, ["--config", str(path), "--store", "png",
                                   "--batch_size", "8", "--models_dir", "m"])
    assert cfg.data.patch_store_format == jcfg.data.patch_store_format == "png"
    assert cfg.train.batch_size == jcfg.train.batch_size == 8
    assert cfg.simclr.batch_size == jcfg.simclr.batch_size == 8
    assert cfg.models_dir == jcfg.models_dir == "m"
    cfg, jcfg = _both_configs(jx, ["--config", str(path)])
    assert cfg.train.batch_size == jcfg.train.batch_size == 64
    assert cfg.simclr.batch_size == jcfg.simclr.batch_size == 32
    assert cfg.models_dir == jcfg.models_dir == "from_json"


def test_config_round_trips_and_replaces(jx):
    cfg = config.Config.from_dict({"mil": {"epochs": 3}})
    assert config.Config.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
    assert cfg.replace(models_dir="x").models_dir == "x"
    assert cfg.replace(models_dir="x").mil.epochs == 3
    jcfg = jx.config.Config.from_dict({"mil": {"epochs": 3}})
    assert cfg.to_dict()["mil"] == jcfg.to_dict()["mil"]


# ---------------------------------------------------------------------------
# the stage gates
# ---------------------------------------------------------------------------


def test_patches_extracted_equals_the_jax_gate(jx, tmp_path):
    _store(jx, tmp_path / "data", level=3)
    data = config.DataConfig(data_dir=str(tmp_path / "data"))
    jdata = jx.config.DataConfig(data_dir=str(tmp_path / "data"))
    # a level directory without patches: a directory is not enough
    os.makedirs(os.path.join(data.patches_dir, "level_2"))
    # a manifest without rows
    jx.manifest.PatchManifest([]).save(
        manifest.manifest_path(data.patches_dir, 1))
    for level, want in ((3, True), (2, False), (1, False), (0, False)):
        assert manifest.patches_extracted(data, level) is want
        assert jx.download.patches_extracted(jdata, level) is want
    nowhere = config.DataConfig(data_dir=str(tmp_path / "nowhere"))
    assert manifest.patches_extracted(nowhere, 3) is False


def test_patch_level_all_gates_every_level(jx, tmp_path, caplog):
    """``--extract_features --patch_level all`` needs the patches of levels
    0-3 (and then extracts at level 3); with level 3 only it stops at the
    first missing level with exit code 1."""
    data_dir = tmp_path / "data"
    _store(jx, data_dir, level=3)
    models_dir = tmp_path / "models"
    save_model(str(models_dir / "resnet18_patch_classifier"),
               _randomized_state(70))
    common = ["--data_dir", str(data_dir), "--models_dir", str(models_dir),
              "--device", "cpu", "--batch_size", "16"]
    assert cli._levels("all") == jx.cli._levels("all") == [0, 1, 2, 3]
    assert cli._levels("2") == jx.cli._levels("2") == [2]
    assert cli.main(["--extract_features", "--patch_level", "all",
                     *common]) == 1
    assert not os.path.exists(data_dir / "features")
    # an empty level directory does not open the gate either
    os.makedirs(data_dir / "patches" / "level_0")
    assert cli.main(["--extract_features", "--patch_level", "0", *common]) == 1
    for level in (0, 1, 2):
        _store(jx, data_dir, level=level, slides=1, per_slide=2, seed=level)
    assert cli.main(["--extract_features", "--patch_level", "all",
                     *common]) == 0
    feats, _, names = features.load_feature_artifacts(
        str(data_dir / "features"), 3)
    assert feats.shape == (30, 8 * WIDTH) and len(names) == 30


# ---------------------------------------------------------------------------
# several actions in one call
# ---------------------------------------------------------------------------


def test_extract_features_then_train_mil_in_one_call(jx, tmp_path):
    """The documented ``--extract_features --train_mil``: features first, then
    the MIL classifier on them, exit code 0."""
    data_dir, models_dir = tmp_path / "data", tmp_path / "models"
    recs = _store(jx, data_dir)
    save_model(str(models_dir / "resnet18_patch_classifier"),
               _randomized_state(71))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"mil": {
        "input_dim": 8 * WIDTH, "max_bag_size": 8, "attention_hidden_dim": 16,
        "head_hidden_dim": 16}}))
    rc = cli.main(["--train_mil", "--extract_features", "--config",
                   str(cfg_path), "--base_dir", str(data_dir), "--models_dir",
                   str(models_dir), "--epochs", "1", "--batch_size", "16",
                   "--device", "cpu"])
    assert rc == 0
    feats, labels, names = features.load_feature_artifacts(
        str(data_dir / "features"), 3)
    assert feats.shape == (len(recs), 8 * WIDTH)
    assert names == [r.patch_name for r in recs]
    sd = load_model(str(models_dir / "mil_classifier"))
    assert any(v.shape[-1] == 8 * WIDTH for v in sd.values())
    # the classifier was trained on these features, not before them
    assert (os.path.getmtime(models_dir / "mil_classifier.pt")
            >= os.path.getmtime(data_dir / "features" / "patch_features_3.npy"))


def test_a_failing_gate_stops_the_later_actions(jx, tmp_path):
    """``--extract_features`` without patches returns 1 before ``--quantize``
    or ``--train_mil`` run (they would raise on their missing inputs)."""
    rc = cli.main(["--extract_features", "--quantize", "--train_mil",
                   "--data_dir", str(tmp_path / "none"), "--models_dir",
                   str(tmp_path / "models"), "--device", "cpu"])
    assert rc == 1
    assert not os.path.exists(tmp_path / "models")


def test_quantize_then_extract_int8_in_one_call(jx, tmp_path):
    """``--quantize --extract_features --int8``: extraction comes first in the
    fixed order (lazily calibrated), then the artifact is written."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
        quant_artifact as qa,
    )

    data_dir, models_dir = tmp_path / "data", tmp_path / "models"
    recs = _store(jx, data_dir, slides=2, per_slide=4)
    save_model(str(models_dir / "resnet18_patch_classifier"),
               _randomized_state(72))
    rc = cli.main(["--quantize", "--extract_features", "--int8", "--data_dir",
                   str(data_dir), "--models_dir", str(models_dir),
                   "--batch_size", "8", "--device", "cpu"])
    assert rc == 0
    assert os.path.exists(models_dir / qa.CLASSIFIER_ARTIFACT)
    feats, _, _ = features.load_feature_artifacts(
        str(data_dir / "features"), 3)
    assert feats.shape == (len(recs), 8 * WIDTH)
    assert (os.path.getmtime(models_dir / qa.CLASSIFIER_ARTIFACT)
            >= os.path.getmtime(data_dir / "features" / "patch_features_3.npy"))
