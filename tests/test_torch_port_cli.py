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


# ---------------------------------------------------------------------------
# flags the JAX CLI ignores (no action, --int8 or --simclr_features without
# their action), and the cascade flags' checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--int8"], ["--simclr_features"],
                                  ["--multiscale", "--levels", "1,3"]])
def test_ignored_flags_return_0_in_both(jx, argv, tmp_path, monkeypatch,
                                        capsys):
    # the JAX CLI leaves its compile cache where the environment points
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    common = ["--data_dir", str(tmp_path / "none"), "--models_dir",
              str(tmp_path / "models")]
    assert jx.cli.main(argv + common) == 0
    assert cli.main(argv + common + ["--device", "cpu"]) == 0
    assert "usage:" not in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "models")


@pytest.mark.parametrize("argv,message", [
    (["--cascade_bailout", "0.5"], "--cascade_bailout requires --cascade"),
    (["--cascade", "1.5"], "must be in [0, 1)"),
    (["--cascade", "often"], "expects 'auto' or a probability"),
    (["--ms_combine", "max"], "invalid choice"),
])
def test_cascade_flag_checks_exit_2_in_both(jx, argv, message, capsys):
    for main in (jx.cli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["--predict_slide", "s.wsi.npz", "--multiscale"] + argv)
        assert exc.value.code == 2
        assert message in capsys.readouterr().err


def test_cascade_value_parses_like_jax(jx):
    p, jp = cli.build_parser(), jx.cli.build_parser()
    for argv in (["--cascade"], ["--cascade", "auto"], ["--cascade", "0.25"],
                 ["--cascade", "0"], []):
        a, ja = p.parse_args(argv), jp.parse_args(argv)
        assert a.cascade == ja.cascade
        assert a.levels == ja.levels == "2,3"
        assert a.ms_combine == ja.ms_combine == "auto"
    # the multiscale training and QAT flags parse as the JAX CLI's
    for argv in (["--train_multiscale"], ["--qat", "--epochs", "2"],
                 ["--train_multiscale", "--ms_fusion", "attention",
                  "--ms_input", "crop", "--levels", "1,3"]):
        a, ja = p.parse_args(argv), jp.parse_args(argv)
        for key in ("train_multiscale", "ms_fusion", "ms_input", "levels",
                    "qat", "epochs"):
            assert getattr(a, key) == getattr(ja, key), key


# ---------------------------------------------------------------------------
# --predict_slide <dir>: the fleet's error contract
# ---------------------------------------------------------------------------


def _slide_dir(synthetic_case, target):
    """Two good slides with a corrupt one between them, sorted."""
    import shutil

    os.makedirs(target)
    img = os.path.join(synthetic_case, "train", "img")
    shutil.copy(os.path.join(img, "tumor_001.wsi.npz"),
                os.path.join(target, "a_good.wsi.npz"))
    with open(os.path.join(target, "b_corrupt.wsi.npz"), "wb") as f:
        f.write(b"not a slide")
    shutil.copy(os.path.join(img, "normal_001.wsi.npz"),
                os.path.join(target, "c_good.wsi.npz"))
    return str(target)


def test_predict_slide_dir_goes_past_a_failing_slide_in_both(
        jx, synthetic_case, tmp_path, monkeypatch):
    """A directory with a corrupt ``.wsi.npz`` between two good ones: each
    CLI logs the failure, writes both good CSVs and then raises one
    ``RuntimeError`` naming the count and the first failing path, chained
    from the slide's own error (the JAX ``infer/fleet.py`` contract)."""
    import jax.numpy as jnp

    from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
        ResNet18Classifier as JaxResNet18Classifier,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model as jax_save_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        state_dict_from_flax,
    )
    from test_torch_port_models import randomized_variables

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    slides = _slide_dir(synthetic_case, tmp_path / "slides")
    variables = randomized_variables(JaxResNet18Classifier(dtype=jnp.float32),
                                     seed=80)
    jdir, pdir = tmp_path / "jax_models", tmp_path / "port_models"
    jax_save_model(str(jdir / "resnet18_patch_classifier"), variables)
    save_model(str(pdir / "resnet18_patch_classifier"),
               state_dict_from_flax(variables))
    argv = ["--predict_slide", slides, "--stride", "112", "--batch_size", "4"]
    errors = []
    for main, models_dir, extra in ((jx.cli.main, jdir, []),
                                    (cli.main, pdir, ["--device", "cpu"])):
        with pytest.raises(RuntimeError) as err:
            main(argv + ["--models_dir", str(models_dir)] + extra)
        errors.append(err.value)
        csv_dir = models_dir / "model_predictions_csv"
        assert sorted(os.listdir(csv_dir)) == ["a_good.csv", "c_good.csv"]
    corrupt = os.path.join(slides, "b_corrupt.wsi.npz")
    assert str(errors[0]) == str(errors[1]) == f"1 slide(s) failed; first: {corrupt}"
    assert errors[1].__cause__ is not None
    # a single slide raises its own error
    with pytest.raises(Exception) as single:
        cli.main(["--predict_slide", corrupt, "--models_dir", str(pdir),
                  "--device", "cpu"])
    assert "slide(s) failed" not in str(single.value)


# ---------------------------------------------------------------------------
# --predict_slide --multiscale, --quantize --multiscale
# ---------------------------------------------------------------------------


def _hierarchical_artifacts(tmp_path, calibration, seed=81):
    """One seeded multiscale classifier, as the JAX package's Orbax artifact
    and as the port's ``.pt`` (through the export's conversion)."""
    import jax

    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model as jax_save_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_state_dict_from_flax,
    )
    from test_torch_port_multiscale_data import randomized_hierarchical

    _, variables = randomized_hierarchical(jax, "concat", True, seed=seed)
    variables["calibration"] = dict(calibration)
    jdir, pdir = tmp_path / "jax_models", tmp_path / "port_models"
    jax_save_model(str(jdir / "hierarchical_classifier"), variables)
    save_model(str(pdir / "hierarchical_classifier"),
               hierarchical_state_dict_from_flax(variables))
    return jdir, pdir


def _rows(path):
    """A detection CSV's rows as (n, 3), n = 0 for an empty file."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        return np.empty((0, 3))
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _csvs(models_dir):
    return {(d, f): _rows(os.path.join(models_dir, d, f))
            for d in sorted(os.listdir(models_dir))
            if d.startswith("model_predictions_csv")
            for f in sorted(os.listdir(os.path.join(models_dir, d)))}


@pytest.mark.parametrize("extra", [
    ["--ms_components"],
    ["--ms_components", "--cascade", "0.5", "--cascade_bailout", "1.0",
     "--ms_combine", "fusion"],
], ids=["components", "cascade"])
def test_predict_slide_multiscale_cli_in_both(jx, synthetic_case, tmp_path,
                                              monkeypatch, extra):
    """``--predict_slide <slide> --multiscale`` on the same arguments: both
    CLIs write the main CSV and the four component CSVs under the same
    names. The JAX CLI runs its model in bfloat16, the port's CPU run in
    float32, so the rows are held to the port's in-process
    ``predict_and_export_multiscale`` (equal) and to the JAX rows' count."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        predict_and_export_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
        split_calibration,
    )

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    cal = {"temperature": 1.5, "aux_temperature": 1.2, "combine": 2,
           "input_mode": 1}
    jdir, pdir = _hierarchical_artifacts(tmp_path, cal)
    slide = os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")
    argv = ["--predict_slide", slide, "--multiscale", "--levels", "2,3",
            "--stride", "112", "--batch_size", "4", "--detect_threshold",
            "1e-9"] + extra
    assert jx.cli.main(argv + ["--models_dir", str(jdir)]) == 0
    assert cli.main(argv + ["--models_dir", str(pdir), "--device", "cpu"]) == 0
    got, want = _csvs(pdir), _csvs(jdir)
    suffixes = ["", "_fusion", "_aux", "_aux_base", "_ensemble_base"]
    assert sorted(got) == sorted(want) == sorted(
        (f"model_predictions_csv{s}", "tumor_001.csv") for s in suffixes)
    for key, rows in got.items():
        assert rows.shape[1] == 3 and len(rows) == len(want[key]), key
    # the main surface is dense (under the cascade too: screened-out cells
    # carry their screen margin there)
    assert len(got[("model_predictions_csv", "tumor_001.csv")]) >= 1
    state, calibration = split_calibration(load_model(
        str(pdir / "hierarchical_classifier")))
    kw = {}
    if "--cascade" in extra:
        kw = dict(cascade=0.5, cascade_bailout=1.0, combine="fusion")
    predict_and_export_multiscale(
        slide, hierarchical_from_state_dict(state), str(tmp_path / "ref" / "csv"),
        threshold=1e-9, export_components=True, calibration=calibration,
        stride=112, batch_size=4, device="cpu", **kw)
    for s in suffixes:
        np.testing.assert_array_equal(
            got[(f"model_predictions_csv{s}", "tumor_001.csv")],
            _rows(str(tmp_path / "ref" / f"csv{s}" / "tumor_001.csv")))


def _multiscale_store(jx, data_dir, cells=4, seed=0):
    """Packed stores of one slide at levels 2 (448-px patches) and 3 (224-px)
    on aligned cells, with their parquet manifests."""
    rng = np.random.default_rng(seed)
    patches_dir = config.DataConfig(data_dir=str(data_dir)).patches_dir
    for lvl, edge in ((2, 448), (3, 224)):
        w = patch_store.PackedPatchWriter(patches_dir, lvl, "tumor_001", edge)
        coords = np.stack([np.arange(cells), np.zeros(cells, int)], 1) * edge
        recs = w.write_batch(
            rng.integers(0, 256, (cells, edge, edge, 3), dtype=np.uint8),
            coords, np.arange(cells) % 2)
        w.close()
        jx.manifest.PatchManifest(recs).save(
            manifest.manifest_path(patches_dir, lvl))


def test_quantize_multiscale_in_both_then_int8_prediction(
        jx, synthetic_case, tmp_path, monkeypatch):
    """``--quantize --multiscale`` on the same data and artifact (crop input
    mode: the card has no cv2) writes ``quantized_hierarchical_trunk.npz``
    in both CLIs with the same int8 kernels and activation scales within
    1e-5; ``--predict_slide --multiscale --int8`` then picks the port's up."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.multiscale import (
        predict_slide_multiscale,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
        quant_artifact as qa,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
        split_calibration,
    )

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    data_dir = tmp_path / "data"
    _multiscale_store(jx, data_dir)
    jdir, pdir = _hierarchical_artifacts(tmp_path, {"input_mode": 1}, seed=82)
    argv = ["--quantize", "--multiscale", "--levels", "2,3", "--data_dir",
            str(data_dir)]
    assert jx.cli.main(argv + ["--models_dir", str(jdir)]) == 0
    assert cli.main(argv + ["--models_dir", str(pdir), "--device", "cpu"]) == 0
    assert not os.path.exists(pdir / qa.CLASSIFIER_ARTIFACT)
    jz = np.load(str(jdir / qa.TRUNK_ARTIFACT))
    pz = np.load(str(pdir / qa.TRUNK_ARTIFACT))
    assert sorted(jz.files) == sorted(pz.files)
    assert "fc/0" not in pz.files and "stem_bias_map" in pz.files
    for key in pz.files:
        if key.startswith("qkernels/"):
            np.testing.assert_array_equal(pz[key], jz[key])
        else:
            np.testing.assert_allclose(pz[key], jz[key], rtol=1e-5,
                                       atol=1e-5 * np.abs(jz[key]).max())
    # --predict_slide --multiscale --int8 uses the artifact
    slide = os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")
    assert cli.main(["--predict_slide", slide, "--multiscale", "--int8",
                     "--stride", "112", "--batch_size", "4",
                     "--detect_threshold", "1e-9", "--models_dir", str(pdir),
                     "--device", "cpu"]) == 0
    state, calibration = split_calibration(load_model(
        str(pdir / "hierarchical_classifier")))
    margins, grid = predict_slide_multiscale(
        slide, hierarchical_from_state_dict(state), calibration, int8=True,
        qtree=qa.load_quantized(str(pdir / qa.TRUNK_ARTIFACT)), stride=112,
        batch_size=4, output="margin", device="cpu")
    rows = np.loadtxt(str(pdir / "model_predictions_csv" / "tumor_001.csv"),
                      delimiter=",", ndmin=2)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
        margin_detections,
    )

    want = np.array(margin_detections(margins, grid, 1e-9))
    np.testing.assert_array_equal(rows, want)


def test_predict_slide_multiscale_dir_goes_past_a_failing_slide(
        synthetic_case, tmp_path):
    """The multiscale directory mode keeps the same contract, component
    CSVs included."""
    pytest.importorskip("jax")
    slides = _slide_dir(synthetic_case, tmp_path / "slides")
    _, pdir = _hierarchical_artifacts(tmp_path, {}, seed=83)
    with pytest.raises(RuntimeError, match=r"^1 slide\(s\) failed; first: "):
        cli.main(["--predict_slide", slides, "--multiscale", "--ms_components",
                  "--stride", "112", "--batch_size", "4", "--models_dir",
                  str(pdir), "--device", "cpu"])
    for d in ("model_predictions_csv", "model_predictions_csv_fusion",
              "model_predictions_csv_aux", "model_predictions_csv_aux_base",
              "model_predictions_csv_ensemble_base"):
        assert sorted(os.listdir(pdir / d)) == ["a_good.csv", "c_good.csv"], d


# ---------------------------------------------------------------------------
# --patch, --patch_one_slide, --stain_norm, --extract_impl,
# --mine_hard_negatives
# ---------------------------------------------------------------------------


def _fresh(synthetic_case, target):
    """A copy of the JAX-written data root without patches."""
    import shutil

    shutil.copytree(synthetic_case, target,
                    ignore=shutil.ignore_patterns("patches"))
    return str(target)


def _level_rows(data_dir, level):
    m = manifest.load_or_scan_manifest(
        config.DataConfig(data_dir=data_dir).patches_dir, level)
    return [(r.slide, r.x, r.y, r.label, r.store, r.row) for r in m]


@pytest.mark.parametrize("extra", [
    [],
    ["--patch_level", "all"],
    ["--patch_level", "2", "--stride", "112"],
    ["--extract_impl", "device", "--patch_level", "all"],
    ["-p", "--store", "png", "--patch_level", "3", "--stride", "56"],
])
def test_patch_writes_the_jax_clis_store(jx, synthetic_case, tmp_path, extra):
    if "png" in extra:
        pytest.importorskip("PIL")
    proot = _fresh(synthetic_case, tmp_path / "p")
    jroot = _fresh(synthetic_case, tmp_path / "j")
    argv = (["--patch"] if "-p" not in extra else []) + extra
    assert cli.main(argv + ["--data_dir", proot, "--device", "cpu"]) == 0
    assert jx.cli.main(argv + ["--data_dir", jroot]) == 0
    levels = cli._levels(extra[extra.index("--patch_level") + 1]
                         if "--patch_level" in extra else "3")
    for level in levels:
        got, want = _level_rows(proot, level), _level_rows(jroot, level)
        assert len(got) > 0
        assert [r[:5] for r in got] == [r[:5] for r in want]
        for g, w in zip(manifest.load_or_scan_manifest(os.path.join(
                proot, "patches"), level), manifest.load_or_scan_manifest(
                os.path.join(jroot, "patches"), level)):
            assert (open(g.path, "rb").read() == open(w.path, "rb").read())


def test_patch_gate_returns_1_in_both(jx, tmp_path, caplog):
    for main, extra in ((cli.main, ["--device", "cpu"]), (jx.cli.main, [])):
        assert main(["--patch", "--data_dir", str(tmp_path / "none"),
                     *extra]) == 1
        assert main(["--patch", "--train", "--data_dir",
                     str(tmp_path / "none"), *extra]) == 1
    assert not os.path.exists(tmp_path / "none")


def test_patch_one_slide_extracts_one_slide_in_both(jx, synthetic_case,
                                                    tmp_path):
    proot = _fresh(synthetic_case, tmp_path / "p")
    jroot = _fresh(synthetic_case, tmp_path / "j")
    argv = ["--patch_one_slide", "normal_001", "--patch_level", "2"]
    assert cli.main(argv + ["--data_dir", proot, "--device", "cpu"]) == 0
    assert jx.cli.main(argv + ["--data_dir", jroot]) == 0
    got = _level_rows(proot, 2)
    assert got == [r[:4] + (r[4], r[5]) for r in _level_rows(jroot, 2)]
    assert {r[0] for r in got} == {"normal_001"}


def test_png_store_without_pillow_fails_clearly(synthetic_case, tmp_path,
                                                monkeypatch):
    import sys

    root = _fresh(synthetic_case, tmp_path / "p")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        cli.main(["--patch", "--store", "png", "--data_dir", root,
                  "--device", "cpu"])


class _Calls:
    """Records the CLI's calls of the stages it dispatches to."""

    STAGES = ("extract_patches", "train_resnet_classifier_streaming",
              "train_resnet_classifier", "_mine_hard_negatives",
              "quantize_classifier_to_artifact", "train_mil_classifier")

    def __init__(self, monkeypatch, stages=STAGES):
        self.calls = []
        for name in stages:
            monkeypatch.setattr(cli, name, self._recorder(name))

    def _recorder(self, name):
        def record(*args, **kw):
            self.calls.append((name, kw))
            return "artifact" if name.startswith("quantize") else None
        return record

    def names(self):
        return [n for n, _ in self.calls]


def _slide_root(tmp_path):
    img = tmp_path / "data" / "train" / "img"
    img.mkdir(parents=True)
    (img / "tumor_001.wsi.npz").write_bytes(b"")
    return str(tmp_path / "data")


def test_patch_train_streams_the_training_level_last(jx, tmp_path,
                                                     monkeypatch):
    """``--patch --train --patch_level all``: levels 0-2 extract, then level
    3 streams into training (the JAX CLI's order, ``cli/main.py`` of the JAX
    package); the store-based trainer does not run again."""
    calls = _Calls(monkeypatch)
    root = _slide_root(tmp_path)
    assert cli.main(["--patch", "--train", "--patch_level", "all",
                     "--stride", "112", "--epochs", "3", "--stain_norm",
                     "--extract_impl", "device", "--batch_size", "8",
                     "--data_dir", root, "--device", "cpu"]) == 0
    assert calls.names() == ["extract_patches"] * 3 + [
        "train_resnet_classifier_streaming"]
    assert [kw["level"] for _, kw in calls.calls[:3]] == [0, 1, 2]
    for _, kw in calls.calls[:3]:
        assert kw["stride"] == 112 and kw["stain_norm"] is True
        assert kw["impl"] == "device" and kw["store_format"] == "packed"
    stream = calls.calls[3][1]
    assert stream["level"] == 3 and stream["epochs"] == 3
    assert stream["stride"] == 112 and stream["batch_size"] == 8
    assert stream["extract_impl"] == "device" and stream["stain_norm"] is True
    # level 2 only: nothing else extracts before the stream
    calls.calls.clear()
    assert cli.main(["--patch", "--train", "--patch_level", "2",
                     "--data_dir", root, "--device", "cpu"]) == 0
    assert calls.names() == ["train_resnet_classifier_streaming"]
    assert calls.calls[0][1]["level"] == 2


def test_actions_run_in_the_jax_clis_order(tmp_path, monkeypatch):
    calls = _Calls(monkeypatch)
    root = _slide_root(tmp_path)
    assert cli.main(["--mine_hard_negatives", "--quantize",
                     "--patch_one_slide", "tumor_001", "--train_mil",
                     "--patch", "--data_dir", root, "--device", "cpu"]) == 0
    assert calls.names() == ["extract_patches", "extract_patches",
                             "train_mil_classifier",
                             "quantize_classifier_to_artifact",
                             "_mine_hard_negatives"]
    assert calls.calls[1][1]["slide_filter"] == ["tumor_001"]
    assert "impl" not in calls.calls[1][1]  # as in JAX: the host route


def test_mine_hard_negatives_loads_the_classifier_artifact(tmp_path,
                                                           monkeypatch):
    """``--mine_hard_negatives`` reads ``<models_dir>/
    resnet18_patch_classifier.pt`` (the suffix added by ``load_model``)."""
    calls = _Calls(monkeypatch, stages=())
    models = tmp_path / "models"
    sd = _randomized_state(71)
    save_model(str(models / "resnet18_patch_classifier"), sd)
    monkeypatch.setattr(cli, "mine_hard_negatives",
                        lambda cfg, model, level, device: calls.calls.append(
                            ("mine", dict(model=model, level=level))))
    assert cli.main(["--mine_hard_negatives", "--patch_level", "2",
                     "--models_dir", str(models), "--device", "cpu"]) == 0
    (name, kw), = calls.calls
    assert kw["level"] == 2
    got = kw["model"].state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items()
               if k in got and not k.endswith("num_batches_tracked"))
    assert next(kw["model"].parameters()).dtype == torch.float32
    os.remove(models / "resnet18_patch_classifier.pt")
    with pytest.raises(FileNotFoundError):
        cli.main(["--mine_hard_negatives", "--models_dir", str(models),
                  "--device", "cpu"])


def test_config_json_sets_stain_norm(jx, tmp_path, monkeypatch):
    """``data.stain_norm`` in ``--config`` reaches ``--patch`` in the port;
    the JAX CLI rebuilds the data section and drops it (a documented
    difference)."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"data": {"stain_norm": True}}))
    cfg, jcfg = _both_configs(jx, ["--config", str(path)])
    assert cfg.data.stain_norm is True and jcfg.data.stain_norm is False
    assert config.Config.from_dict({"data": {"stain_norm": True}}).data.stain_norm
    assert jx.config.Config.from_dict(
        {"data": {"stain_norm": True}}).data.stain_norm
    calls = _Calls(monkeypatch)
    root = _slide_root(tmp_path)
    assert cli.main(["--patch", "--config", str(path), "--data_dir", root,
                     "--device", "cpu"]) == 0
    assert calls.calls[0][1]["stain_norm"] is True
    # the new flags pass the unknown-argument check in both
    argv = ["-p", "--stain_norm", "--extract_impl", "device",
            "--patch_one_slide", "x", "--mine_hard_negatives"]
    jx.cli._reject_unknown_args(jx.cli.build_parser(), argv)
    cli._reject_unknown_args(cli.build_parser(), argv)
