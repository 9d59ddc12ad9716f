"""The port's int8 (w8a8) paths against the JAX package: the space-to-depth
gather, ``predict_slide(int8=True)``, ``run_feature_extraction(int8=True)``
and the CLI's ``--quantize`` / ``--int8``.

Everything runs on the CPU at narrow widths (``num_filters=8``), where the
port's int8 kernels are their plain versions. The same weights go to both
packages (``state_dict_from_flax``), and a quantized tree made by the JAX
package goes to the port through ``quantized_from_jax`` or through the
``.npz`` artifact.

Tolerances, and why:

- the space-to-depth bytes: equal.
- with a tree carried across, both packages run the same integers, so
  margins and features agree to ``INT8_RTOL`` (1 %) of the largest value:
  room for a requantization, or a uint8 pixel of the slide's 224 → 64
  resize, that lands within an ulp of a rounding boundary and falls the
  other way. Measured here: ≤ 8.2e-7 of the largest value (float32 order
  of the last mean and the head), no flipped step.
- with lazy calibration each package calibrates through its own float32
  forward, so the activation scales agree to ~1e-6 relative and a few
  roundings may flip: the same bound (measured ≤ 8.2e-7 as well).

JAX is imported inside the tests that compare with it.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    features,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    sliding_window as psw,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quant_artifact as qa,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as q,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    quantized_from_jax,
    resnet18_from_state_dict,
    state_dict_from_flax,
    strip_head,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    int8_block as ib,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops import (
    int8_conv as ic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)
from test_torch_port_features import _data_root, _randomized_state, _write_store
from test_torch_port_int8 import _np_tree, _randomized_variables, _u8

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8_RTOL = 1e-2  # of the largest margin or feature
SLICE_KW = dict(level=3, stride=56, input_size=64)


def _assert_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_RTOL * scale)


# ---------------------------------------------------------------------------
# (6) the space-to-depth gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("indices", [[0, 1, 2], [5, 30, 2, 39, 17], [38]],
                         ids=["one_pack", "two_packs", "single"])
def test_read_batch_s2d_equals_jax_bytes(tmp_path, indices):
    pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        manifest as jax_manifest,
        patch_store as jax_store,
    )

    recs = _write_store(str(tmp_path / "patches"))
    want = jax_store.PatchReader(jax_manifest.PatchManifest(recs)).read_batch(
        indices, resize_to=32, s2d=True)
    reader = patch_store.PatchReader(manifest.PatchManifest(recs))
    got = reader.read_batch(indices, resize_to=32, s2d=True)
    assert got.shape == (len(indices), 16, 16, 12) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    plain = reader.read_batch(indices, resize_to=32)
    np.testing.assert_array_equal(got, patch_store.space_to_depth_u8(plain))


def test_space_to_depth_slots_and_dataset_flag(tmp_path):
    imgs = _u8(1, (2, 6, 4, 3))
    s = patch_store.space_to_depth_u8(imgs)
    assert s.shape == (2, 3, 2, 12) and s.flags.c_contiguous
    # slot (r·2 + rx)·3 + c holds pixel (2Y + r, 2X + rx, c)
    for r in range(2):
        for rx in range(2):
            np.testing.assert_array_equal(
                s[..., (r * 2 + rx) * 3:(r * 2 + rx) * 3 + 3],
                imgs[:, r::2, rx::2])
    with pytest.raises(ValueError, match="even"):
        patch_store.space_to_depth_u8(_u8(1, (1, 5, 4, 3)))
    recs = _write_store(str(tmp_path / "patches"))
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=32)
    assert ds.s2d is False
    flagged = dataclasses.replace(ds, s2d=True)
    a, la = ds.read_batch([3, 4])
    b, lb = flagged.read_batch([3, 4])
    assert a.shape == (2, 32, 32, 3) and b.shape == (2, 16, 16, 12)
    np.testing.assert_array_equal(b, patch_store.space_to_depth_u8(a))
    np.testing.assert_array_equal(la, lb)


# ---------------------------------------------------------------------------
# (7) predict_slide(int8=True)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slide_models():
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
        ResNet18Classifier as JaxResNet18Classifier,
    )

    variables = _randomized_variables(jax, 61)
    jmodel = JaxResNet18Classifier(dtype=jax.numpy.float32, num_filters=8)
    sd = state_dict_from_flax(variables)
    return jax, jmodel, variables, sd, resnet18_from_state_dict(sd)


@pytest.fixture(scope="module")
def slide_path(synthetic_case):
    return os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")


def _jax_predict(jax, slide_path, variables, jmodel, **kw):
    import ss25_hierarchical_multiscale_image_classification_tpu.infer.sliding_window as jsw

    return jsw.predict_slide(slide_path, variables, model=jmodel,
                             output="margin", int8=True, **SLICE_KW, **kw)


@pytest.mark.parametrize("batch_size", [8, 16],
                         ids=["full_first_batch", "one_short_batch"])
def test_predict_slide_int8_lazy_calibration_matches_jax(slide_path,
                                                         slide_models,
                                                         batch_size):
    """No ``qtree``: both packages calibrate on the slide's first tissue
    batch (the JAX function on its white-padded buffer, the port on the
    batch plus one white cell when it is short)."""
    jax, jmodel, variables, _, port = slide_models
    ref, jgrid = _jax_predict(jax, slide_path, variables, jmodel,
                              batch_size=batch_size)
    out, grid = psw.predict_slide(slide_path, port, output="margin", int8=True,
                                  batch_size=batch_size, device="cpu",
                                  **SLICE_KW)
    assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    white = ref == psw.NON_TISSUE_MARGIN
    np.testing.assert_array_equal(out == psw.NON_TISSUE_MARGIN, white)
    assert white.any() and (~white).sum() > 4
    if batch_size == 16:
        assert (~white).sum() < batch_size  # the short-batch route
    assert np.isfinite(out).all() and out[~white].std() > 0
    _assert_close(out[~white], ref[~white])


def test_predict_slide_int8_with_a_persisted_tree_matches_jax(slide_path,
                                                              slide_models):
    jax, jmodel, variables, sd, port = slide_models
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quantized as jq,
    )

    calib = [_u8(62, (6, 64, 64, 3))]
    jtree = jq.quantize_resnet18(variables, calib)
    ref, _ = _jax_predict(jax, slide_path, variables, jmodel, batch_size=8,
                          qtree=jtree.tree())
    qtree = quantized_from_jax(_np_tree(jtree))
    launches = (ic.int8_conv_requant_kernel.launches,
                ib.fused_stage1_int8_kernel.launches)
    out, _ = psw.predict_slide(slide_path, port, output="margin", int8=True,
                               qtree=qtree, batch_size=8, device="cpu",
                               **SLICE_KW)
    # on the CPU the wrappers take their plain versions: no launch counted
    assert launches == (ic.int8_conv_requant_kernel.launches,
                        ib.fused_stage1_int8_kernel.launches)
    white = ref == psw.NON_TISSUE_MARGIN
    np.testing.assert_array_equal(out == psw.NON_TISSUE_MARGIN, white)
    _assert_close(out[~white], ref[~white])
    # the artifact's purpose: the same margins at another batch size, and
    # with the port's own tree as with the carried one
    other, _ = psw.predict_slide(slide_path, port, output="margin", int8=True,
                                 qtree=qtree, batch_size=5, device="cpu",
                                 **SLICE_KW)
    np.testing.assert_array_equal(other, out)
    probs, _ = psw.predict_slide(slide_path, port, int8=True, qtree=qtree,
                                 batch_size=8, device="cpu", **SLICE_KW)
    np.testing.assert_array_equal(probs, psw.sigmoid(out))
    own = q.quantize_resnet18(sd, calib, device="cpu").tree()
    mine, _ = psw.predict_slide(slide_path, port, output="margin", int8=True,
                                qtree=own, batch_size=8, device="cpu",
                                **SLICE_KW)
    _assert_close(mine[~white], ref[~white])


def test_predict_slide_int8_refuses_the_device_filter(slide_path, slide_models):
    jax, jmodel, variables, _, port = slide_models
    with pytest.raises(ValueError) as jerr:
        _jax_predict(jax, slide_path, variables, jmodel, tissue_filter="device")
    with pytest.raises(ValueError) as perr:
        psw.predict_slide(slide_path, port, int8=True, tissue_filter="device",
                          device="cpu", **SLICE_KW)
    assert str(perr.value) == str(jerr.value)


def test_predict_and_export_int8_writes_the_csv(slide_path, slide_models,
                                                tmp_path):
    _, _, _, sd, port = slide_models
    qtree = q.quantize_resnet18(sd, [_u8(63, (4, 64, 64, 3))],
                                device="cpu").tree()
    probs, csv_path = psw.predict_and_export(
        slide_path, port, str(tmp_path / "csv"), threshold=1e-9, int8=True,
        qtree=qtree, batch_size=8, device="cpu", **SLICE_KW)
    assert os.path.basename(csv_path) == "tumor_001.csv"
    rows = np.loadtxt(csv_path, delimiter=",", ndmin=2)
    assert rows.shape[1] == 3 and len(rows) > 0
    assert ((probs >= 0) & (probs <= 1)).all()


# ---------------------------------------------------------------------------
# (8) run_feature_extraction(int8=True)
# ---------------------------------------------------------------------------


N, EDGE, BATCH = 40, 32, 16


@pytest.fixture(scope="module")
def feature_setup(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.data import (
        datasets as jax_datasets,
        manifest as jax_manifest,
    )

    root = tmp_path_factory.mktemp("int8_features")
    recs = _write_store(str(root / "patches"))
    trunk = _randomized_variables(jax, 64, fc=False)
    jds = jax_datasets.PatchDataset(jax_manifest.PatchManifest(recs),
                                    resize_to=EDGE)
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=EDGE)
    return jax, trunk, jds, ds, recs


def test_run_feature_extraction_int8_lazy_matches_jax(feature_setup):
    """``int8=True`` without a tree: quantize on load, calibrated on the first
    dataset batches (the JAX package's
    ``test_int8_feature_extraction_wiring``), space-to-depth feed."""
    jax, trunk, jds, ds, recs = feature_setup
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        features as jax_features,
    )

    jfeats, jlabels, jnames = jax_features.run_feature_extraction(
        jds, trunk, batch_size=BATCH, feature_dim=64, int8=True)
    feats, labels, names = features.run_feature_extraction(
        ds, strip_head(state_dict_from_flax(trunk)), batch_size=BATCH,
        feature_dim=64, device="cpu", int8=True)
    assert feats.shape == (N, 64) and feats.dtype == np.float32
    assert np.isfinite(feats).all() and np.abs(feats).sum() > 0
    assert ds.s2d is False  # the caller's dataset is left as it was
    _assert_close(feats, jfeats)
    np.testing.assert_array_equal(labels, jlabels)
    assert names == jnames == [r.patch_name for r in recs]
    cal = features._calibration_batches(ds, BATCH)
    jcal = jax_features._calibration_batches(jds, BATCH)
    assert len(cal) == len(jcal) == 2
    for a, b in zip(cal, jcal):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stem_s2d", [True, False])
def test_run_feature_extraction_int8_with_a_tree_matches_jax(feature_setup,
                                                             stem_s2d):
    jax, trunk, jds, ds, _ = feature_setup
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        features as jax_features,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quantized as jq,
    )

    jtree = jq.quantize_resnet18(trunk, [_u8(65, (8, EDGE, EDGE, 3))],
                                 stem_s2d=stem_s2d)
    jfeats, _, _ = jax_features.run_feature_extraction(
        jds, trunk, batch_size=BATCH, feature_dim=64, int8=True,
        qtree=jtree.tree())
    qtree = quantized_from_jax(_np_tree(jtree))
    state = strip_head(state_dict_from_flax(trunk))
    feats, _, _ = features.run_feature_extraction(
        ds, state, batch_size=BATCH, feature_dim=64, device="cpu", int8=True,
        qtree=qtree)
    _assert_close(feats, jfeats)
    # the artifact's purpose: identical features at another batch size
    other, _, _ = features.run_feature_extraction(
        ds, state, batch_size=7, feature_dim=64, device="cpu", int8=True,
        qtree=qtree)
    np.testing.assert_array_equal(other, feats)
    # and the loop's rows are quant_forward's, whichever layout fed them
    imgs, _ = ds.read_batch(range(N))
    direct = q.quant_forward(qtree, torch.from_numpy(imgs), with_fc=False)
    np.testing.assert_array_equal(feats, direct.numpy())


# ---------------------------------------------------------------------------
# the CLI: --quantize, --extract_features --int8, --predict_slide --int8
# ---------------------------------------------------------------------------


def test_cli_quantize_then_int8_features_on_cpu(tmp_path):
    data_dir, recs = _data_root(tmp_path)
    models_dir = tmp_path / "models"
    state = _randomized_state(66)
    save_model(str(models_dir / "resnet18_patch_classifier"), state)
    common = ["--data_dir", str(data_dir), "--patch_level", "3",
              "--models_dir", str(models_dir), "--device", "cpu"]
    assert cli.main(["--quantize", *common]) == 0
    path = models_dir / qa.CLASSIFIER_ARTIFACT
    assert path.exists()
    tree = qa.load_quantized(str(path))
    assert qa.artifact_input_hw(tree) == (224, 224)
    assert tree["qkernels"]["stem"].shape == (8, 12, 4, 4)  # s2d auto-enabled
    assert tree["fc"] is not None

    assert cli.main(["--extract_features", "--int8", "--batch_size", "5",
                     *common]) == 0
    feats, labels, names = features.load_feature_artifacts(
        str(data_dir / "features"), 3)
    assert feats.shape == (12, 64) and np.isfinite(feats).all()
    ds = datasets.PatchDataset(manifest.PatchManifest(recs))
    want, _, _ = features.run_feature_extraction(
        ds, strip_head(state), batch_size=12, feature_dim=64, device="cpu",
        int8=True, qtree=tree)
    np.testing.assert_array_equal(feats, want)  # the artifact was used
    np.testing.assert_array_equal(labels, [r.label for r in recs])
    assert names == [r.patch_name for r in recs]
    # int8 features track the float32 folded forward they approximate
    imgs, _ = ds.read_batch(range(12))
    ref = q.folded_forward(q.fold_batchnorm(strip_head(state)),
                           torch.from_numpy(imgs), with_fc=False)
    cos = torch.nn.functional.cosine_similarity(torch.from_numpy(feats), ref)
    assert cos.min() > 0.98, cos


def test_cli_quantize_artifact_loads_in_jax(tmp_path):
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quant_artifact as jqa,
        quantized as jq,
    )

    data_dir, recs = _data_root(tmp_path)
    models_dir = tmp_path / "models"
    save_model(str(models_dir / "resnet18_patch_classifier"),
               _randomized_state(67))
    assert cli.main(["--quantize", "--data_dir", str(data_dir), "--models_dir",
                     str(models_dir), "--device", "cpu"]) == 0
    path = str(models_dir / qa.CLASSIFIER_ARTIFACT)
    jtree = jqa.load_quantized(path)
    assert jqa.artifact_input_hw(jtree) == (224, 224)
    imgs = _u8(68, (2, 224, 224, 3))
    want = np.asarray(jq.quant_forward(jtree, jax.numpy.asarray(imgs)))
    got = q.quant_forward(qa.load_quantized(path), torch.from_numpy(imgs))
    _assert_close(got.numpy(), want)


def test_cli_quantize_without_patches_fails(tmp_path):
    """``--quantize`` has no stage gate (the JAX CLI has none): it fails where
    it reads, first at the classifier's weights, then at the empty level."""
    argv = ["--quantize", "--data_dir", str(tmp_path / "nothing"),
            "--models_dir", str(tmp_path / "models"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="resnet18_patch_classifier"):
        cli.main(argv)
    save_model(str(tmp_path / "models" / "resnet18_patch_classifier"),
               _randomized_state(69))
    with pytest.raises(FileNotFoundError, match="no patches at level 3"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "models" / qa.CLASSIFIER_ARTIFACT)


@pytest.mark.parametrize("argv", [
    ["--quantize", "--extract_features"],
    ["--quantize", "--int8"],
    ["--train_mil", "--int8"],
])
def test_cli_int8_flags_go_with_their_actions(argv, capsys, tmp_path):
    """``--int8`` without ``--predict_slide`` or ``--extract_features`` is
    ignored, as the JAX CLI ignores it (``--quantize --int8`` is a valid
    call there): the action runs and fails where it reads."""
    argv = argv + ["--device", "cpu", "--data_dir", str(tmp_path / "none"),
                   "--models_dir", str(tmp_path / "models")]
    if "--int8" not in argv:
        # two actions: --extract_features comes first and has no patches
        assert cli.main(argv) == 1
        return
    missing = ("resnet18_patch_classifier" if "--quantize" in argv
               else "patch_features_3.npy")
    with pytest.raises(FileNotFoundError, match=missing):
        cli.main(argv)
    assert "usage:" not in capsys.readouterr().err


@pytest.mark.parametrize("with_artifact", [True, False],
                         ids=["artifact", "lazy"])
def test_cli_predict_slide_int8_on_cpu(slide_path, tmp_path, with_artifact):
    """``--predict_slide --int8 --device cpu`` as a subprocess writes the CSV
    that an in-process ``predict_and_export(int8=True)`` writes, from the
    artifact when ``--quantize`` left one and from lazy calibration else;
    ``--tissue_filter device`` is turned to the host filter with a warning."""
    state = _randomized_state(69)
    models_dir = tmp_path / "models"
    save_model(str(models_dir / "resnet18_patch_classifier"), state)
    qtree = None
    if with_artifact:
        qtree = q.quantize_resnet18(state, [_u8(70, (4, 224, 224, 3))],
                                    device="cpu").tree()
        qa.save_quantized(str(models_dir / qa.CLASSIFIER_ARTIFACT), qtree)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m",
         "ss25_hierarchical_multiscale_image_classification_tpu_torch.cli.main",
         "--predict_slide", slide_path, "--int8", "--device", "cpu",
         "--tissue_filter", "device", "--stride", "112", "--batch_size", "4",
         "--detect_threshold", "1e-9", "--models_dir", str(models_dir)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert "using host filtering" in proc.stderr
    assert ("using persisted quantization artifact" in proc.stderr) == with_artifact
    rows = np.loadtxt(str(models_dir / "model_predictions_csv" / "tumor_001.csv"),
                      delimiter=",", ndmin=2)
    _, want_csv = psw.predict_and_export(
        slide_path, resnet18_from_state_dict(state), str(tmp_path / "ref"),
        threshold=1e-9, int8=True, qtree=qtree, stride=112, batch_size=4,
        device="cpu")
    want = np.loadtxt(want_csv, delimiter=",", ndmin=2)
    assert rows.shape == want.shape and len(rows) > 0
    np.testing.assert_allclose(rows, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_run_feature_extraction_int8_on_the_card(cuda_device, tmp_path):
    """Full width on the card (the kernels take 64-channel multiples): the
    loop's features against the CPU's plain versions, launches counted."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18FeatureExtractor,
    )

    recs = _write_store(str(tmp_path / "patches"), edge=64, n=10)
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=64)
    g = torch.Generator().manual_seed(0)
    state = ResNet18FeatureExtractor(generator=g).state_dict()
    tree = q.quantize_resnet18(state, [ds.read_batch(range(10))[0]],
                               device="cpu").tree()
    want, _, _ = features.run_feature_extraction(
        ds, state, batch_size=4, device="cpu", int8=True, qtree=tree)
    conv0 = ic.int8_conv_requant_kernel.launches
    block0 = ib.fused_stage1_int8_kernel.launches
    got, _, _ = features.run_feature_extraction(
        ds, state, batch_size=4, device=cuda_device, int8=True, qtree=tree)
    assert ib.fused_stage1_int8_kernel.launches == block0 + 3
    assert ic.int8_conv_requant_kernel.launches == conv0 + 3 * 16
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
