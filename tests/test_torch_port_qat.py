"""Quantization-aware training of the port against the JAX package.

- ``fake_quant_act`` and ``fake_quant_weight``: values equal to JAX's
  exactly (``round`` half to even in both, the scales divided as tensors),
  ties and the clipped range included; gradients exactly the upstream
  gradient (the straight-through estimator passes it through the clip);
- ``qat_forward`` on the same folded weights and activation scales: a
  different float32 summation order (oneDNN against XLA) can move a
  pre-activation across a quantization tie, which changes that value by one
  lattice step. The share of features that differ by more than 1e-5 of
  max|feature| is held to 1 % (measured 0 at 64², max|Δ| 6e-7), the logits
  to a cosine above 0.99999; against the int8 ``quant_forward`` of the
  deployment tree, the JAX test's bound (cosine > 0.995, max|Δ| < 15 %);
- ``qat_finetune`` end to end on the CPU writes an artifact that
  ``load_quantized`` and ``quant_forward`` read, and ``--qat`` then
  ``--predict_slide --int8`` serve it through the command line.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.models import (
    quantized as jq,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    qat as jqat,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quant_artifact as qa,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as pq,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    qat,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)
from tests.test_quantized import _realistic_variables

torch.set_num_threads(2)

FLIP_SHARE = 1e-2  # features more than 1e-5 of max|feature| apart
LOGIT_COS = 0.99999


@pytest.mark.parametrize("case", ["jax_test", "random_clipped", "ties",
                                  "tensor_scale"])
def test_fake_quant_act_values_and_gradient_equal_jax(case):
    rng = np.random.default_rng(0)
    if case == "jax_test":
        x, scale = np.array([-3.0, -0.04, 0.0, 0.06, 2.0], np.float32), 0.1
    elif case == "random_clipped":  # ±1.27 clips
        x, scale = rng.normal(0, 1, 1000).astype(np.float32), 0.01
    elif case == "ties":  # exact half-integer quotients: half to even
        x = ((np.arange(-130, 130) + 0.5) * 0.25).astype(np.float32)
        scale = 0.25
    else:  # a 0-d float32 scale, as calibrate() gives
        x = rng.normal(0, 3, (4, 5, 6)).astype(np.float32)
        scale = np.float32(0.0372)
    up = rng.normal(0, 1, x.shape).astype(np.float32)
    jx = jnp.asarray(x)
    want = np.asarray(jqat.fake_quant_act(jx, scale))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jqat.fake_quant_act(v, scale)
                                               * up))(jx))
    t = torch.from_numpy(x).requires_grad_()
    s = torch.tensor(scale, dtype=torch.float32) if case == "tensor_scale" else scale
    got = qat.fake_quant_act(t, s)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.from_numpy(up)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), jg)
    np.testing.assert_array_equal(t.grad.numpy(), up)  # through the clip too
    if case == "ties":
        q = np.rint(x / np.float32(scale))
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.clip(q, -127, 127) * np.float32(scale))


@pytest.mark.parametrize("shape,zero_channel", [
    ((3, 3, 4, 8), False), ((1, 1, 8, 16), False), ((7, 7, 3, 8), True),
])
def test_fake_quant_weight_values_and_gradient_equal_jax(shape, zero_channel):
    """JAX takes the maximum over HWI of an HWIO kernel; the port over IHW
    of the same kernel in OIHW: the same lattice, value for value."""
    rng = np.random.default_rng(len(shape) + shape[0])
    k = rng.normal(0, 0.2, shape).astype(np.float32)
    if zero_channel:  # its scale clamps at 1e-12
        k[..., 2] = 0.0
    up = rng.normal(0, 1, shape).astype(np.float32)
    jk = jnp.asarray(k)
    want = np.asarray(jqat.fake_quant_weight(jk))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jqat.fake_quant_weight(v)
                                               * up))(jk))
    t = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    got = qat.fake_quant_weight(t)
    np.testing.assert_array_equal(got.detach().numpy().transpose(2, 3, 1, 0),
                                  want)
    (got * torch.from_numpy(up.transpose(3, 2, 0, 1).copy())).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy().transpose(2, 3, 1, 0), jg)
    np.testing.assert_array_equal(jg, up)
    # the deployment lattice: every entry an integer multiple of its scale
    qk, ws, _ = pq._quantize_weights({"c": (t.detach().numpy(), np.zeros(
        shape[3], np.float32))})
    np.testing.assert_array_equal(
        got.detach().numpy(),
        qk["c"].numpy().astype(np.float32) * ws["c"].numpy()[:, None, None, None])


@pytest.fixture(scope="module")
def qat_case():
    """A realistic ResNet18 at 64² (the JAX QAT test's), folded in both
    packages, with JAX's activation scales on 8 calibration cells."""
    _, variables = _realistic_variables(jax.random.key(0), size=64)
    folded = jq.fold_batchnorm(variables)
    rng = np.random.default_rng(1)
    cal = [rng.integers(0, 256, (8, 64, 64, 3)).astype(np.uint8)]
    x = rng.integers(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    state = state_dict_from_flax(variables)
    return variables, folded, jq.calibrate(folded, cal), cal, x, state


@pytest.mark.parametrize("with_fc", [True, False], ids=["logits", "features"])
def test_qat_forward_matches_jax(qat_case, with_fc):
    _, folded, ascales, _, x, state = qat_case
    jfp = {n: {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
           for n, (k, b) in folded.items()}
    want = np.asarray(jqat.qat_forward(jfp, ascales, x, with_fc=with_fc))
    fp = qat.trainable_folded(pq.fold_batchnorm(state), torch.device("cpu"))
    pasc = {k: torch.tensor(np.asarray(v)) for k, v in ascales.items()}
    got = qat.qat_forward(fp, pasc, torch.from_numpy(x),
                          with_fc=with_fc).detach().numpy()
    assert got.shape == want.shape
    if with_fc:
        cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos > LOGIT_COS
    else:
        d = np.abs(got - want)
        assert (d > 1e-5 * np.abs(want).max()).mean() <= FLIP_SHARE
        # a flip moves a feature (a mean over the 2×2 last plane) by a
        # quarter of the last lattice step, at most a few of them
        assert d.max() <= float(ascales["s4b1o"])


def test_qat_forward_tracks_the_int8_deployment(qat_case):
    """The fake-quant float graph against the port's own int8 forward of the
    deployment tree (the JAX test's bound)."""
    _, _, _, cal, x, state = qat_case
    folded = pq.fold_batchnorm(state)
    ascales = pq.calibrate(folded, cal, "cpu")
    q = pq.quantize_folded(folded, cal, fold_stem_normalize=False,
                           device="cpu")
    fq = qat.qat_forward(qat.trainable_folded(folded, torch.device("cpu")),
                         ascales, torch.from_numpy(x)).detach().numpy()
    i8 = pq.quant_forward(pq.quantized_to(q.tree(), "cpu"), torch.from_numpy(x),
                          with_fc=True).numpy()
    cos = (fq * i8).sum() / (np.linalg.norm(fq) * np.linalg.norm(i8) + 1e-12)
    assert cos > 0.995
    assert np.abs(fq - i8).max() / (np.abs(i8).max() + 1e-12) < 0.15


def test_port_qat_gradients_reach_every_conv(qat_case):
    _, _, ascales, _, x, state = qat_case
    fp = qat.trainable_folded(pq.fold_batchnorm(state), torch.device("cpu"))
    pasc = {k: torch.tensor(np.asarray(v)) for k, v in ascales.items()}
    logits = qat.qat_forward(fp, pasc, torch.from_numpy(x[:2]))
    torch.nn.functional.cross_entropy(logits, torch.tensor([0, 1])).backward()
    for name, p in fp.items():
        norm = float(p["kernel"].grad.norm())
        assert np.isfinite(norm) and norm > 0, f"dead gradient at {name}"
        assert p["kernel"].is_contiguous(memory_format=torch.channels_last) \
            or p["kernel"].dim() == 2


def _store(data_dir, edge, per_slide=6, slides=2, level=3, seed=0):
    rng = np.random.default_rng(seed)
    data = config.DataConfig(data_dir=str(data_dir))
    recs = []
    for i in range(slides):
        w = patch_store.PackedPatchWriter(data.patches_dir, level,
                                          f"slide_{i}", edge)
        labels = (np.arange(per_slide) % 2).astype(np.int64)
        x = rng.integers(0, 256, (per_slide, edge, edge, 3), dtype=np.uint8)
        x[labels == 1] //= 2
        recs += w.write_batch(x, np.stack([np.arange(per_slide) * edge,
                                           np.zeros(per_slide, int)], 1),
                              labels)
        w.close()
    manifest.PatchManifest(recs).save(manifest.manifest_npz_path(
        data.patches_dir, level))
    return data, recs


def test_port_qat_finetune_writes_a_served_artifact(tmp_path):
    data, recs = _store(tmp_path / "data", 32)
    cfg = config.Config(data=data, models_dir=str(tmp_path / "models"),
                        train=config.TrainConfig(batch_size=8))
    state = ResNet18Classifier(generator=torch.Generator().manual_seed(5)
                               ).state_dict()
    out = qat.qat_finetune(cfg, variables=state, level=3, epochs=2,
                           batch_size=8, learning_rate=1e-3, input_size=32,
                           n_calib_batches=1, device="cpu")
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    path = os.path.join(cfg.models_dir, qa.CLASSIFIER_ARTIFACT)
    assert out["artifact_path"] == path and os.path.exists(path)
    tree = qa.load_quantized(path)
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=32)
    imgs, _ = ds.read_batch(range(len(ds)))
    logits = pq.quant_forward(pq.quantized_to(tree, "cpu"),
                              torch.from_numpy(imgs), with_fc=True)
    assert logits.shape == (len(ds), 2) and torch.isfinite(logits).all()
    # the same tensors as a post-training artifact, other values: it trained
    ptq = pq.quantize_resnet18(state, [imgs[:8]], device="cpu").tree()
    for field in ("qkernels", "wscales", "biases", "ascales"):
        assert set(tree[field]) == set(ptq[field])
    assert not torch.equal(tree["fc"][0], ptq["fc"][0])
    assert qa.artifact_input_hw(tree) == (32, 32)


def test_cli_qat_then_int8_serves_the_artifact(tmp_path, synthetic_case):
    """``--qat --epochs 1`` from ``resnet18_patch_classifier.pt`` writes
    ``quantized_resnet18.npz`` (at the 224² input size), which
    ``--predict_slide --int8`` picks up."""
    data, _ = _store(tmp_path / "data", 224, per_slide=4)
    models = tmp_path / "models"
    save_model(str(models / "resnet18_patch_classifier"),
               ResNet18Classifier(generator=torch.Generator().manual_seed(6)
                                  ).state_dict())
    common = ["--data_dir", data.data_dir, "--models_dir", str(models),
              "--device", "cpu", "--batch_size", "4"]
    assert cli.main(["--qat", "--epochs", "1", *common]) == 0
    tree = qa.load_quantized(str(models / qa.CLASSIFIER_ARTIFACT))
    assert qa.artifact_input_hw(tree) == (224, 224)
    slide = os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")
    assert cli.main(["--predict_slide", slide, "--int8", "--stride", "112",
                     *common]) == 0
    assert os.path.exists(models / "model_predictions_csv" / "tumor_001.csv")
