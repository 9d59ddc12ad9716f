"""The device paths that ``chip_smoke.py`` drives on the card in its phase 19,
held against the JAX package on the CPU at narrow widths (``num_filters=8``,
where a trunk is the classifier's):

- ``extract_features_with_simclr(int8=True)`` without an artifact (lazy
  calibration) against the JAX function on the same encoder and store;
- int8 on trained weights: a narrow ResNet18 classifier trained for a few
  steps by the port, the same parameters in both packages: the int8 weights
  and weight scales equal, the calibrated trees as ``_assert_same_tree``
  holds them, the int8 margins against JAX's ``quant_forward``, and each
  cell's feature cosine against the float32 folded forward above 0.98 (the
  JAX package's gate for an fc-less trunk, ``tests/test_quantized.py``);
- ``--predict_slide --multiscale`` with each explicit ``--ms_combine``,
  for both fusion modes, against the JAX function's components;
- ``--model_name`` / ``--detect_threshold`` CSVs against JAX's
  ``predict_and_export`` at the same floor.

(The ``balanced`` strategy's first step against JAX's is in
``test_torch_port_train.py``, beside the other steps.)

Tolerances: int8 margins and features within ``INT8_RTOL`` (1 %) of the
largest value, as ``test_torch_port_int8_paths.py`` holds them; CSV
probabilities within 1e-5 relative and coordinates equal, as
``test_torch_port_multiscale.py`` holds the exported CSVs.

The ``cuda``-marked tests hold a frozen-BN bf16 training step and the
attention ``fuse`` on the card to float32 on the CPU, under
``chip_smoke.py``'s bounds (the step's loss within 5e-3, the head's
gradients within 5e-2 of max|g|; logits within 0.1). JAX is imported inside
the tests that compare with it, so the file collects without it.
"""

import copy
import functools
import os
import re

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
    datasets,
    manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer import (
    features,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    NON_TISSUE_MARGIN as NTM,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as q,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    hierarchical_state_dict_from_flax,
    quantized_from_jax,
    resnet18_from_state_dict,
    state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
    HierarchicalPatchClassifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.augment import (
    augment_batch_kernel,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    save_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)
from test_torch_port_cli import _rows
from test_torch_port_features import WIDTH, _data_root, _write_store
from test_torch_port_int8 import _np_tree, _randomized_variables
from test_torch_port_int8_paths import INT8_RTOL, _assert_close
from test_torch_port_multiscale import _assert_same_tree
from test_torch_port_multiscale_data import randomized_hierarchical

torch.set_num_threads(2)

FEATURE_COSINE_MIN = 0.98
CSV_RTOL = 1e-5
# chip_smoke.py's bounds of a bf16 card step against a float32 CPU step
STEP_LOSS_ATOL = 5e-3
STEP_GRAD_RTOL = 5e-2  # of max|grad|, the head's tensors
FUSE_ATOL = 0.1  # logits: the bf16 bound of chip_smoke.py


def _assert_same_rows(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])  # coordinates
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=CSV_RTOL)


# ---------------------------------------------------------------------------
# --extract_features --simclr_features --int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [8, 16], ids=["two_batches", "one_batch"])
def test_simclr_features_int8_lazy_matches_jax(tmp_path, monkeypatch,
                                               batch_size):
    """No artifact: each package quantizes the encoder's trunk on its first
    dataset batches (two of 8, or one of 16 with 4 rows wrapped) and writes
    the triplet. The JAX function preallocates a full-width (512-column)
    memmap, so it is handed the narrow width here."""
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        features as jfeatures,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model as jax_save_model,
    )

    data_dir, recs = _data_root(tmp_path)
    trunk = _randomized_variables(jax, 71, fc=False)
    jdir, pdir = tmp_path / "jax_models", tmp_path / "port_models"
    # the encoder as each package's pretrain_simclr writes it, trunk under
    # "encoder" beside nothing else
    jax_save_model(str(jdir / "simclr_encoder"),
                   {"params": {"encoder": trunk["params"]},
                    "batch_stats": {"encoder": trunk["batch_stats"]}})
    save_model(str(pdir / "simclr_encoder"),
               {f"encoder.{k}": v for k, v in state_dict_from_flax(trunk).items()})
    monkeypatch.setattr(jfeatures, "_features_memmap", functools.partial(
        jfeatures._features_memmap, feature_dim=8 * WIDTH))
    jfeatures.extract_features_with_simclr(
        jconfig.Config(data=jconfig.DataConfig(data_dir=str(data_dir)),
                       models_dir=str(jdir)),
        level=3, batch_size=batch_size, int8=True)
    features_dir = str(data_dir / "features")
    want, want_labels, want_names = features.load_feature_artifacts(
        features_dir, 3)
    for name in os.listdir(features_dir):
        os.remove(os.path.join(features_dir, name))
    cfg = config.Config(data=config.DataConfig(data_dir=str(data_dir)),
                        models_dir=str(pdir))
    features.extract_features_with_simclr(cfg, level=3, batch_size=batch_size,
                                          device="cpu", int8=True)
    feats, labels, names = features.load_feature_artifacts(features_dir, 3)
    assert feats.shape == want.shape == (len(recs), 8 * WIDTH)
    assert np.isfinite(feats).all() and feats.std() > 0
    _assert_close(feats, want)
    np.testing.assert_array_equal(labels, want_labels)
    assert names == want_names == [r.patch_name for r in recs]


# ---------------------------------------------------------------------------
# int8 on trained weights
# ---------------------------------------------------------------------------


_BLOCK = re.compile(r"^stage(\d+)_block(\d+)$")


def _flax_from_state_dict(sd, template):
    """The inverse of ``state_dict_from_flax`` for a ResNet18: ``template``'s
    flax tree with every leaf taken from ``sd``."""
    params = {k: dict(v) for k, v in template["params"].items()}
    stats = {k: dict(v) for k, v in template["batch_stats"].items()}

    def a(key):
        return sd[key].detach().numpy().copy()

    def conv(node, key):
        node["kernel"] = a(f"{key}.weight").transpose(2, 3, 1, 0)

    def norm(p, s, key):
        p["scale"], p["bias"] = a(f"{key}.weight"), a(f"{key}.bias")
        s["mean"], s["var"] = a(f"{key}.running_mean"), a(f"{key}.running_var")

    conv(params["stem_conv"], "conv1")
    norm(params["stem_norm"], stats["stem_norm"], "bn1")
    for name in params:
        m = _BLOCK.match(name)
        if not m:
            continue
        dst = f"layer{m.group(1)}.{m.group(2)}"
        p = params[name] = {k: dict(v) for k, v in params[name].items()}
        s = stats[name] = {k: dict(v) for k, v in stats[name].items()}
        for i in (0, 1):
            conv(p[f"Conv_{i}"], f"{dst}.conv{i + 1}")
            norm(p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"], f"{dst}.bn{i + 1}")
        if "downsample_conv" in p:
            conv(p["downsample_conv"], f"{dst}.downsample.0")
            norm(p["downsample_norm"], s["downsample_norm"],
                 f"{dst}.downsample.1")
    params["fc"] = {"kernel": a("fc.weight").T.copy(), "bias": a("fc.bias")}
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A narrow ResNet18 classifier trained by the port's step for five
    steps (Adam, lr 1e-3, training BN) on 40 seeded 32² patches: its state
    dict, the same parameters as flax variables, and the store's images."""
    jax = pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("trained")
    recs = _write_store(str(root / "patches"), edge=32, n=40, seed=3)
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=32)
    model = ResNet18Classifier(num_filters=WIDTH,
                               generator=torch.Generator().manual_seed(72))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, 1e-3, torch.device("cpu"))
    step = trainer.make_train_step(np.array([1.0, 2.0], np.float32))
    gen = torch.Generator().manual_seed(73)
    for imgs, labels, valid in datasets.BatchIterator(ds, 8, seed=74):
        state, metrics = step(state, gen, torch.from_numpy(imgs),
                              torch.from_numpy(labels).long(),
                              torch.from_numpy(valid))
        assert np.isfinite(metrics["loss"].item())
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert not torch.equal(sd["bn1.running_mean"], init["bn1.running_mean"])
    assert not torch.equal(sd["fc.weight"], init["fc.weight"])
    variables = _flax_from_state_dict(sd, _randomized_variables(jax, 72))
    back = state_dict_from_flax(variables)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    imgs, _ = ds.read_batch(range(len(ds)))
    return jax, sd, variables, imgs


@pytest.mark.parametrize("stem_s2d", [True, False], ids=["s2d", "direct_7x7"])
def test_int8_on_trained_weights_matches_jax(trained, stem_s2d):
    jax, sd, variables, imgs = trained
    from ss25_hierarchical_multiscale_image_classification_tpu.models import (
        quantized as jq,
    )

    calib, held = imgs[:16], imgs[16:]
    # the int8 weights, their scales and the folded biases: equal
    jqk, jws, jbs = jq._quantize_weights(jq.fold_batchnorm(variables))
    qk, ws, bs = q._quantize_weights(q.fold_batchnorm(sd))
    assert set(qk) == set(jqk)
    for name in jqk:
        np.testing.assert_array_equal(qk[name].numpy(),
                                      np.asarray(jqk[name]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(ws[name].numpy(), np.asarray(jws[name]))
        np.testing.assert_array_equal(bs[name].numpy(), np.asarray(jbs[name]))
    # the trees calibrated on the same cells
    jtree = jq.quantize_resnet18(variables, [calib], stem_s2d=stem_s2d)
    tree = q.quantize_resnet18(sd, [calib], stem_s2d=stem_s2d,
                               device="cpu").tree()
    _assert_same_tree(tree, jtree.tree())
    # the int8 margins against JAX's quant_forward: the carried tree and
    # the port's own
    jl = np.asarray(jq.quant_forward(jtree.tree(), jax.numpy.asarray(held)))
    want = jl[:, 1] - jl[:, 0]
    x = torch.from_numpy(held)
    for t in (quantized_from_jax(_np_tree(jtree)), tree):
        logits = q.quant_forward(t, x).numpy()
        margins = logits[:, 1] - logits[:, 0]
        assert np.isfinite(margins).all() and margins.std() > 0
        _assert_close(margins, want)
    assert np.ptp(want) > 10 * INT8_RTOL * np.abs(want).max()
    # the features against the float32 folded forward, cell by cell
    f8 = q.quant_forward(tree, x, with_fc=False)
    f32 = q.folded_forward(q.fold_batchnorm(sd), x, with_fc=False)
    cos = torch.nn.functional.cosine_similarity(f8, f32, dim=1)
    assert cos.min().item() > FEATURE_COSINE_MIN, cos


# ---------------------------------------------------------------------------
# --predict_slide --multiscale --ms_combine <each>
# ---------------------------------------------------------------------------


MS_CAL = {"temperature": 1.5, "aux_temperature": 1.2, "ensemble_weight": 0.3,
          "ensemble_base_weight": 0.6, "combine": 2, "input_mode": 1}
MS_ARGS = ["--levels", "2,3", "--stride", "56", "--batch_size", "4",
           "--detect_threshold", "1e-9"]


@pytest.fixture(scope="module", params=["concat", "attention"])
def ms_artifact(request, synthetic_case, tmp_path_factory):
    """One seeded multiscale classifier of each fusion mode with a
    calibration that selects ``aux`` (so that no explicit mode is the
    default): the port's artifact, and the JAX function's margin
    components on the slide (float32, the CLI's 224² input)."""
    jax = pytest.importorskip("jax")
    import ss25_hierarchical_multiscale_image_classification_tpu.infer.multiscale as jms

    jmodel, variables = randomized_hierarchical(jax, request.param, True,
                                                seed=83)
    variables["calibration"] = dict(MS_CAL)
    models = tmp_path_factory.mktemp(f"ms_{request.param}")
    save_model(str(models / "hierarchical_classifier"),
               hierarchical_state_dict_from_flax(variables))
    slide = os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")
    _, grid, comps = jms.predict_slide_multiscale(
        slide, variables, model=jmodel, levels=(2, 3), stride=56,
        batch_size=4, output="margin", return_components=True)
    return request.param, models, slide, grid, comps


@pytest.mark.parametrize("combine", ["ensemble", "fusion", "aux", "aux_base",
                                     "ensemble_base"])
def test_ms_combine_csv_matches_jax(ms_artifact, combine):
    """``--predict_slide <slide> --multiscale --ms_combine <mode>``: the
    CSV is JAX's ``margin_detections`` of that component."""
    from ss25_hierarchical_multiscale_image_classification_tpu.infer.sliding_window import (
        margin_detections as jax_margin_detections,
    )

    fusion, models, slide, grid, comps = ms_artifact
    assert cli.main(["--predict_slide", slide, "--multiscale", "--ms_combine",
                     combine, *MS_ARGS, "--models_dir", str(models),
                     "--device", "cpu"]) == 0
    got = _rows(str(models / "model_predictions_csv" / "tumor_001.csv"))
    want = np.array(jax_margin_detections(comps[combine], grid, 1e-9),
                    dtype=np.float64).reshape(-1, 3)
    assert len(want) >= 1, (fusion, combine)
    _assert_same_rows(got, want)


# ---------------------------------------------------------------------------
# --model_name, --detect_threshold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantile", [0.3, 0.7])
def test_model_name_and_detect_threshold_match_jax(synthetic_case, tmp_path,
                                                   quantile):
    """``--predict_slide --model_name <name> --detect_threshold <p>`` reads
    ``<models_dir>/<name>.pt`` and writes the CSV that JAX's
    ``predict_and_export`` writes at that floor (float32 both; the floor
    halfway between two neighbouring tissue margins)."""
    jax = pytest.importorskip("jax")
    from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
        sliding_window as jsw,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
        ResNet18Classifier as JaxResNet18Classifier,
    )

    variables = _randomized_variables(jax, 75)
    jmodel = JaxResNet18Classifier(dtype=jax.numpy.float32, num_filters=WIDTH)
    slide = os.path.join(synthetic_case, "train", "img", "tumor_001.wsi.npz")
    kw = dict(stride=56, batch_size=4)

    def tissue_margins():
        margins, _ = jsw.predict_slide(slide, variables, model=jmodel,
                                       output="margin", **kw)
        return np.sort(margins[margins != NTM])

    # the head's bias centres the tissue margins on 0: probabilities that a
    # floor can split
    bias = np.asarray(variables["params"]["fc"]["bias"]).copy()
    bias[1] -= np.median(tissue_margins())
    variables["params"]["fc"]["bias"] = bias
    tissue = tissue_margins()
    k = int(quantile * len(tissue))
    assert tissue[k] - tissue[k - 1] > 1e-3
    threshold = float(1.0 / (1.0 + np.exp(-(tissue[k - 1] + tissue[k]) / 2)))
    _, jcsv = jsw.predict_and_export(slide, variables, str(tmp_path / "jax"),
                                     model=jmodel, threshold=threshold, **kw)
    models = tmp_path / "models"
    save_model(str(models / "my_classifier"), state_dict_from_flax(variables))
    assert cli.main(["--predict_slide", slide, "--model_name", "my_classifier",
                     "--detect_threshold", repr(threshold), "--stride", "56",
                     "--batch_size", "4", "--models_dir", str(models),
                     "--device", "cpu"]) == 0
    got = _rows(str(models / "model_predictions_csv" / "tumor_001.csv"))
    want = _rows(jcsv)
    assert len(want) >= 1 and (want[:, 0] >= threshold).all()
    _assert_same_rows(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frozen_bn_bf16_step_on_the_card_matches_cpu(cuda_device):
    """One frozen-BN step of a full-width ResNet18 (BN statistics set on the
    batch, then frozen; the head scaled to logits under 1, as a trained
    head's: with random weights the trunk's bf16 rounding, ~2 % of the
    features, would move larger logits' loss by as much as the bound):
    bf16 autocast on the card with the ``augment`` kernel against float32
    on the CPU with its plain version, the same weights, cells, draws and
    class weights; the running statistics untouched on both sides."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(90)
    imgs = torch.from_numpy(np.random.default_rng(91).integers(
        0, 256, (8, 128, 128, 3), dtype=np.uint8))
    labels = torch.tensor([0, 1] * 4)
    cw = torch.tensor([1.0, 2.5])
    model = ResNet18Classifier(generator=g)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.momentum = 1.0  # the statistics of this batch
        model.train()(augment.normalize(imgs))
        model.fc.weight.mul_(0.25)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    params = augment.sample_augment_params(torch.Generator().manual_seed(92),
                                           len(imgs))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        m = resnet18_from_state_dict(sd).to(
            dev, memory_format=torch.channels_last).train()
        trainer.set_bn_frozen(m, True)
        p = {k: v.to(dev) for k, v in params.items()}
        x = (augment_batch_kernel(p, imgs.to(dev)) if dev.type == "cuda"
             else augment.augment_batch(p, imgs))
        loss, _ = trainer.classifier_loss(m, x, labels.to(dev), cw.to(dev))
        loss.backward()
        for k, v in m.state_dict().items():
            if "running" in k:
                assert torch.equal(v.cpu(), sd[k]), (dev, k)
        out[dev.type] = (loss.item(), {k: t.grad.float().cpu()
                                       for k, t in m.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= STEP_LOSS_ATOL
    for k in ("fc.weight", "fc.bias"):
        want = out["cpu"][1][k]
        assert ((out["cuda"][1][k] - want).abs().max()
                <= STEP_GRAD_RTOL * want.abs().max()), k


@pytest.mark.cuda
def test_attention_fuse_on_the_card_matches_cpu(cuda_device):
    """The attention head on 32 pooled feature rows × 2 scales: bf16 heads
    on the card (the scale softmax in float32) against float32 on the
    CPU."""
    model = HierarchicalPatchClassifier(
        fusion="attention", generator=torch.Generator().manual_seed(93))
    feats = torch.rand((32, 2, 512), generator=torch.Generator().manual_seed(94)) * 4
    want = model.fuse(feats)
    card = copy.deepcopy(model).for_inference(cuda_device, torch.bfloat16)
    got = card.fuse(feats.to(cuda_device)).float().cpu()
    assert got.shape == want.shape == (32, 2)
    margins = want[:, 1] - want[:, 0]
    assert (margins.max() - margins.min()).item() > 10 * FUSE_ATOL
    assert (got - want).abs().max().item() <= FUSE_ATOL
