"""The port's legacy models and harness against the JAX package, on the CPU.

Legacy code that no CLI path reaches: ``models/resnet.py``'s ResNet50 and
``UnifiedResNet``, ``models/cnn_encoder.py``, ``models/unet.py`` (both
paddings) and ``UNetClassifier``, each loaded from the flax variables
through ``models/convert.py`` and held to the flax forward in float32 at
1e-5 of max|out| (BN statistics randomized); ``strip_head`` and
``merge_trunk`` exactly; ``train/generic_classifier.py``: the 70/15/15 split
exactly, the trainer's step against JAX's at the step tests' tolerances
(``tests/test_torch_port_train.py``: 5e-3 of the loss, 1e-3 of max|g|), a
fit that learns and the ``torch.export`` round trip; and
``data/mil.py::image_bags_from_manifest`` exactly.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    manifest as jmanifest,
    mil as jmil,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models import (
    cnn_encoder as jcnn,
    resnet as jresnet,
    unet as junet,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    generic_classifier as jgeneric,
    losses as jlosses,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    manifest,
    mil,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    cnn_encoder,
    convert,
    resnet,
    unet,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    generic_classifier as generic,
)

from test_torch_port_features import _data_root
from test_torch_port_train import _randomized

torch.set_num_threads(2)

OUT_RTOL = 1e-5  # of max|out|
LOSS_RTOL = 5e-3
GRAD_RTOL = 1e-3  # of the tensor's max|g|


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def _init(model, shape, seed=0, **kw):
    return jax.jit(lambda k: model.init(k, jnp.zeros(shape), **kw))(
        jax.random.key(seed))


# ---------------------------------------------------------------------------
# the ResNet family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [2, None], ids=["classifier",
                                                        "features"])
def test_resnet50_equals_flax(num_classes):
    jm = jresnet.ResNet50(num_classes=num_classes, num_filters=8,
                          dtype=jnp.float32)
    v = _randomized(_init(jm, (1, 32, 32, 3), train=False), seed=1)
    x = _x((2, 32, 32, 3))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    m = resnet.ResNet50(num_classes=num_classes, num_filters=8)
    m.load_state_dict(convert.state_dict_from_flax(v), strict=False)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2 if num_classes else 256)
    close(got, want, OUT_RTOL)


def test_resnet50_layout_is_torchvisions():
    sd = resnet.ResNet50(num_classes=10).state_dict()
    assert sd["layer1.0.conv3.weight"].shape == (256, 64, 1, 1)
    assert sd["layer1.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert sd["layer4.2.bn3.weight"].shape == (2048,)
    assert not sd["layer4.2.bn3.weight"].any()  # zero-initialized last BN
    assert sd["fc.weight"].shape == (10, 2048)
    assert sum(v.numel() for k, v in sd.items()
               if not k.startswith("fc.") and "running" not in k
               and "num_batches" not in k) == 23_508_032


@pytest.mark.parametrize("mode", ["features", "classifier"])
def test_unified_resnet_equals_flax(mode):
    jm = jresnet.UnifiedResNet(mode, num_classes=3, num_filters=8,
                               dtype=jnp.float32)
    v = _randomized(_init(jm, (1, 32, 32, 3), train=False), seed=2)
    x = _x((2, 32, 32, 3), seed=1)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    m = resnet.UnifiedResNet(mode, num_classes=3, num_filters=8)
    m.load_state_dict(convert.state_dict_from_flax(v), strict=False)
    with torch.no_grad():
        close(m.eval()(torch.from_numpy(x)).numpy(), want, OUT_RTOL)
    with pytest.raises(ValueError, match="unknown mode"):
        resnet.UnifiedResNet("segmentation")


def test_strip_head_and_merge_trunk_equal_jax():
    jm = jresnet.ResNet18Classifier(num_classes=2, num_filters=8,
                                    dtype=jnp.float32)
    a = _randomized(_init(jm, (1, 32, 32, 3), train=False), seed=3)
    b = _randomized(_init(jm, (1, 32, 32, 3), seed=1, train=False), seed=4)
    sd = convert.state_dict_from_flax
    stripped = resnet.strip_head(sd(a))
    want = sd({"params": {**jresnet.strip_head(a)["params"],
                          "fc": a["params"]["fc"]},
               "batch_stats": jresnet.strip_head(a)["batch_stats"]})
    assert stripped.keys() == {k for k in want if not k.startswith("fc.")}
    for k, t in stripped.items():
        assert torch.equal(t, want[k]), k
    merged = resnet.merge_trunk(sd(a), sd(b))
    jmerged = sd(jresnet.merge_trunk(a, b))
    assert merged.keys() == jmerged.keys()
    for k, t in merged.items():
        assert torch.equal(t, jmerged[k]), k
    assert torch.equal(merged["fc.weight"], sd(a)["fc.weight"])
    assert torch.equal(merged["conv1.weight"], sd(b)["conv1.weight"])
    # a target-only entry stays the target's
    only = resnet.merge_trunk({"extra.w": torch.ones(2)}, sd(b))
    assert torch.equal(only["extra.w"], torch.ones(2))
    assert convert.strip_head is resnet.strip_head


# ---------------------------------------------------------------------------
# the CNN encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("freeze", [True, False])
def test_cnn_encoder_equals_flax(freeze):
    jm = jcnn.CNNEncoder(feature_dim=32, freeze_trunk=freeze,
                         dtype=jnp.float32)
    v = _init(jm, (1, 32, 32, 3))
    v = {"params": v["params"],
         "batch_stats": _randomized({"params": {}, "batch_stats": {
             "trunk": v["batch_stats"]["trunk"]}}, seed=5)["batch_stats"]}
    x = _x((2, 32, 32, 3), seed=2)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = cnn_encoder.CNNEncoder(feature_dim=32, freeze_trunk=freeze)
    m.load_state_dict(convert.cnn_encoder_state_dict_from_flax(v),
                      strict=False)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32) and m.get_feature_dimension() == 32
    close(got, want, OUT_RTOL)


def test_cnn_encoder_freeze_cuts_the_trunks_gradient_and_statistics():
    m = cnn_encoder.CNNEncoder(feature_dim=16).train()
    assert not m.trunk.training and m.projection.training
    before = m.trunk.bn1.running_mean.clone()
    m(torch.from_numpy(_x((2, 32, 32, 3)))).sum().backward()
    assert m.trunk.conv1.weight.grad is None
    assert m.projection.weight.grad is not None
    assert torch.equal(m.trunk.bn1.running_mean, before)
    free = cnn_encoder.CNNEncoder(feature_dim=16, freeze_trunk=False).train()
    free(torch.from_numpy(_x((2, 32, 32, 3)))).sum().backward()
    assert free.trunk.conv1.weight.grad is not None


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding,size,out", [("SAME", 32, 32),
                                              ("VALID", 60, 20),
                                              ("SAME", 24, 24)])
def test_unet_equals_flax(padding, size, out):
    jm = junet.UNet(out_channels=3, features=(4, 8), bottleneck_features=16,
                    padding=padding, dtype=jnp.float32)
    v = _init(jm, (1, size, size, 3))
    x = _x((2, size, size, 3), seed=3)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = unet.UNet(3, (4, 8), 16, padding)
    m.load_state_dict(convert.unet_state_dict_from_flax(v))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == (2, out, out, 3)
    close(got, want, OUT_RTOL)


@pytest.mark.parametrize("features", [(4, 8), (4, 8, 16)])
def test_unet_classifier_equals_flax(features):
    jm = junet.UNetClassifier(num_classes=5, features=features,
                              dtype=jnp.float32)
    v = _init(jm, (1, 32, 32, 3))
    x = _x((2, 32, 32, 3), seed=4)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = unet.UNetClassifier(5, features)
    m.load_state_dict(convert.unet_state_dict_from_flax(v))
    with torch.no_grad():
        close(m(torch.from_numpy(x)).numpy(), want, OUT_RTOL)


def test_unet_defaults_are_the_jax_ones():
    sd = unet.UNet().state_dict()
    assert sd["trunk.down.0.conv0.weight"].shape == (64, 3, 3, 3)
    assert sd["trunk.bottleneck.conv1.weight"].shape == (1024, 1024, 3, 3)
    assert sd["trunk.up.0.weight"].shape == (1024, 512, 2, 2)
    assert sd["head.weight"].shape == (2, 64, 1, 1)
    c = unet.UNetClassifier().state_dict()
    assert c["head.weight"].shape == (200, 64)
    assert c["trunk.bottleneck.conv0.weight"].shape == (1024, 512, 3, 3)


@pytest.mark.parametrize("shape,target", [((1, 9, 7, 2), (5, 4)),
                                          ((2, 8, 8, 3), (8, 8))])
def test_center_crop_equals_jax(shape, target):
    x = _x(shape)
    np.testing.assert_array_equal(
        unet.center_crop(torch.from_numpy(x), *target).numpy(),
        np.asarray(junet.center_crop(jnp.asarray(x), *target)))


# ---------------------------------------------------------------------------
# the generic classifier harness
# ---------------------------------------------------------------------------

def _toy(n=60, size=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    base = np.where(labels[:, None, None, None] == 1, 180, 70)
    images = np.clip(base + rng.normal(0, 20, (n, size, size, 3)), 0,
                     255).astype(np.uint8)
    return images, labels.astype(np.int32)


@pytest.mark.parametrize("n,seed", [(120, 0), (61, 3), (7, 1)])
def test_array_dataset_split_equals_jax(n, seed):
    images, labels = _toy(n)
    got = generic.ArrayDataset.from_arrays(images, labels, seed=seed)
    want = jgeneric.ArrayDataset.from_arrays(images, labels, seed=seed)
    for field in ("train_x", "train_y", "val_x", "val_y", "test_x",
                  "test_y"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def _models(kind):
    """(flax model, its variables, the port model loaded from them,
    their state dict converter)."""
    if kind == "unet":
        jm = junet.UNetClassifier(num_classes=2, features=(4, 8),
                                  dtype=jnp.float32)
        v = _init(jm, (1, 16, 16, 3), seed=7, train=False)
        m = unet.UNetClassifier(2, (4, 8))
        conv = convert.unet_state_dict_from_flax
    else:
        jm = jresnet.ResNet((1, 1), num_classes=2, num_filters=8,
                            dtype=jnp.float32)
        v = _randomized(_init(jm, (1, 16, 16, 3), seed=7, train=False),
                        seed=8)
        m = resnet.ResNet((1, 1), 2, 8)
        conv = convert.state_dict_from_flax
    m.load_state_dict(conv(v), strict=False)
    return jm, v, m, conv


@pytest.mark.parametrize("kind", ["unet", "resnet_bn"])
def test_generic_trainer_step_matches_jax(kind):
    jm, v, m, conv = _models(kind)
    images, labels = _toy(8)
    x = images.astype(np.float32) / 255.0
    has_stats = "batch_stats" in v

    def loss_fn(p):
        variables = {"params": p, **({"batch_stats": v["batch_stats"]}
                                     if has_stats else {})}
        if has_stats:
            logits, _ = jm.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        else:
            logits = jm.apply(variables, jnp.asarray(x), train=True)
        return jlosses.weighted_cross_entropy(logits, jnp.asarray(labels))

    loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    want = conv({"params": jax.device_get(grads),
                 **({"batch_stats": v["batch_stats"]} if has_stats else {})})
    trainer = generic.GenericClassifierTrainer(m, (1, 16, 16, 3), 2,
                                               device="cpu")
    got_loss, _ = trainer.train_step(torch.from_numpy(x),
                                     torch.from_numpy(labels.astype(np.int64)))
    close(float(got_loss), float(loss), LOSS_RTOL)
    grads_t = {k: p.grad for k, p in m.named_parameters()}
    assert grads_t.keys() <= want.keys()
    for k, g in grads_t.items():
        close(g.numpy(), want[k].numpy(), GRAD_RTOL)


def test_generic_trainer_fit_matches_jax_losses():
    jm, v, m, _ = _models("unet")
    images, labels = _toy(40, seed=2)
    ds = generic.ArrayDataset.from_arrays(images, labels)
    jt = jgeneric.GenericClassifierTrainer(jm, (1, 16, 16, 3), 2,
                                           learning_rate=1e-3)
    jt.params = v["params"]
    jt.opt_state = jt.tx.init(jt.params)
    want = jt.fit(jgeneric.ArrayDataset.from_arrays(images, labels), epochs=2,
                  batch_size=12)
    got = generic.GenericClassifierTrainer(m, (1, 16, 16, 3), 2,
                                           learning_rate=1e-3,
                                           device="cpu").fit(ds, epochs=2,
                                                             batch_size=12)
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        close(g["loss"], w["loss"], LOSS_RTOL)


def test_generic_trainer_learns():
    images, labels = _toy(120)
    ds = generic.ArrayDataset.from_arrays(images, labels)
    trainer = generic.GenericClassifierTrainer(
        resnet.ResNet((1, 1), 2, 8), (1, 16, 16, 3), 2, learning_rate=1e-2,
        device="cpu")
    trainer.fit(ds, epochs=8, batch_size=32)
    assert trainer.evaluate(ds.test_x, ds.test_y) >= 0.9


@pytest.mark.parametrize("kind", ["unet", "resnet_bn"])
def test_generic_trainer_export_round_trips(kind, tmp_path):
    _, _, m, _ = _models(kind)
    trainer = generic.GenericClassifierTrainer(m, (2, 16, 16, 3), 2,
                                               device="cpu")
    images, labels = _toy(40)
    trainer.fit(generic.ArrayDataset.from_arrays(images, labels), epochs=1,
                batch_size=8)
    path = str(tmp_path / "out" / "model.pt2")
    trainer.export(path)
    program = torch.export.load(path).module()
    x = torch.from_numpy(images[:2].astype(np.float32) / 255.0)
    with torch.no_grad():
        np.testing.assert_array_equal(program(x).numpy(),
                                      trainer.model.eval()(x).numpy())


# ---------------------------------------------------------------------------
# image bags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resize_to", [16, 32])
def test_image_bags_from_manifest_equal_jax(tmp_path, resize_to):
    data_dir, _ = _data_root(tmp_path, n=14)
    path = manifest.manifest_path(str(data_dir / "patches"), 3)
    got = mil.image_bags_from_manifest(manifest.PatchManifest.load(path),
                                       resize_to=resize_to)
    want = jmil.image_bags_from_manifest(jmanifest.PatchManifest.load(path),
                                         resize_to=resize_to)
    assert [b.slide for b in got] == [b.slide for b in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.label == w.label
        assert g.features.dtype == np.uint8
        assert g.features.shape[1:] == (resize_to, resize_to, 3)
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.coords, w.coords)


def test_flax_names_of_the_bottleneck_blocks():
    """The converter's Bottleneck entries: Conv_2/BatchNorm_2 exist only in
    the flax Bottleneck, which a BasicBlock tree lacks."""
    shapes = jax.eval_shape(lambda: jresnet.ResNet50(
        num_classes=None, num_filters=8, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    block = shapes["params"]["stage1_block0"]
    assert {"Conv_2", "BatchNorm_2", "downsample_conv"} <= set(block)
    assert "Conv_2" not in jax.eval_shape(lambda: jresnet.ResNet18Classifier(
        num_filters=8).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                            train=False))["params"]["stage1_block0"]
    assert isinstance(jcnn.CNNEncoder(), fnn.Module)
