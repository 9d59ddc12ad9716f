"""The port's patch-classifier trainer against the JAX package's.

The same numpy inputs go through the JAX functions and the port's, on the
CPU: configuration, manifest filters and persistence, the slide-level split
(equal to sklearn's ``train_test_split`` over a sweep), dataset balancing,
samplers and batch iteration over two epochs (equal), class weights, one
training step at 32² with a narrow ResNet18 (loss, gradients and running
statistics, for ``frozen_bn`` off and on, with and without class weights,
given the same augmentation draws), Adam from optax's moments, ``frozen_bn``,
``Trainer.fit``'s artifacts and history, the ``self_supervised`` gate and
encoder lift, the torchvision warm start, ``--evaluate``, and the command
line's training actions, gates and order.
"""

import dataclasses
import importlib
import json
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu import config as jconfig
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    augment as jaugment,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    datasets as jdatasets,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    manifest as jmanifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    losses as jlosses,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    trainer as jtrainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train.state import (
    create_train_state as jax_train_state,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.classifier_eval import (
    evaluate_resnet_classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    torch_import,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    adam_state_from_optax,
    classifier_trunk_from_simclr,
    state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet,
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    SimCLRModel,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    losses,
    trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
    save_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)

torch.set_num_threads(2)

SIZE = 32  # layer4 is 1×1: its BN reduces over B values
WIDTH = 8  # stem width of the narrow ResNet18


def _records(slides=5, per_slide=7, seed=0, level=3):
    """Manifest records of ``slides`` slides with uneven class mixes."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(slides):
        for j in range(per_slide + i):
            recs.append(dict(slide=f"slide_{i:02d}", level=level, x=224 * j,
                             y=224 * i, label=int(rng.random() < 0.3 + 0.1 * i),
                             store="packed", path=f"/p/slide_{i:02d}.pack",
                             row=j))
    return ([manifest.PatchRecord(**r) for r in recs],
            [jmanifest.PatchRecord(**r) for r in recs])


def _as_dicts(m):
    return [dataclasses.asdict(r) for r in m]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_trainer_config_copies_equal_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(config.TrainConfig) == fields(jconfig.TrainConfig)
    assert fields(config.ModelConfig) == fields(jconfig.ModelConfig)
    jdata = dict(fields(jconfig.DataConfig))
    for name, value in fields(config.DataConfig):
        assert jdata[name] == value, name
    assert {"val_fraction", "split_seed", "balance_val_seed", "train_img_subdir",
            "test_img_subdir"} <= {n for n, _ in fields(config.DataConfig)}
    assert config.Config().log_dir == jconfig.Config().log_dir


def test_config_from_dict_reaches_the_trainer_fields():
    d = {"train": {"epochs": 3, "learning_rate": 0.5, "freeze_bn": True,
                   "strategy_epochs": 2, "checkpoint_every_epochs": 1},
         "model": {"num_classes": 3, "pretrained": False},
         "data": {"val_fraction": 0.3, "split_seed": 7, "balance_val_seed": 1},
         "log_dir": "/l"}
    cfg, jcfg = config.Config.from_dict(d), jconfig.Config.from_dict(d)
    for section in ("train", "model"):
        assert (dataclasses.asdict(getattr(cfg, section))
                == dataclasses.asdict(getattr(jcfg, section)))
    for key in ("val_fraction", "split_seed", "balance_val_seed"):
        assert getattr(cfg.data, key) == getattr(jcfg.data, key)
    assert cfg.log_dir == jcfg.log_dir == "/l"
    assert cfg.replace(log_dir="x").train.epochs == 3


# ---------------------------------------------------------------------------
# manifest, split, datasets, samplers
# ---------------------------------------------------------------------------


def test_manifest_filters_and_parquet_equal_jax(tmp_path):
    recs, jrecs = _records()
    m, jm = manifest.PatchManifest(recs), jmanifest.PatchManifest(jrecs)
    assert m.slides() == jm.slides()
    pick = ["slide_03", "slide_01", "nope"]
    assert _as_dicts(m.for_slides(pick)) == _as_dicts(jm.for_slides(pick))
    assert (_as_dicts(m.filter(lambda r: r.label == 1))
            == _as_dicts(jm.filter(lambda r: r.label == 1)))
    assert m.records == recs
    # the port writes parquet the JAX package reads, and reads the JAX file
    m.save(str(tmp_path / "p.parquet"))
    jm.save(str(tmp_path / "j.parquet"))
    assert _as_dicts(jmanifest.PatchManifest.load(str(tmp_path / "p.parquet"))) \
        == _as_dicts(jm)
    assert _as_dicts(manifest.PatchManifest.load(str(tmp_path / "j.parquet"))) \
        == _as_dicts(jm)


def test_manifest_npz_for_machines_without_pyarrow(tmp_path):
    recs, _ = _records(slides=2)
    patches_dir = str(tmp_path / "patches")
    manifest.PatchManifest(recs).save(manifest.manifest_npz_path(patches_dir, 3))
    loaded = manifest.load_or_scan_manifest(patches_dir, 3)
    assert loaded.records == recs
    assert all(type(r.x) is int and type(r.slide) is str for r in loaded)
    assert manifest.patches_extracted(config.DataConfig(data_dir=str(tmp_path)),
                                      3)
    # parquet comes first where both are present
    manifest.PatchManifest(recs[:3]).save(manifest.manifest_path(patches_dir, 3))
    assert len(manifest.load_or_scan_manifest(patches_dir, 3)) == 3
    empty = str(tmp_path / "e.npz")
    manifest.PatchManifest([]).save(empty)
    assert len(manifest.PatchManifest.load(empty)) == 0


def test_slide_level_split_equals_sklearn_over_a_sweep():
    from sklearn.model_selection import train_test_split

    def outcome(fn, *args, **kw):
        try:
            return tuple(map(list, fn(*args, **kw)))
        except ValueError:
            return "raises"

    raised = 0
    for n in range(1, 60):
        slides = [f"s{i:03d}" for i in range(n)][::-1]  # unsorted input
        for seed in (0, 1, 7, 42, 123):
            for f in (0.1, 0.2, 0.25, 0.5, 0.9):
                got = outcome(datasets.slide_level_split, slides, f, seed)
                assert got == outcome(jdatasets.slide_level_split, slides, f,
                                      seed)
                if n >= 2:
                    assert got == outcome(train_test_split, sorted(slides),
                                          test_size=f, random_state=seed)
                raised += got == "raises"
    assert raised > 0  # an empty training side raises in all three


@pytest.mark.parametrize("f", [0.0, 1.0, 1.5])
def test_slide_level_split_raises_where_sklearn_raises(f):
    slides = ["a", "b", "c"]
    with pytest.raises(ValueError):
        jdatasets.slide_level_split(slides, f, 0)
    with pytest.raises(ValueError):
        datasets.slide_level_split(slides, f, 0)


def test_single_slide_split_goes_both_ways():
    assert (datasets.slide_level_split(["only"]) ==
            jdatasets.slide_level_split(["only"]) == (["only"], ["only"]))


@pytest.mark.parametrize("kw", [dict(), dict(balanced=True),
                                dict(balanced=True, max_samples=4),
                                dict(max_samples=5, seed=3),
                                dict(slide_names=["slide_02", "slide_04"],
                                     balanced=True, seed=9)])
def test_from_manifest_equal_jax(kw):
    recs, jrecs = _records(seed=1)
    got = datasets.PatchDataset.from_manifest(manifest.PatchManifest(recs), **kw)
    want = jdatasets.PatchDataset.from_manifest(jmanifest.PatchManifest(jrecs),
                                                **kw)
    assert _as_dicts(got.manifest) == _as_dicts(want.manifest)
    assert got.resize_to == want.resize_to


def test_balance_and_train_val_datasets_equal_jax():
    recs, jrecs = _records(slides=7, seed=2)
    m, jm = manifest.PatchManifest(recs), jmanifest.PatchManifest(jrecs)
    for seed in (0, 42):
        assert (_as_dicts(datasets.balance_to_min_class(m, seed))
                == _as_dicts(jdatasets.balance_to_min_class(jm, seed)))
    tr, va = datasets.make_train_val_datasets(m, 0.3, 5, 6)
    jtr, jva = jdatasets.make_train_val_datasets(jm, 0.3, 5, 6)
    assert _as_dicts(tr.manifest) == _as_dicts(jtr.manifest)
    assert _as_dicts(va.manifest) == _as_dicts(jva.manifest)
    assert va.class_counts() == jva.class_counts()
    assert len(set(r.slide for r in tr.manifest) & set(r.slide for r in va.manifest)) == 0


def test_balanced_sampler_equal_jax():
    labels = np.array([0] * 13 + [1] * 4 + [0] * 3)
    for kw in (dict(), dict(num_samples=9, seed=4)):
        s, js = datasets.BalancedSampler(labels, **kw), jdatasets.BalancedSampler(labels, **kw)
        for epoch in range(3):
            np.testing.assert_array_equal(s.epoch_indices(epoch),
                                          js.epoch_indices(epoch))


class _Data:
    """A dataset stand-in whose 'images' are the row indices."""

    def __init__(self, n, labels):
        self.n, self.labels = n, np.asarray(labels)

    def __len__(self):
        return self.n

    def read_batch(self, idx):
        idx = np.asarray(idx)
        return idx[:, None, None, None].astype(np.uint8), self.labels[idx]


@pytest.mark.parametrize("kw", [dict(), dict(drop_remainder=True),
                                dict(sampler="balanced"),
                                dict(sampler="balanced", drop_remainder=True),
                                dict(shuffle=False)])
def test_batch_iterator_two_epochs_equal_jax(kw):
    labels = (np.arange(23) % 5 == 0).astype(np.int64)
    data = _Data(23, labels)
    runs = []
    for mod in (datasets, jdatasets):
        args = dict(kw)
        if args.get("sampler") == "balanced":
            args["sampler"] = mod.BalancedSampler(labels, seed=2)
        it = mod.BatchIterator(data, 8, seed=5, **args)
        epochs = [[(i[:, 0, 0, 0].tolist(), t.tolist(), v.tolist()) for i, t, v in it]
                  for _ in range(2)]
        it.set_epoch(0)  # set_epoch replays the first epoch
        epochs.append([(i[:, 0, 0, 0].tolist(), t.tolist(), v.tolist())
                       for i, t, v in it])
        runs.append((len(it), epochs))
    assert runs[0] == runs[1]
    assert runs[0][1][0] == runs[0][1][2]


# ---------------------------------------------------------------------------
# losses, torchvision warm start, encoder lift, Adam from optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labels,classes", [([0] * 90 + [1] * 10, 2),
                                            ([1, 1, 1], 2), ([0, 2, 2, 1], 3)])
def test_class_weights_equal_jax(labels, classes):
    labels = np.asarray(labels)
    for fn in ("class_weights_inv_min", "class_weights_total_over_count"):
        got = getattr(losses, fn)(labels, classes)
        want = getattr(jlosses, fn)(labels, classes)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_pretrained_resnet18_absent_then_loaded(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert torch_import.load_pretrained_resnet18() is None
    src = ResNet18Classifier(num_classes=1000,
                             generator=torch.Generator().manual_seed(3))
    path = torch_import.pretrained_path()
    os.makedirs(os.path.dirname(path))
    torch.save(src.state_dict(), path)  # torchvision's names
    trunk = torch_import.load_pretrained_resnet18()
    assert trunk is not None and not any(k.startswith("fc.") for k in trunk)
    model = ResNet18Classifier()
    trainer.load_trunk(model, trunk)
    got = model.state_dict()
    for k, v in src.state_dict().items():
        if not k.startswith("fc."):
            assert torch.equal(got[k], v), k
    assert got["fc.weight"].shape == (2, 512)  # a fresh head
    assert "fc.weight" in torch_import.load_pretrained_resnet18(include_head=True)


def test_encoder_lift_puts_the_simclr_trunk_under_a_fresh_head():
    enc = SimCLRModel(generator=torch.Generator().manual_seed(5))
    trunk = classifier_trunk_from_simclr(enc.state_dict())
    assert not any(k.startswith(("encoder.", "projector.")) for k in trunk)
    model = ResNet18Classifier(generator=torch.Generator().manual_seed(6))
    head = model.fc.weight.detach().clone()
    trainer.load_trunk(model, trunk)
    for k, v in enc.encoder.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(model.fc.weight, head)
    with pytest.raises(KeyError):
        trainer.load_trunk(model, {"conv1.weight": trunk["conv1.weight"]})


def test_adam_from_optax_moments_matches_optax():
    """optax's Adam state after one update, loaded into the port's Adam,
    then one more update on both sides."""
    model = JaxResNet((2, 2, 2, 2), num_classes=2, num_filters=WIDTH,
                      dtype=jnp.float32)
    variables = model.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    params = variables["params"]
    rng = np.random.default_rng(3)

    def grads_like(p):
        return jax.tree.map(lambda a: jnp.asarray(
            np.sign(rng.normal(size=a.shape)) * rng.uniform(0.5, 1.5, a.shape),
            jnp.float32), p)

    tx = optax.adam(1e-3)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    apply = jax.jit(optax.apply_updates)
    opt_state = tx.init(params)
    updates, opt_state = update(grads_like(params), opt_state, params)
    params = apply(params, updates)
    port = ResNet((2, 2, 2, 2), 2, WIDTH)
    port.load_state_dict(state_dict_from_flax(
        {"params": params, "batch_stats": variables["batch_stats"]}), strict=False)
    state = create_train_state(port, 1e-3, torch.device("cpu"))
    adam = opt_state[0]
    state.optimizer.load_state_dict({
        "state": adam_state_from_optax(port, adam.count, adam.mu, adam.nu),
        "param_groups": state.optimizer.state_dict()["param_groups"]})
    g = grads_like(params)
    updates, _ = update(g, opt_state, params)
    params = apply(params, updates)
    gsd = state_dict_from_flax({"params": g, "batch_stats": variables["batch_stats"]})
    for name, p in port.named_parameters():
        p.grad = gsd[name].clone()
    state.optimizer.step()
    want = state_dict_from_flax({"params": params,
                                 "batch_stats": variables["batch_stats"]})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one training step against the JAX step
# ---------------------------------------------------------------------------


def _randomized(variables, seed):
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0.0, 0.1, s),
            "mean": lambda s: rng.normal(0.0, 0.5, s),
            "var": lambda s: rng.uniform(0.5, 2.0, s)}

    def walk(tree, in_norm):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_norm or "norm" in k.lower()
                              or k.startswith("BatchNorm"))
            elif in_norm and k in draw:
                out[k] = draw[k](np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


# As the SimCLR step test: float32 on both sides through ResNet18 at 32²,
# layer4's BN over 4 values; the frameworks' float32 gradients differ by up
# to 2.5e-4 of a tensor's max|g| there.
GRAD_RTOL = 1e-3  # of the tensor's max|g|
STATS_RTOL = 1e-5  # of the tensor's max|value|


@pytest.fixture(scope="module", params=[(False, False), (False, True),
                                        (True, False), (True, True)],
                ids=["plain", "weighted", "frozen", "frozen-weighted"])
def jax_step(request):
    """The JAX train step on 4 images at 32² (one padded row), float32
    ResNet18 of width 8 with randomized BN, given the augmentation draws
    of ``sample_augment_params(step_rng, 4)``; and the loss gradients."""
    frozen, weighted = request.param
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    labels = np.array([0, 1, 1, 0], np.int32)
    valid = np.array([1, 1, 1, 0], np.float32)
    cw = np.array([1.0, 2.5], np.float32) if weighted else None
    return _jax_reference_step(frozen, cw, imgs, labels, valid)


def _jax_reference_step(frozen, cw, imgs, labels, valid):
    """The JAX train step of :func:`jax_step` on the given batch."""
    model = JaxResNet((2, 2, 2, 2), num_classes=2, num_filters=WIDTH,
                      dtype=jnp.float32, frozen_bn=frozen)
    init = model.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)),
                      train=False)
    variables = _randomized(init, seed=1)
    step_rng = jax.random.key(11)
    params = jax.device_get(jaugment.sample_augment_params(step_rng,
                                                           len(imgs)))

    state = jax_train_state(model, jax.random.key(0), (1, SIZE, SIZE, 3),
                            optax.adam(1e-4), pretrained_variables=variables)
    x = jaugment.augment_batch(params, jnp.asarray(imgs))

    def loss_fn(p):
        # the step's loss function (train/trainer.py), on the eagerly
        # augmented batch
        v = {"params": p, "batch_stats": state.batch_stats}
        if frozen:
            logits = model.apply(v, x, train=True)
            updates = {"batch_stats": state.batch_stats}
        else:
            logits, updates = model.apply(v, x, train=True,
                                          mutable=["batch_stats"])
        return jlosses.weighted_cross_entropy(
            logits, jnp.asarray(labels),
            None if cw is None else jnp.asarray(cw), jnp.asarray(valid)), updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    # the jitted step itself: XLA's fused augmentation differs from the
    # eager one in the last float32 bit of some elements (2.4e-7)
    _, metrics = jtrainer.make_train_step(cw, frozen_bn=frozen)(
        state, step_rng, jnp.asarray(imgs), jnp.asarray(labels),
        jnp.asarray(valid))
    return types.SimpleNamespace(
        frozen=frozen, cw=cw, variables=variables, imgs=imgs, labels=labels,
        valid=valid, params={k: np.asarray(v) for k, v in params.items()},
        loss=float(loss), metrics=jax.device_get(metrics),
        grads=state_dict_from_flax({"params": jax.device_get(grads),
                                    "batch_stats": variables["batch_stats"]}),
        stats=state_dict_from_flax({"params": variables["params"],
                                    "batch_stats": jax.device_get(
                                        updates["batch_stats"])}))


def test_train_step_matches_jax(jax_step, monkeypatch):
    _assert_port_step_matches(jax_step, monkeypatch)


def _assert_port_step_matches(s, monkeypatch):
    """The port's step on the batch, weights and draws of the JAX step
    ``s``: loss, metrics, gradients and running statistics."""
    model = ResNet((2, 2, 2, 2), 2, WIDTH, frozen_bn=s.frozen)
    model.load_state_dict(state_dict_from_flax(s.variables), strict=False)
    state = create_train_state(model, 1e-4, torch.device("cpu"))
    # the step's own draw replaced by JAX's
    monkeypatch.setattr(augment, "sample_augment_params",
                        lambda g, b: {k: torch.from_numpy(v.copy())
                                      for k, v in s.params.items()})
    step = trainer.make_train_step(s.cw, frozen_bn=s.frozen)
    state, metrics = step(state, torch.Generator(), torch.from_numpy(s.imgs),
                          torch.from_numpy(s.labels).long(),
                          torch.from_numpy(s.valid))
    np.testing.assert_allclose(metrics["loss"].item(), s.loss, rtol=1e-5)
    # against the jitted step's own loss: its inputs differ by ulps, which
    # layer4's BN over 4 values amplifies (measured 1.1e-5 relative)
    np.testing.assert_allclose(metrics["loss"].item(), float(s.metrics["loss"]),
                               rtol=1e-4)
    assert metrics["correct"].item() == float(s.metrics["correct"])
    assert metrics["count"].item() == float(s.metrics["count"]) == s.valid.sum()
    for name, p in model.named_parameters():
        want = s.grads[name].numpy()
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(p.grad.numpy() - want).max() <= GRAD_RTOL * scale, name
    for name, b in model.named_buffers():
        if "running" in name:
            want = s.stats[name].numpy()
            assert (np.abs(b.numpy() - want).max()
                    <= STATS_RTOL * np.abs(want).max()), name
            if s.frozen:  # kept verbatim
                np.testing.assert_array_equal(
                    b.numpy(), state_dict_from_flax(s.variables)[name].numpy())


def test_balanced_first_step_matches_jax(tmp_path, monkeypatch):
    """The ``balanced`` strategy's first step: from one store, both
    packages' split, ``BalancedSampler`` and ``BatchIterator`` give the same
    first batch of 8, and the port's step on it (no class weights) is
    JAX's given the same draws."""
    recs = _store(tmp_path / "data", edge=SIZE)
    jrecs = [jmanifest.PatchRecord(**dataclasses.asdict(r)) for r in recs]
    data, seed = config.DataConfig(), config.TrainConfig().seed
    split = (data.val_fraction, data.split_seed, data.balance_val_seed, SIZE)
    batches = []
    for mod, m in ((datasets, manifest.PatchManifest(recs)),
                   (jdatasets, jmanifest.PatchManifest(jrecs))):
        train_ds, _ = mod.make_train_val_datasets(m, *split)
        sampler = mod.BalancedSampler(train_ds.labels, seed=seed)
        batches.append(next(iter(mod.BatchIterator(
            train_ds, 8, shuffle=True, seed=seed, sampler=sampler))))
    for a, b in zip(*batches):
        np.testing.assert_array_equal(a, b)
    imgs, labels, valid = batches[0]
    assert 0 < labels.sum() < len(labels) and valid.all()
    s = _jax_reference_step(False, None, imgs, labels.astype(np.int32),
                            valid.astype(np.float32))
    _assert_port_step_matches(s, monkeypatch)


def test_frozen_bn_keeps_statistics_and_trains_affine():
    model = ResNet18Classifier(num_filters=WIDTH, frozen_bn=True,
                               generator=torch.Generator().manual_seed(1))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, 1e-2, torch.device("cpu"))
    assert model.training
    assert not any(m.training for m in model.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    step = trainer.make_train_step(None, frozen_bn=True)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (6, SIZE, SIZE, 3), dtype=np.uint8))
    for _ in range(2):
        state, metrics = step(state, torch.Generator().manual_seed(0), imgs,
                              torch.tensor([0, 1] * 3), torch.ones(6))
    after = model.state_dict()
    for k in before:
        if "running" in k:
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["bn1.weight"], after["bn1.weight"])
    assert not torch.equal(before["layer1.0.bn1.bias"], after["layer1.0.bn1.bias"])
    # the training-mode forward is the eval-mode forward
    x = augment.normalize(imgs)
    with torch.no_grad():
        a = model.train()(x)
        b = model.eval()(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_moves_statistics_without_frozen_bn():
    model = ResNet18Classifier(num_filters=WIDTH)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, 1e-2, torch.device("cpu"))
    step = trainer.make_train_step(np.array([1.0, 2.0], np.float32))
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8))
    state, metrics = step(state, torch.Generator().manual_seed(0), imgs,
                          torch.tensor([0, 1, 1, 0]), torch.ones(4))
    assert np.isfinite(metrics["loss"].item())
    assert not torch.equal(before["bn1.running_mean"],
                           model.state_dict()["bn1.running_mean"])


# ---------------------------------------------------------------------------
# Trainer, entry points, evaluation, command line
# ---------------------------------------------------------------------------


def _store(data_dir, slides=3, per_slide=6, edge=16, seed=0, level=3):
    """A packed store of tumor and normal patches with a numpy manifest, and
    one slide file under train/img for the download gate."""
    rng = np.random.default_rng(seed)
    data = config.DataConfig(data_dir=str(data_dir))
    recs = []
    for i in range(slides):
        w = patch_store.PackedPatchWriter(data.patches_dir, level,
                                          f"slide_{i:02d}", edge)
        labels = (np.arange(per_slide) % (2 + i) == 0).astype(np.int64)
        imgs = rng.integers(0, 256, (per_slide, edge, edge, 3), dtype=np.uint8)
        imgs[labels == 1] //= 2  # tumor darker
        coords = np.stack([np.arange(per_slide), np.zeros(per_slide, int)], 1) * edge
        recs += w.write_batch(imgs, coords, labels)
        w.close()
    manifest.PatchManifest(recs).save(manifest.manifest_npz_path(data.patches_dir, level))
    os.makedirs(data.train_img_dir, exist_ok=True)
    open(os.path.join(data.train_img_dir, "slide_00.wsi.npz"), "w").close()
    return recs


def _cfg(tmp_path, **train):
    return config.Config(
        data=config.DataConfig(data_dir=str(tmp_path / "data")),
        models_dir=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"),
        model=config.ModelConfig(pretrained=False),
        train=config.TrainConfig(batch_size=4, **train))


def test_trainer_fit_writes_what_jax_writes(tmp_path):
    _store(tmp_path / "data", per_slide=5)
    cfg = _cfg(tmp_path, checkpoint_every_epochs=2)
    tr = trainer.train_resnet_classifier(cfg, level=3, epochs=3, device="cpu")
    names = sorted(os.listdir(tmp_path / "models"))
    # _best on the first epoch at least, _epoch2 (every 2), the final
    assert names == ["resnet18_patch_classifier.pt",
                     "resnet18_patch_classifier_best.pt",
                     "resnet18_patch_classifier_epoch2.pt"]
    with open(tmp_path / "logs" / "train_history.json") as f:
        history = json.load(f)
    assert history == json.loads(json.dumps(tr.history))
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert set(history[0]) == {"epoch", "train_loss", "train_acc", "steps",
                               "seconds", "val_acc"}
    # 2 training slides of 5 and 6 rows at batch 4: 3 steps an epoch
    assert all(h["steps"] == 3 for h in history)
    assert all(0.0 <= h["val_acc"] <= 1.0 for h in history)
    final = load_model(str(tmp_path / "models" / "resnet18_patch_classifier"))
    assert all(torch.equal(final[k], v) for k, v in tr.variables().items())
    report = evaluate_resnet_classifier(cfg, level=3, batch_size=4, device="cpu")
    assert set(report) == {"accuracy", "precision", "recall", "f1",
                           "confusion_matrix"}
    assert report["confusion_matrix"].sum() > 0


def test_evaluate_needs_the_model(tmp_path):
    _store(tmp_path / "data")
    with pytest.raises(FileNotFoundError):
        evaluate_resnet_classifier(_cfg(tmp_path), level=3, device="cpu")


class _Records(logging.Handler):
    def __init__(self, name):
        super().__init__(logging.INFO)
        self.messages = []
        self.logger = logging.getLogger(name)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


@pytest.mark.parametrize("strategy", ["balanced", "weighted_loss"])
def test_strategies_write_their_artifacts(tmp_path, strategy):
    _store(tmp_path / "data")
    cfg = _cfg(tmp_path, strategy_epochs=1)
    with _Records("hipac.train") as messages:
        tr = trainer.train_resnet_classifier_strategic(cfg, 3, strategy,
                                                       device="cpu")
    assert len(tr.history) == 1
    assert os.path.exists(tmp_path / "models" /
                          f"resnet18_patch_classifier_{strategy}.pt")
    assert os.path.exists(tmp_path / "logs" / f"train_history_{strategy}.json")
    assert any(("total/count" in m) == (strategy == "weighted_loss")
               for m in messages if "Class weights" in m) or strategy == "balanced"
    assert (tr.batch_iter.sampler is not None) == (strategy == "balanced")
    with pytest.raises(ValueError):
        trainer.train_resnet_classifier_strategic(cfg, 3, "nope", device="cpu")


def test_self_supervised_gate_and_lift(tmp_path, monkeypatch):
    """With ``simclr_encoder.pt`` on disk the strategy does not pretrain and
    starts from that encoder; without it, it pretrains first."""
    _store(tmp_path / "data")
    cfg = _cfg(tmp_path, strategy_epochs=1)
    calls = []
    enc = SimCLRModel(generator=torch.Generator().manual_seed(9))

    def fake_pretrain(cfg, level=3, dataset=None, device="cuda", **kw):
        calls.append(len(dataset) if dataset is not None else None)
        save_model(os.path.join(cfg.models_dir, "simclr_encoder"),
                   enc.state_dict())

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
        simclr_trainer,
    )

    monkeypatch.setattr(simclr_trainer, "pretrain_simclr", fake_pretrain)
    seen = []
    real_load_trunk = trainer.load_trunk

    def spy(model, sd):
        seen.append({k: v.clone() for k, v in sd.items()})
        real_load_trunk(model, sd)

    monkeypatch.setattr(trainer, "load_trunk", spy)
    trainer.train_resnet_classifier_strategic(cfg, 3, "self_supervised",
                                              device="cpu")
    assert calls == [None]  # pretrained once, on the level's patches
    trainer.train_resnet_classifier_strategic(cfg, 3, "self_supervised",
                                              device="cpu")
    assert calls == [None]  # the encoder on disk opens the gate
    lifted = classifier_trunk_from_simclr(enc.state_dict())
    for sd in seen:
        assert sd.keys() == lifted.keys()
        assert all(torch.equal(sd[k], lifted[k]) for k in lifted)
    assert os.path.exists(tmp_path / "models" /
                          "resnet18_patch_classifier_self_supervised.pt")


def test_freeze_bn_without_warm_start_warns(tmp_path):
    _store(tmp_path / "data")
    cfg = _cfg(tmp_path, freeze_bn=True)
    with _Records("hipac.train") as messages:
        tr = trainer.train_resnet_classifier(cfg, 3, epochs=1, device="cpu")
    assert any("--freeze_bn without a warm start" in m for m in messages)
    assert tr.model.frozen_bn


@pytest.fixture(scope="module")
def jcli():
    # the package's ``cli`` exports the function ``main`` over the module
    return importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.cli.main")


@pytest.mark.parametrize("argv", [
    ["--train", "--freeze_bn", "--batch_size", "4"],
    ["--train_strategy", "--strategy", "balanced"],
    ["--evaluate", "--epochs", "2"],
])
def test_training_flags_parse_alike(jcli, argv):
    a = jcli.build_parser().parse_args(argv)
    b = cli.build_parser().parse_args(argv)
    for key in ("train", "train_strategy", "strategy", "evaluate", "freeze_bn",
                "epochs", "run_evaluation"):
        assert getattr(a, key) == getattr(b, key), key
    jcfg, cfg = jcli._config_from_args(a), cli._config_from_args(b)
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(jcfg.train)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--strategy", "nope"])


@pytest.mark.parametrize("action", ["--train", "--train_strategy"])
def test_training_gates_exit_1_in_both(jcli, tmp_path, action):
    argv = [action, "--data_dir", str(tmp_path / "data"), "--models_dir",
            str(tmp_path / "models")]
    assert jcli.main(argv) == 1  # no slide downloaded
    assert cli.main(argv + ["--device", "cpu"]) == 1
    os.makedirs(tmp_path / "data" / "train" / "img")
    open(tmp_path / "data" / "train" / "img" / "a.tif", "w").close()
    assert jcli.main(argv) == 1  # no patches extracted
    assert cli.main(argv + ["--device", "cpu"]) == 1
    assert not os.path.exists(tmp_path / "models")


def test_cli_trains_evaluates_and_predicts_in_order(tmp_path):
    """``--train --train_strategy --evaluate`` in one call, in the JAX
    order: the default trainer, the strategy, then the evaluation of the
    default trainer's classifier."""
    _store(tmp_path / "data")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"log_dir": str(tmp_path / "logs"),
                                    "model": {"pretrained": False}}))
    models = tmp_path / "models"
    with _Records("hipac.evaluation.classifier") as messages:
        rc = cli.main(["--evaluate", "--train_strategy", "--train",
                       "--strategy", "weighted_loss", "--epochs", "1",
                       "--config", str(cfg_path), "--data_dir",
                       str(tmp_path / "data"), "--models_dir", str(models),
                       "--batch_size", "4", "--device", "cpu"])
    assert rc == 0
    first = os.path.getmtime(models / "resnet18_patch_classifier.pt")
    second = os.path.getmtime(models / "resnet18_patch_classifier_weighted_loss.pt")
    assert first <= second
    assert len(messages) == 1 and messages[0].startswith("Validation accuracy")
    with open(tmp_path / "logs" / "train_history.json") as f:
        assert len(json.load(f)) == 1


def test_cli_needs_an_action():
    """No action is no error: the call does nothing and returns 0, as the JAX
    ``main`` does (``tests/test_torch_port_cli.py`` drives both)."""
    assert cli.main(["--device", "cpu"]) == 0
