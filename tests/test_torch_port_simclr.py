"""The port's SimCLR slice against the JAX package.

The same numpy inputs go through the JAX functions and their port
counterparts on the CPU, in float32 where the point is the algorithm:
configuration, packed patch store, dataset and batch iteration (exact), the
SimCLR views (given the same crop boxes and parameters), the model and its
weight conversion, one training step's loss, gradients and BatchNorm
running statistics, and Adam against optax. ``pretrain_simclr`` runs end to
end on the CPU with the kernels' plain version, and its best, checkpoint
and early-stop cadence is held to the JAX function's on scripted losses.
"""

import dataclasses
import logging
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu import config as jax_config
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    augment as jax_augment,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    datasets as jax_datasets,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    manifest as jax_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    patch_store as jax_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu.grid.labeling import (
    LABEL_NAMES as JAX_LABEL_NAMES,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.simclr import (
    SimCLRModel as JaxSimCLRModel,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.simclr import (
    nt_xent_loss as jax_nt_xent_loss,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    simclr_trainer as jax_trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    simclr_state_dict_from_flax,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    BatchNorm2d,
    ResNet18FeatureExtractor,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    SimCLRModel,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    simclr_trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)

torch.set_num_threads(2)

SIZE = 32  # views and patches: layer4 is 1×1, so its BN reduces over B values
TAU = 0.5


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# configuration and data copies (exact)
# ---------------------------------------------------------------------------


def test_simclr_config_copies_match_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(config.SimCLRConfig) == fields(jax_config.SimCLRConfig)
    assert config.INPUT_SIZE == jax_config.INPUT_SIZE
    assert config.BATCH_SIZE == jax_config.BATCH_SIZE
    assert config.Config().models_dir == jax_config.Config().models_dir
    for data_dir in ("data", "/x/y"):
        assert (config.DataConfig(data_dir=data_dir).patches_dir
                == jax_config.DataConfig(data_dir=data_dir).patches_dir)
    assert manifest.LABEL_NAMES == JAX_LABEL_NAMES


def _write_stores(writer_cls, root, seed=0):
    """Two slides' packed stores (7 patches of 16² in two appends, and 5);
    returns the records."""
    recs = []
    w = writer_cls(root, 3, "slide_a", 16)
    for part in np.split(_u8(seed, (7, 16, 16, 3)), [3]):
        coords = np.arange(2 * len(part)).reshape(-1, 2) + 16 * len(recs)
        recs += w.write_batch(part, coords, np.arange(len(part)) % 2)
    w.close()
    w = writer_cls(root, 3, "slide_b", 16)
    coords = np.arange(10).reshape(5, 2) * 16
    recs += w.write_batch(_u8(seed + 1, (5, 16, 16, 3)), coords,
                          np.array([1, 0, 0, 1, 1]))
    w.close()
    return recs


def _fields(rec):
    return dataclasses.astuple(rec)[:-2] + (os.path.basename(rec.path), rec.row)


def _tuples(records):
    return [dataclasses.astuple(r) for r in records]


def test_packed_store_and_reads_match_jax(tmp_path):
    recs = _write_stores(patch_store.PackedPatchWriter, str(tmp_path / "port"))
    jrecs = _write_stores(jax_store.PackedPatchWriter, str(tmp_path / "jax"))
    assert [_fields(r) for r in recs] == [_fields(r) for r in jrecs]
    for slide in ("slide_a", "slide_b"):
        for ext in (".pack", ".pack.shape"):
            a = (tmp_path / "port" / "level_3" / f"{slide}{ext}").read_bytes()
            b = (tmp_path / "jax" / "level_3" / f"{slide}{ext}").read_bytes()
            assert a == b
    m = manifest.PatchManifest(recs)
    jm = jax_manifest.PatchManifest(recs)
    reader, jreader = patch_store.PatchReader(m), jax_store.PatchReader(jm)
    idx = [11, 0, 3, 7, 3, 9, 1]  # both files, repeats, any order
    np.testing.assert_array_equal(reader.read_batch(idx),
                                  jreader.read_batch(idx))
    np.testing.assert_array_equal(reader.read(8), jreader.read(8))
    np.testing.assert_array_equal(reader.read_batch(idx, s2d=True),
                                  jreader.read_batch(idx, s2d=True))
    ds = datasets.PatchDataset(m, resize_to=16)
    jds = jax_datasets.PatchDataset(jm, resize_to=16)
    for a, b in zip(ds.read_batch(idx), jds.read_batch(idx)):
        np.testing.assert_array_equal(a, b)
    assert ds.class_counts() == jds.class_counts() and len(ds) == len(jds)


@pytest.mark.parametrize("n,bs", [(12, 5), (3, 5), (12, 4), (12, 12)])
def test_batch_iterator_matches_jax_over_two_epochs(tmp_path, n, bs):
    recs = _write_stores(patch_store.PackedPatchWriter, str(tmp_path))[:n]
    ds = datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=16)
    jds = jax_datasets.PatchDataset(jax_manifest.PatchManifest(recs),
                                    resize_to=16)
    it = datasets.BatchIterator(ds, bs, seed=3)
    # the JAX trainer's settings for SimCLR, spelled out
    jit = jax_datasets.BatchIterator(jds, bs, shuffle=True, seed=3,
                                     drop_remainder=False)
    assert len(it) == len(jit)
    for _ in range(2):
        got, want = list(it), list(jit)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_manifest_persistence_matches_jax(tmp_path):
    recs = _write_stores(patch_store.PackedPatchWriter, str(tmp_path / "p"))
    root = str(tmp_path / "patches")
    path = jax_manifest.manifest_path(root, 3)
    assert manifest.manifest_path(root, 3) == path
    jax_manifest.PatchManifest(recs).save(path)
    loaded = manifest.load_or_scan_manifest(root, 3)
    assert list(loaded) == recs
    # a reference-layout PNG tree without a manifest is scanned
    png_dir = tmp_path / "png" / "level_2" / "s1"
    png_dir.mkdir(parents=True)
    for rec in recs[:4]:
        (png_dir / rec.patch_name).touch()
    (png_dir / "notes.png").touch()
    scanned = manifest.load_or_scan_manifest(str(tmp_path / "png"), 2)
    assert len(scanned) == 4
    assert _tuples(scanned) == _tuples(jax_manifest.load_or_scan_manifest(
        str(tmp_path / "png"), 2))
    assert [r.patch_name for r in recs] == [
        jax_manifest.PatchRecord(*dataclasses.astuple(r)).patch_name
        for r in recs]


# ---------------------------------------------------------------------------
# SimCLR views
# ---------------------------------------------------------------------------


def _view_params(seed, b, force):
    rng = np.random.default_rng(seed)
    flags = {k: rng.random(b) < p for k, p in (("h", 0.5), ("jp", 0.8),
                                                ("gp", 0.2))}
    for k in ("h", "jp", "gp"):
        if force in (k, "all"):
            flags[k][:] = True
        elif force != "mixed":
            flags[k][:] = False
    factors = {k: rng.uniform(0.6, 1.4, b).astype(np.float32)
               for k in ("fb", "fc", "fs")}
    factors["fh"] = rng.uniform(-0.1, 0.1, b).astype(np.float32)
    return {**flags, **factors}


# bf16 views: the two frameworks round the crop products, the jitter affine
# and the final store at the same places. Measured: bit-equal on this CPU
# (6 flag settings × 3 seeds); the bound allows one bf16 step of the
# normalized values (which reach ~2.6) on under 1 % of the elements, for a
# matrix product that sums in another order
VIEW_ATOL = 2.0**-6


@pytest.mark.parametrize("force", ["none", "h", "jp", "gp", "all", "mixed"])
def test_simclr_view_batch_matches_jax(force):
    b, H, W = 6, 40, 36
    imgs = _u8(7, (b, H, W, 3))
    keys = jax.random.split(jax.random.key(11), b)
    boxes = jax.vmap(lambda r: jax_augment._sample_crop_box(r, H, W))(keys)
    params = _view_params(5, b, force)
    ref = jax_augment.simclr_view_batch(
        keys, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(imgs), SIZE)
    got = augment.simclr_view_batch(
        tuple(torch.from_numpy(np.array(x)) for x in boxes),
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(imgs), SIZE)
    assert got.dtype == torch.bfloat16 and got.shape == (b, SIZE, SIZE, 3)
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - ref)
    assert diff.max() <= VIEW_ATOL
    assert (diff > 0).mean() < 0.01  # almost every element equal


def test_sample_simclr_view_params_distributions():
    g = torch.Generator().manual_seed(0)
    n = 20000
    p = augment.sample_simclr_view_params(g, n)
    jp = jax_augment.sample_simclr_view_params(jax.random.key(0), n)
    assert p.keys() == jp.keys()
    for k in p:
        assert p[k].shape == (n,)
        assert (p[k].dtype == torch.bool) == (jp[k].dtype == jnp.bool_)
        # independent generators: the same distribution, not the same bits;
        # 5 standard errors of a mean
        a, b = p[k].float().numpy(), np.asarray(jp[k], np.float32)
        assert abs(a.mean() - b.mean()) < 5 * np.sqrt(2 * b.var() / n)
    for k, lo, hi in (("fb", 0.6, 1.4), ("fc", 0.6, 1.4), ("fs", 0.6, 1.4),
                      ("fh", -0.1, 0.1)):
        assert lo <= p[k].min() and p[k].max() <= hi
    # a draw is the generator's: same seed, same params
    again = augment.sample_simclr_view_params(torch.Generator().manual_seed(0), n)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_sample_crop_boxes_match_jax_distribution():
    n, H, W = 20000, 224, 160
    y0, x0, h, w = augment.sample_crop_boxes(torch.Generator().manual_seed(1),
                                             n, H, W)
    keys = jax.random.split(jax.random.key(1), n)
    jy0, jx0, jh, jw = (np.asarray(a) for a in jax.vmap(
        lambda r: jax_augment._sample_crop_box(r, H, W))(keys))
    for a in (y0, x0, h, w):
        assert a.dtype == torch.float32 and a.shape == (n,)
    assert (h >= 1).all() and (w >= 1).all()
    assert (y0 >= 0).all() and (y0 + h <= H + 1e-3).all()
    assert (x0 >= 0).all() and (x0 + w <= W + 1e-3).all()
    for a, b in ((h * w / (H * W), jh * jw / (H * W)), (h / w, jh / jw),
                 (y0 / H, jy0 / H), (x0 / W, jx0 / W)):
        a = a.numpy()
        assert abs(a.mean() - b.mean()) < 5 * np.sqrt((a.var() + b.var()) / n)


def test_simclr_two_views_draws_from_the_generator():
    imgs = torch.from_numpy(_u8(2, (3, 40, 40, 3)))
    a = augment.simclr_two_views(torch.Generator().manual_seed(4), imgs, SIZE)
    b = augment.simclr_two_views(torch.Generator().manual_seed(4), imgs, SIZE)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])  # two independent views
    assert a[0].dtype == torch.bfloat16 and a[0].shape == (3, SIZE, SIZE, 3)


# ---------------------------------------------------------------------------
# model, conversion, one training step, Adam
# ---------------------------------------------------------------------------


def _randomized(variables, seed):
    """BN scale/bias (params) and mean/var (batch_stats) drawn from numpy,
    so that every converted tensor and every running statistic moves the
    result; other leaves as numpy."""
    rng = np.random.default_rng(seed)
    draw = {
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "mean": lambda s: rng.normal(0.0, 0.5, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
    }

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


@pytest.fixture(scope="module")
def jax_simclr():
    """The JAX SimCLR model in float32 with randomized BN, two views of 4
    images at 32² and a valid mask with one False row, and the JAX loss
    function's value, gradients and updated batch statistics."""
    model = JaxSimCLRModel(dtype=jnp.float32)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)),
                                        train=False))
    variables = _randomized(init(jax.random.key(0)), seed=1)
    rng = np.random.default_rng(2)
    v1, v2 = (rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(2))
    valid = np.array([True, True, False, True])

    def loss_fn(params, batch_stats):
        # as the JAX trainer's step: the second forward starts from the
        # statistics the first updated
        z1, upd = model.apply({"params": params, "batch_stats": batch_stats},
                              v1, train=True, mutable=["batch_stats"])
        z2, upd = model.apply({"params": params,
                               "batch_stats": upd["batch_stats"]},
                              v2, train=True, mutable=["batch_stats"])
        return jax_nt_xent_loss(z1, z2, TAU, valid=jnp.asarray(valid)), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    x = rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    z_eval, h_eval = jax.jit(lambda v, x: (
        model.apply(v, x, train=False),
        model.apply(v, x, train=False, method=JaxSimCLRModel.encode)))(
            variables, x)
    return types.SimpleNamespace(
        variables=variables, v1=v1, v2=v2, valid=valid, loss=float(loss),
        after=jax.device_get({"params": grads,
                              "batch_stats": upd["batch_stats"]}),
        x=x, z_eval=np.asarray(z_eval), h_eval=np.asarray(h_eval))


def _port_model(variables):
    model = SimCLRModel()
    model.load_state_dict(simclr_state_dict_from_flax(variables), strict=True)
    return model


def test_simclr_model_conversion_matches_jax(jax_simclr):
    model = _port_model(jax_simclr.variables).eval()
    x = torch.from_numpy(jax_simclr.x)
    with torch.no_grad():
        z, h = model(x), model.encode(x)
    assert z.dtype == torch.float32 and z.shape == (4, 128)
    assert h.shape == (4, 512)
    # float32 on the CPU both sides, random BN statistics; ResNet18 sums in
    # other orders
    np.testing.assert_allclose(z.numpy(), jax_simclr.z_eval, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), jax_simclr.h_eval, atol=1e-4)


def test_export_script_writes_a_simclr_artifact(jax_simclr, tmp_path):
    import importlib.util

    from ss25_hierarchical_multiscale_image_classification_tpu.train.checkpoints import (
        save_model as jax_save_model,
    )

    src = str(tmp_path / "simclr_encoder")
    jax_save_model(src, jax_simclr.variables)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint_to_torch",
        os.path.join(repo, "scripts", "export_jax_checkpoint_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main([src]) == 0
    loaded = load_model(src)  # <artifact>.pt, as the port's save_model names it
    expect = simclr_state_dict_from_flax(jax_simclr.variables)
    assert loaded.keys() == expect.keys()
    assert all(torch.equal(loaded[k], expect[k]) for k in expect)
    SimCLRModel().load_state_dict(loaded, strict=True)


# One float32 training step through ResNet18 at 32² with random BN: layer4's
# BN normalizes over 4 values, which amplifies rounding. Measured against
# a float64 run of the port: JAX's float32 gradients are off by up to
# 9.4e-5 of a tensor's max|g| and the port's by up to 2.0e-4, so the two
# frameworks differ by up to 2.5e-4 of max|g| (conv1 of layer4's second
# block); running statistics by ≤ 1e-6 of a tensor's max|value|. The
# variance trap (unbiased against biased at a batch of 4) would move
# layer4's running variances by a third.
GRAD_RTOL = 1e-3  # of the tensor's max|g|
STATS_RTOL = 1e-5  # of the tensor's max|value|


@pytest.mark.parametrize("loss_impl", ["xla", "pallas"])
def test_simclr_step_matches_jax(jax_simclr, loss_impl):
    model = _port_model(jax_simclr.variables).train()
    loss = simclr_trainer.simclr_loss(
        model, torch.from_numpy(jax_simclr.v1), torch.from_numpy(jax_simclr.v2),
        TAU, torch.from_numpy(jax_simclr.valid), loss_impl)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_simclr.loss, rtol=1e-5)

    expect = simclr_state_dict_from_flax(jax_simclr.after)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert params.keys() | {k for k in buffers if "running" in k} == expect.keys()
    for k, g in params.items():
        want = expect[k].numpy()
        got = g.grad.numpy()
        scale = np.abs(want).max()
        assert scale > 0, k
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, k
    for k, b in buffers.items():
        if "running" in k:  # flax's momentum and biased variance, twice
            want = expect[k].numpy()
            assert (np.abs(b.numpy() - want).max()
                    <= STATS_RTOL * np.abs(want).max()), k


@pytest.mark.parametrize("spatial", [1, 3])
def test_batchnorm_training_update_is_flax(spatial):
    """A batch of 4: PyTorch's own running variance would be 4/3 of flax's
    at 1×1; normalisation itself uses the biased variance in both."""
    import flax.linen as fnn

    c = 5
    x = np.random.default_rng(spatial).normal(
        1.0, 2.0, size=(4, spatial, spatial, c)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.key(0), x)
    stats = {"mean": np.full(c, 0.3, np.float32), "var": np.full(c, 1.7, np.float32)}
    y_ref, upd = bn.apply({"params": variables["params"], "batch_stats": stats},
                          x, mutable=["batch_stats"])
    port = BatchNorm2d(c, eps=1e-5)
    with torch.no_grad():
        port.running_mean.fill_(0.3)
        port.running_var.fill_(1.7)
    port.train()
    y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5)
    port.eval()  # eval mode reads the running statistics
    ye = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    ye_ref = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, x)
    np.testing.assert_allclose(ye.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ye_ref), rtol=1e-5, atol=1e-5)


def test_adam_matches_optax():
    """Two Adam updates at lr 1e-3 from the port's train state against optax
    ``adam(1e-3)``. Gradients are kept away from 0: the first update is
    about lr·sign(g), which a gradient near 0 would flip between the
    frameworks."""
    rng = np.random.default_rng(0)
    module = torch.nn.Linear(6, 3)
    p0 = {"weight": rng.normal(size=(3, 6)).astype(np.float32),
          "bias": rng.normal(size=3).astype(np.float32)}
    with torch.no_grad():
        for k, v in p0.items():
            getattr(module, k).copy_(torch.from_numpy(v))
    state = create_train_state(module, 1e-3, torch.device("cpu"))
    tx = optax.adam(1e-3)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jparams)
    for _ in range(2):
        grads = {k: (np.sign(rng.normal(size=v.shape))
                     * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                 for k, v in p0.items()}
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in grads.items():
            getattr(module, k).grad = torch.from_numpy(g)
        state.optimizer.step()
    for k in p0:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                   np.asarray(jparams[k]), rtol=0, atol=1e-6)
    assert module.training  # the train state puts the model in training mode


# ---------------------------------------------------------------------------
# pretrain_simclr
# ---------------------------------------------------------------------------


class _Records(logging.Handler):
    """Messages of the ``hipac.train.simclr`` logger (the ``hipac`` tree
    does not propagate to pytest's handler)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("hipac.train.simclr").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("hipac.train.simclr").removeHandler(self)


def _packed_dataset(root, n, size=SIZE):
    w = patch_store.PackedPatchWriter(root, 3, "s1", size)
    recs = w.write_batch(_u8(9, (n, size, size, 3)), np.zeros((n, 2), int),
                         np.zeros(n, int))
    w.close()
    return datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=size)


def test_pretrain_simclr_end_to_end_on_cpu(tmp_path):
    """20 packed 32² patches at batch 8: three steps an epoch, the last with
    4 real rows of 8; the kernel loss on the CPU takes the plain version."""
    ds = _packed_dataset(str(tmp_path / "patches"), 20)
    models_dir = str(tmp_path / "models")
    cfg = config.Config(simclr=config.SimCLRConfig(batch_size=8,
                                                   loss_impl="pallas"),
                        models_dir=models_dir)
    with _Records() as rec:
        sd = simclr_trainer.pretrain_simclr(cfg, epochs=2, dataset=ds,
                                            input_size=SIZE, device="cpu")
    losses = [float(m) for m in re.findall(r"loss (\S+) \(", " ".join(rec.messages))]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert 0 < losses[0] < np.log(2 * 8 - 1) + 1
    assert sorted(os.listdir(models_dir)) == ["simclr_encoder.pt",
                                              "simclr_encoder_best.pt"]
    saved = load_model(os.path.join(models_dir, "simclr_encoder"))
    assert saved.keys() == sd.keys()
    assert all(torch.equal(saved[k], sd[k]) for k in sd)
    enc = ResNet18FeatureExtractor()
    enc.load_state_dict({k.removeprefix("encoder."): v for k, v in saved.items()
                         if k.startswith("encoder.")}, strict=True)
    model = SimCLRModel()
    model.load_state_dict(sd)
    x = torch.randn(2, SIZE, SIZE, 3)
    with torch.no_grad():
        assert torch.equal(enc.eval()(x), model.eval().encode(x))
    # training moved the weights and the running statistics
    fresh = SimCLRModel().state_dict()
    assert not torch.equal(fresh["projector.2.weight"], sd["projector.2.weight"])
    assert not torch.equal(fresh["encoder.bn1.running_var"],
                           sd["encoder.bn1.running_var"])


def test_pretrain_simclr_cadence_matches_jax(tmp_path, monkeypatch):
    """Scripted epoch losses through both trainers (their steps replaced):
    the same ``_best``, ``_epoch{N}`` and final artifacts in the same
    order, the same early stop, the same log lines."""
    epoch_losses = [5.0, 4.0, 4.5, 3.9, 4.0, 4.1, 4.2, 4.3, 4.4, 4.5, 4.6, 4.7]
    steps_per_epoch = 2
    sc = dict(batch_size=8, checkpoint_every_epochs=3, early_stop_check_every=2,
              early_stop_patience=3)
    ds = _packed_dataset(str(tmp_path / "patches"), 16)
    jds = jax_datasets.PatchDataset(ds.manifest, resize_to=SIZE)
    models_dir = str(tmp_path / "models")

    def scripted(to_loss):
        calls = []

        def make_step(*_args, **_kw):
            def step(state, _rng, imgs, valid):
                assert imgs.shape == (8, SIZE, SIZE, 3)
                loss = epoch_losses[len(calls) // steps_per_epoch]
                calls.append(loss)
                return state, to_loss(loss)
            return step
        return make_step

    def recorder(saved):
        return lambda path, _variables: saved.append(os.path.basename(path))

    runs = {}
    for name in ("jax", "port"):
        saved = []
        with _Records() as rec:
            if name == "jax":
                monkeypatch.setattr(jax_trainer, "make_simclr_train_step",
                                    scripted(jnp.float32))
                monkeypatch.setattr(jax_trainer, "save_model", recorder(saved))
                monkeypatch.setattr(jax_trainer, "create_train_state",
                                    lambda *a, **k: types.SimpleNamespace(
                                        params={}, batch_stats={}))
                monkeypatch.setattr(jax_trainer, "replicate", lambda mesh, x: x)
                jax_trainer.pretrain_simclr(
                    jax_config.Config(simclr=jax_config.SimCLRConfig(**sc),
                                      models_dir=models_dir),
                    epochs=len(epoch_losses), dataset=jds, input_size=SIZE)
            else:
                monkeypatch.setattr(simclr_trainer, "make_simclr_train_step",
                                    scripted(torch.tensor))
                monkeypatch.setattr(simclr_trainer, "save_model", recorder(saved))
                simclr_trainer.pretrain_simclr(
                    config.Config(simclr=config.SimCLRConfig(**sc),
                                  models_dir=models_dir),
                    epochs=len(epoch_losses), dataset=ds, input_size=SIZE,
                    device="cpu")
        runs[name] = (saved, [re.sub(r" \(\d+\.\ds\)$", "", m)
                              for m in rec.messages])
    assert runs["port"] == runs["jax"]
    saved, messages = runs["port"]
    assert saved == ["simclr_encoder_best", "simclr_encoder_best",
                     "simclr_encoder_epoch3", "simclr_encoder_best",
                     "simclr_encoder_epoch6", "simclr_encoder"]
    assert "SimCLR early stop at epoch 8 (best 3.9000)" in messages


def test_pretrain_simclr_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds = _packed_dataset(str(tmp_path), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        simclr_trainer.pretrain_simclr(config.Config(), epochs=1, dataset=ds,
                                       device="cuda")
