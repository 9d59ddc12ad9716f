"""The data-parallel paths of multiscale training, QAT, the streamed trainer
and feature extraction, against one process and against JAX.

Each path runs in 2 and 4 spawned gloo processes (``torch_port_workers.py``)
on a global batch of 8 whose last two rows are wrap padding, so at world 4
the last rank holds padding only. Each is held to:

- the same path in one process on the whole batch (the same generators: the
  augmentation is drawn for the global batch on every rank): the losses and
  the running statistics at 1e-5 of a tensor's largest magnitude, the
  gradients at 1e-4 (``tests/test_torch_port_dp.py``'s bounds: layer4's BN
  normalizes over few values, which amplifies the other summation order of
  the global statistics), weights after Adam within its bound, int8
  features bit for bit (integer accumulation) and float32 features at 1e-5;
- itself on every other rank: parameters, BN statistics, Adam's state, the
  lazily calibrated int8 tree (rank 0's) and the features, bit for bit;
- JAX on the conftest's CPU devices, where JAX can be given the same inputs:
  the multiscale step's loss function on the global batch sharded over a
  4-device mesh with the port's augmentation draws (the single-process step
  test's bounds, ``tests/test_torch_port_ms_train.py``: 5e-2 of max|g| for
  the early layers, where the frameworks' float32 gradients differ), QAT's
  fine-tune over JAX's mesh (the same batch order and calibration batches:
  losses at 1e-3, activation scales at 1e-5) and the feature extraction
  over a 4-device mesh (int8 at ``tests/test_torch_port_int8_paths.py``'s
  1e-2, float32 at 1e-4). The streamed trainer's draws come from JAX keys
  in JAX, which a ``torch.Generator`` cannot reproduce
  (``tests/test_torch_port_streaming.py``); it is held to one process.

The CLI runs ``--extract_features`` (float and ``--int8``) and ``--qat`` as
two ranks, rank 0 writing what one process writes.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    augment as jaugment,
    datasets as jdatasets,
    manifest as jmanifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu.config import (
    Config as JConfig,
    DataConfig as JDataConfig,
    TrainConfig as JTrainConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu.infer import (
    features as jfeatures,
)
from ss25_hierarchical_multiscale_image_classification_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    losses as jlosses,
    multiscale_trainer as jmt,
    qat as jqat,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    synthetic as jsynthetic,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
    manifest,
    multiscale,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
    quantized as pq,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    hierarchical_state_dict_from_flax,
    state_dict_from_flax,
    strip_head,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
    save_model,
)

import torch_port_workers as workers
from test_torch_port_features import _write_store
from test_torch_port_int8 import _randomized_variables, _u8
from test_torch_port_multiscale_data import randomized_hierarchical
from test_torch_port_ms_train import EARLY, JAX_EARLY_RTOL, _ms_store

torch.set_num_threads(2)

SIZE, BATCH = workers.SIZE, workers.BATCH
CW = np.array([1.0, 2.5], np.float32)
LOSS_RTOL = 1e-5
STATS_RTOL = 1e-5  # of the tensor's max|value|
GRAD_RTOL = 1e-4  # of the tensor's max|g|, against world 1
JAX_GRAD_RTOL = 1e-3  # of the tensor's max|g|, against JAX
JAX_LOSS_RTOL = 1e-4
QAT_JAX_LOSS_RTOL = 1e-3
INT8_JAX_RTOL = 1e-2  # of the largest feature
FLOAT_RTOL = 1e-5  # features against world 1, of the largest
FLOAT_JAX_RTOL = 1e-4
# Adam's update is about lr whatever the gradient's size: another summation
# order may turn it around where a gradient sits near 0 (see
# tests/test_torch_port_dp.py)
ADAM_STEP_SHARE = 2.0
AFTER_STEPS_STATS_RTOL = 2e-3
# the streamed run's statistics after its two epochs of steps (measured
# 3.5e-3 of a running mean's max|value|)
STREAM_STATS_RTOL = 1e-2
# a loss after Adam steps: its weights are within the Adam bound (measured
# 6.9e-5 of the multiscale loss after one step at lr 1e-3, world 4)
AFTER_ADAM_LOSS_RTOL = 1e-4
# an epoch's summed loss, its steps after Adam steps at lr 1e-3 (measured
# 9.2e-5 on the streamed epoch, world 2 and 4)
EPOCH_LOSS_RTOL = 1e-3


def close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def after_adam(got, want, steps, lr):
    diff = (torch.as_tensor(got).double()
            - torch.as_tensor(want).double()).abs().max().item()
    assert diff <= ADAM_STEP_SHARE * lr * steps, diff


def _mesh_put(x, shards=4):
    m = JaxMesh(np.array(jax.devices()[:shards]), ("data",))
    return jax.device_put(jnp.asarray(x), NamedSharding(m, P("data")))


def _identical(tensors):
    """Every rank's tensor (or array) of each name equals rank 0's."""
    first = tensors[0]
    for other in tensors[1:]:
        assert other.keys() == first.keys()
        for k, v in first.items():
            np.testing.assert_array_equal(np.asarray(other[k]), np.asarray(v),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# multiscale training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ms_variables():
    return randomized_hierarchical(jax, "concat", True, seed=41, size=SIZE)


@pytest.fixture(scope="module")
def ms_world1(ms_variables, tmp_path_factory):
    _, variables = ms_variables
    sd = hierarchical_state_dict_from_flax(variables)
    root = tmp_path_factory.mktemp("ms1")
    data = _ms_store(root / "data")
    cfg = _ms_cfg(root, data)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
        train_multiscale_classifier,
    )

    out = train_multiscale_classifier(
        cfg, dataset=multiscale.MultiscaleDataset.from_patches_dir(
            cfg.data.patches_dir, **MS_DS), epochs=2, device="cpu")
    return sd, workers.ms_step(sd, CW), out


MS_DS = {"levels": (2, 3), "resize_to": SIZE, "input_mode": "resize"}


def _ms_cfg(root, data):
    return config.Config(data=data, models_dir=str(root / "models"),
                         log_dir=str(root / "logs"),
                         train=config.TrainConfig(batch_size=BATCH))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ms_runs(request, ms_world1, tmp_path_factory):
    sd = ms_world1[0]
    w = request.param
    root = tmp_path_factory.mktemp(f"ms{w}")
    cfg = _ms_cfg(root, _ms_store(root / "data"))
    res = workers.run_world(workers.ms_worker, w, str(root / "ranks"), sd, CW,
                            cfg, MS_DS)
    return w, res, cfg


def test_dp_multiscale_step_equals_world1(ms_runs, ms_world1):
    w, res, _ = ms_runs
    want = ms_world1[1]
    for out in (r["step"] for r in res):
        # the second step's loss follows weights within the Adam bound
        for got_m, want_m, rtol in zip(out["metrics"], want["metrics"],
                                       (LOSS_RTOL, AFTER_ADAM_LOSS_RTOL)):
            close(got_m["loss"], want_m["loss"], rtol)
        for k, g in want["grads"].items():
            close(out["grads"][k], g, GRAD_RTOL)
        for k, v in want["stats"].items():
            close(out["stats"][k], v, STATS_RTOL)
        for k, v in want["sd"].items():
            if v.is_floating_point():
                after_adam(out["sd"][k], v, len(want["metrics"]),
                           workers.MS_LR)
    for step in range(2):
        for key in ("correct", "count"):
            assert sum(r["step"]["metrics"][step][key] for r in res) == \
                want["metrics"][step][key]
    assert [r["step"]["metrics"][0]["count"] for r in res] == (
        [4.0, 2.0] if w == 2 else [2.0, 2.0, 2.0, 0.0])


def test_dp_multiscale_ranks_stay_bit_identical(ms_runs):
    _, res, _ = ms_runs
    _identical([r["step"]["sd"] for r in res])
    _identical([r["step"]["grads"] for r in res])
    _identical([dict(enumerate(r["step"]["adam"])) for r in res])
    _identical([r["fit"]["variables"] for r in res])
    assert all(r["fit"]["calibration"] == res[0]["fit"]["calibration"]
               for r in res)


def test_dp_multiscale_fit_equals_world1_and_rank0_writes(ms_runs, ms_world1):
    _, res, cfg = ms_runs
    want = ms_world1[2]
    got = res[0]["fit"]
    for g, h in zip(got["history"], want["history"]):
        close(g["loss"], h["loss"], LOSS_RTOL)
        assert g["acc"] == h["acc"]
    assert got["calibration"].keys() == want["calibration"].keys()
    for k, v in want["calibration"].items():
        if isinstance(v, str):
            assert got["calibration"][k] == v
    saved = load_model(os.path.join(cfg.models_dir, "hierarchical_classifier"))
    assert saved.keys() == got["variables"].keys()
    for k, v in got["variables"].items():
        assert torch.equal(saved[k], v), k
    for k, v in want["variables"].items():
        if "running" in k:
            close(got["variables"][k], v, AFTER_STEPS_STATS_RTOL)
        elif v.is_floating_point() and "calibration" not in k:
            after_adam(got["variables"][k], v, 4, cfg.train.learning_rate)


@pytest.fixture(scope="module")
def jax_ms_step(ms_variables):
    """JAX's multiscale loss function on the global batch sharded over 4
    devices, given the port's first augmentation draw."""
    model, variables = ms_variables
    d = workers.ms_inputs()
    p = augment.sample_augment_params(torch.Generator().manual_seed(13), BATCH)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    batch = {lvl: _mesh_put(jaugment.augment_batch(jp, jnp.asarray(x)))
             for lvl, x in d["imgs"].items()}
    labels = _mesh_put(d["labels"].astype(np.int32))
    valid = _mesh_put(d["valid"])

    def loss_fn(params):
        (logits, aux), upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, with_aux=True, mutable=["batch_stats"])
        loss = jlosses.weighted_cross_entropy(logits, labels, jnp.asarray(CW),
                                              valid)
        loss = loss + 0.5 * jmt.deep_supervision_loss(
            aux, labels, jnp.asarray(CW), valid)
        return loss, upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    conv = hierarchical_state_dict_from_flax
    return (float(loss),
            conv({"params": jax.device_get(grads),
                  "batch_stats": variables["batch_stats"]}),
            conv({"params": variables["params"],
                  "batch_stats": jax.device_get(upd["batch_stats"])}))


def test_dp_multiscale_step_equals_jax_on_a_4_device_mesh(ms_runs,
                                                         jax_ms_step):
    _, res, _ = ms_runs
    loss, grads, stats = jax_ms_step
    for out in (r["step"] for r in res):
        close(out["metrics"][0]["loss"], loss, JAX_LOSS_RTOL)
        for k, g in out["grads"].items():
            close(g, grads[k], JAX_EARLY_RTOL if k.startswith(EARLY)
                  else JAX_GRAD_RTOL)
        for k, v in out["stats"].items():
            close(v, stats[k], STATS_RTOL)


def test_dp_multiscale_draws_are_the_global_batchs():
    """``preprocess_multiscale_batch(rows=)``: each rank's rows of the one
    global draw, at every level."""
    d = workers.ms_inputs()
    imgs = {lvl: torch.from_numpy(x) for lvl, x in d["imgs"].items()}
    whole = augment.preprocess_multiscale_batch(
        torch.Generator().manual_seed(5), imgs)
    for world in (2, 4):
        b = BATCH // world
        parts = [augment.preprocess_multiscale_batch(
            torch.Generator().manual_seed(5),
            {lvl: x[r * b:(r + 1) * b] for lvl, x in imgs.items()},
            rows=(r * b, BATCH)) for r in range(world)]
        for lvl in imgs:
            assert torch.equal(torch.cat([p[lvl] for p in parts]), whole[lvl])


def test_multiscale_batches_take_the_ranks_rows(tmp_path):
    data = _ms_store(tmp_path / "data")
    ds = multiscale.MultiscaleDataset.from_patches_dir(data.patches_dir,
                                                       **MS_DS)
    whole = list(ds.batches(BATCH, seed=3))
    for world in (2, 4):
        b = BATCH // world
        ranks = [list(ds.batches(BATCH, seed=3, rows=slice(r * b, (r + 1) * b)))
                 for r in range(world)]
        for k, (imgs, labels, valid) in enumerate(whole):
            for lvl in imgs:
                np.testing.assert_array_equal(
                    np.concatenate([r[k][0][lvl] for r in ranks]), imgs[lvl])
            np.testing.assert_array_equal(
                np.concatenate([r[k][1] for r in ranks]), labels)
            np.testing.assert_array_equal(
                np.concatenate([r[k][2] for r in ranks]), valid)


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

def _qat_store(root):
    """14 seeded 32² patches over two slides (the second global batch holds
    6 real rows), with a manifest both packages read."""
    data = config.DataConfig(data_dir=str(root / "data"))
    recs = _write_store(data.patches_dir, edge=SIZE, n=14, seed=2)
    jmanifest.PatchManifest(recs).save(
        manifest.manifest_path(data.patches_dir, 3))
    return data


@pytest.fixture(scope="module")
def qat_variables():
    return _randomized_variables(jax, 7, num_filters=8, fc=True)


def _qat_cfg(root):
    return config.Config(data=_qat_store(root),
                         models_dir=str(root / "models"),
                         train=config.TrainConfig(batch_size=BATCH))


@pytest.fixture(scope="module")
def qat_world1(qat_variables, tmp_path_factory):
    root = tmp_path_factory.mktemp("qat1")
    return workers.qat_run(_qat_cfg(root), state_dict_from_flax(qat_variables))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def qat_runs(request, qat_variables, tmp_path_factory):
    w = request.param
    root = tmp_path_factory.mktemp(f"qat{w}")
    cfg = _qat_cfg(root)
    res = workers.run_world(workers.qat_worker, w, str(root / "ranks"), cfg,
                            state_dict_from_flax(qat_variables))
    return w, res, cfg


def _flat_tree(tree):
    out = {}
    for field, node in tree.items():
        if isinstance(node, dict):
            out.update({f"{field}/{k}": v for k, v in node.items()})
        elif isinstance(node, tuple):
            out.update({f"{field}/{i}": v for i, v in enumerate(node)})
        elif node is not None:
            out[field] = node
    return out


def test_dp_qat_equals_world1(qat_runs, qat_world1):
    _, res, _ = qat_runs
    want = qat_world1
    for out in res:
        for g, h in zip(out["history"], want["history"]):
            close(g["loss"], h["loss"], LOSS_RTOL)
            assert g["acc"] == h["acc"]
        for k, v in want["ascales"].items():
            assert torch.equal(out["ascales"][k], v), k
        for name, (kernel, bias) in want["folded"].items():
            after_adam(out["folded"][name][0], kernel, 4, 1e-3)
            after_adam(out["folded"][name][1], bias, 4, 1e-3)


def test_dp_qat_ranks_stay_bit_identical_and_rank0_writes(qat_runs):
    _, res, cfg = qat_runs
    _identical([{n: kb[0] for n, kb in r["folded"].items()} for r in res])
    _identical([{n: kb[1] for n, kb in r["folded"].items()} for r in res])
    _identical([_flat_tree(r["tree"]) for r in res])
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
        quant_artifact as qa,
    )

    path = os.path.join(cfg.models_dir, qa.CLASSIFIER_ARTIFACT)
    assert all(r["artifact_path"] == path for r in res)
    saved = _flat_tree(qa.load_quantized(path))
    mine = _flat_tree(res[0]["tree"])
    assert saved.keys() <= mine.keys()
    for k, v in saved.items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(mine[k])), k


@pytest.fixture(scope="module")
def jax_qat(qat_variables, tmp_path_factory):
    root = tmp_path_factory.mktemp("qatj")
    data = _qat_store(root)
    jcfg = JConfig(data=JDataConfig(data_dir=data.data_dir),
                   models_dir=str(root / "models"),
                   train=JTrainConfig(batch_size=BATCH))
    return jqat.qat_finetune(jcfg, variables=qat_variables, level=3, epochs=2,
                             batch_size=BATCH, learning_rate=1e-3,
                             input_size=SIZE, n_calib_batches=1, save=False)


def test_dp_qat_equals_jax_over_its_mesh(qat_runs, jax_qat):
    _, res, _ = qat_runs
    for out in res:
        for g, h in zip(out["history"], jax_qat["history"]):
            close(g["loss"], h["loss"], QAT_JAX_LOSS_RTOL)
        for k, v in jax_qat["ascales"].items():
            close(out["ascales"][k].numpy(), np.asarray(v), STATS_RTOL)


# ---------------------------------------------------------------------------
# the streamed trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream_case(tmp_path_factory):
    """JAX-written slides: tumor_001 and normal_001, 1792×1344."""
    root = str(tmp_path_factory.mktemp("dp_stream_case"))
    jsynthetic.write_synthetic_case(
        root, "tumor_001",
        jsynthetic.tumor_spec(width=1792, height=1344,
                              tissue_radii=(0.45, 0.45), seed=1))
    jsynthetic.write_synthetic_case(
        root, "normal_001",
        jsynthetic.SyntheticSlideSpec(width=1792, height=1344,
                                      tissue_radii=(0.45, 0.45), seed=2))
    return root


def _stream_cfg(case, root):
    shutil.copytree(case, str(root / "data"),
                    ignore=shutil.ignore_patterns("patches"))
    cfg = config.Config(data=config.DataConfig(data_dir=str(root / "data")),
                        models_dir=str(root / "models"))
    cfg.train.batch_size = BATCH
    cfg.model.pretrained = False
    cfg.log_dir = str(root / "logs")
    return cfg


@pytest.fixture(scope="module")
def stream_world1(stream_case, tmp_path_factory):
    cfg = _stream_cfg(stream_case, tmp_path_factory.mktemp("stream1"))
    return workers.streaming_run(cfg, 2), cfg


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def stream_runs(request, stream_case, tmp_path_factory):
    w = request.param
    root = tmp_path_factory.mktemp(f"stream{w}")
    cfg = _stream_cfg(stream_case, root)
    res = workers.run_world(workers.streaming_worker, w, str(root / "ranks"),
                            cfg, 2)
    return w, res, cfg


def test_dp_streamed_epoch_equals_world1(stream_runs, stream_world1):
    _, res, _ = stream_runs
    want, _ = stream_world1
    for out in res:
        got, ep0 = out["streamed_epoch"], want["streamed_epoch"]
        assert got["patches"] == ep0["patches"] > 0
        close(got["loss"], ep0["loss"], EPOCH_LOSS_RTOL)
        assert got["acc"] == ep0["acc"]
        for g, h in zip(out["history"], want["history"]):
            close(g["train_loss"], h["train_loss"], EPOCH_LOSS_RTOL)
        steps = ep0["patches"] // BATCH + 1 + len(want["history"]) * 4
        for k, v in want["variables"].items():
            if "running" in k:
                close(out["variables"][k], v, STREAM_STATS_RTOL)
            elif v.is_floating_point():
                after_adam(out["variables"][k], v, steps, 1e-3)


def test_dp_streamed_ranks_identical_and_rank0_wrote_the_store(
        stream_runs, stream_world1):
    _, res, cfg = stream_runs
    _identical([r["variables"] for r in res])
    _, cfg1 = stream_world1
    got = manifest.load_level_manifest(cfg.data.patches_dir, 3)
    want = manifest.load_level_manifest(cfg1.data.patches_dir, 3)
    assert [r.patch_name for r in got] == [r.patch_name for r in want]
    saved = load_model(os.path.join(cfg.models_dir,
                                    "resnet18_patch_classifier"))
    for k, v in res[0]["variables"].items():
        assert torch.equal(saved[k], v), k


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feature_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_features")
    recs = _write_store(str(root / "patches"), edge=SIZE, n=14, seed=4)
    trunk = _randomized_variables(jax, 64, fc=False)
    sd = strip_head(state_dict_from_flax(trunk))
    qtree = pq.quantize_resnet18(sd, [_u8(65, (8, SIZE, SIZE, 3))],
                                 device="cpu").tree()
    one = {"float": workers.features_run(recs, sd, False),
           "float_s2d": workers.features_run(recs, sd, False, stem_s2d=True),
           "int8": workers.features_run(recs, sd, True),
           "int8_tree": workers.features_run(recs, sd, True, qtree)}
    return recs, trunk, sd, qtree, one


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def feature_runs(request, feature_case, tmp_path_factory):
    recs, _, sd, qtree, _ = feature_case
    w = request.param
    res = workers.run_world(workers.features_worker, w,
                            str(tmp_path_factory.mktemp(f"feat{w}")), recs, sd,
                            qtree)
    return w, res


@pytest.mark.parametrize("route", ["int8", "int8_tree"])
def test_dp_int8_features_equal_world1_bit_for_bit(feature_runs, feature_case,
                                                   route):
    _, res = feature_runs
    want = feature_case[4][route]
    for out in res:
        assert out[route]["feats"].shape == (14, 64)
        np.testing.assert_array_equal(out[route]["feats"], want["feats"])
        np.testing.assert_array_equal(out[route]["labels"], want["labels"])
        assert out[route]["names"] == want["names"]


@pytest.mark.parametrize("route", ["float", "float_s2d"])
def test_dp_float_features_equal_world1(feature_runs, feature_case, route):
    _, res = feature_runs
    want = feature_case[4][route]["feats"]
    for out in res:
        close(out[route]["feats"], want, FLOAT_RTOL)


def test_dp_features_and_trees_identical_on_every_rank(feature_runs):
    _, res = feature_runs
    for route in ("float", "float_s2d", "int8", "int8_tree"):
        _identical([{"f": r[route]["feats"]} for r in res])
    _identical([_flat_tree(r["tree"]) for r in res])


@pytest.fixture(scope="module")
def jax_features(feature_case):
    recs, trunk, _, _, _ = feature_case
    jds = jdatasets.PatchDataset(jmanifest.PatchManifest(recs), resize_to=SIZE)
    mesh = jmake_mesh(4)
    out = {}
    for name, kw in (("int8", {"int8": True}),
                     ("float", {"dtype": jnp.float32})):
        out[name] = jfeatures.run_feature_extraction(
            jds, trunk, batch_size=BATCH, mesh=mesh, feature_dim=64, **kw)[0]
    return out


def test_dp_features_equal_jax_on_a_4_device_mesh(feature_runs, jax_features):
    _, res = feature_runs
    for out in res:
        close(out["int8"]["feats"], jax_features["int8"], INT8_JAX_RTOL)
        close(out["float"]["feats"], jax_features["float"], FLOAT_JAX_RTOL)


# ---------------------------------------------------------------------------
# the CLI under torchrun
# ---------------------------------------------------------------------------

def _feature_root(tmp_path):
    data = config.DataConfig(data_dir=str(tmp_path / "data"))
    recs = _write_store(data.patches_dir, edge=SIZE, n=14, seed=5)
    jmanifest.PatchManifest(recs).save(manifest.manifest_path(data.patches_dir,
                                                              3))
    os.makedirs(data.train_img_dir, exist_ok=True)
    open(os.path.join(data.train_img_dir, "s.wsi.npz"), "w").close()
    models = tmp_path / "models"
    # 16 filters: at 8 filters and 224² inputs the oneDNN convolution
    # backward of torch 2.13's CPU build corrupts the heap (see
    # tests/test_torch_port_streaming.py)
    save_model(str(models / "resnet18_patch_classifier"),
               state_dict_from_flax(_randomized_variables(jax, 9,
                                                          num_filters=16)))
    return data


def _cli_argv(tmp_path, name, extra):
    cfg = tmp_path / f"{name}.json"
    cfg.write_text(json.dumps({"log_dir": str(tmp_path / name / "logs"),
                               "model": {"pretrained": False}}))
    return [*extra, "--data_dir", str(tmp_path / "data"), "--batch_size",
            str(BATCH), "--epochs", "1", "--models_dir",
            str(tmp_path / name), "--config", str(cfg), "--device", "cpu"]


@pytest.mark.parametrize("extra", [["--extract_features"],
                                   ["--extract_features", "--int8"],
                                   ["--qat"]],
                         ids=["features", "features_int8", "qat"])
def test_cli_group_paths_equal_one_process(tmp_path, extra):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
        main as cli,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models import (
        quant_artifact as qa,
    )

    _feature_root(tmp_path)
    for name in ("one", "dp"):
        shutil.copytree(tmp_path / "models", tmp_path / name)
    assert cli.main(_cli_argv(tmp_path, "one", extra)) == 0
    feats_one = None
    fdir = tmp_path / "data" / "features"
    if "--extract_features" in extra:
        feats_one = np.load(fdir / "patch_features_3.npy")
        shutil.rmtree(fdir)
    res = workers.run_world(workers.cli_worker, 2, str(tmp_path / "ranks"),
                            _cli_argv(tmp_path, "dp", extra))
    assert [r["rc"] for r in res] == [0, 0]
    if feats_one is not None:
        got = np.load(fdir / "patch_features_3.npy")
        if "--int8" in extra:
            np.testing.assert_array_equal(got, feats_one)
        else:
            close(got, feats_one, FLOAT_RTOL)
        assert (fdir / "patch_paths_3.txt").read_text().count("\n") == 13
    else:
        one = _flat_tree(qa.load_quantized(
            str(tmp_path / "one" / qa.CLASSIFIER_ARTIFACT)))
        dp = _flat_tree(qa.load_quantized(
            str(tmp_path / "dp" / qa.CLASSIFIER_ARTIFACT)))
        assert one.keys() == dp.keys()
        for k, v in one.items():
            if "qkernels" in k:
                # int8 weights of tuned kernels: a rounding step apart at
                # most where Adam's updates differ in their last bits
                assert (torch.as_tensor(dp[k]).int()
                        - torch.as_tensor(v).int()).abs().max() <= 1, k


@pytest.mark.parametrize("argv,refused", [
    (["--patch"], "--patch"),
    (["--train", "--train_mil"], "--train_mil"),
    (["--qat", "--prepare"], "--prepare"),
    (["--extract_features", "--validate"], "--validate"),
    (["--train_multiscale", "--validation"], "--validation"),
    (["--qat", "--quantize"], "--quantize"),
])
def test_cli_under_torchrun_still_refuses_the_single_process_actions(
        tmp_path, monkeypatch, argv, refused):
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
        main as cli,
    )

    monkeypatch.setenv("WORLD_SIZE", "2")
    assert cli.main([*argv, "--data_dir", str(tmp_path), "--device",
                     "cpu"]) == 2
