"""Data-parallel training steps of the port against one process and JAX.

The classifier step (``train/trainer.py::make_train_step(group=)``) and the
SimCLR step (``train/simclr_trainer.py::make_simclr_train_step(group=)``)
run in 2 and 4 spawned gloo processes (``torch_port_workers.py``) on a global
batch of 8 at 32² whose last two rows are wrap padding, so at world 4 the
last rank holds no valid row (the uneven case: a per-rank mean that is then
averaged would weigh it as much as the others). Each is held to:

- the same step in one process on the whole batch (the same generator: the
  augmentation is drawn for the global batch on every rank);
- JAX's step on the global batch with its input sharded over a 4-device mesh
  of the conftest's CPU devices, given the same augmentation draws (the
  classifier) or the same views (SimCLR);
- itself on every other rank: parameters, BN statistics and Adam's state
  bit-identical after the steps.

Tolerances: against world 1, 1e-5 of a tensor's largest magnitude for the
loss and the running statistics and 1e-4 for the gradients (layer4's BN
normalizes over 8 values, which amplifies the other summation order of the
global statistics); against JAX, the step tests' 1e-3 of max|g|
(``tests/test_torch_port_train.py``: the frameworks' float32 gradients differ
by up to 2.5e-4 there).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from ss25_hierarchical_multiscale_image_classification_tpu.data import (
    augment as jaugment,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from ss25_hierarchical_multiscale_image_classification_tpu.models.simclr import (
    SimCLRModel as JaxSimCLRModel,
    nt_xent_loss as jax_nt_xent_loss,
)
from ss25_hierarchical_multiscale_image_classification_tpu.train import (
    losses as jlosses,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    augment,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    simclr_state_dict_from_flax,
    state_dict_from_flax,
)

import torch_port_workers as workers
from test_torch_port_train import _randomized

torch.set_num_threads(2)

SIZE, WIDTH, BATCH = workers.SIZE, workers.WIDTH, workers.BATCH
CW = np.array([1.0, 2.5], np.float32)
LOSS_RTOL = 1e-5
STATS_RTOL = 1e-5  # of the tensor's max|value|
GRAD_RTOL = 1e-4  # of the tensor's max|g|, against world 1
JAX_GRAD_RTOL = 1e-3  # of the tensor's max|g|, against JAX
JAX_STATS_RTOL = 1e-5
# Adam's update is lr·m̂/(√v̂ + ε), about lr whatever the gradient's size:
# where a gradient sits near 0, another summation order can turn the
# update around, 2·lr apart. The weights after the steps are held to that
# (measured: 0.09·lr a step after two steps, 0.29·lr after six); the
# gradients themselves are held tightly above
ADAM_STEP_SHARE = 2.0
# running statistics after several steps: their inputs come from weights
# within that bound of each other
AFTER_STEPS_STATS_RTOL = 2e-3


def close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def after_adam(got, want, steps, lr=1e-3):
    diff = (got.double() - want.double()).abs().max().item()
    assert diff <= ADAM_STEP_SHARE * lr * steps, diff


def _mesh_put(x, shards=4):
    m = JaxMesh(np.array(jax.devices()[:shards]), ("data",))
    return jax.device_put(jnp.asarray(x), NamedSharding(m, P("data")))


# ---------------------------------------------------------------------------
# the classifier step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classifier_variables():
    model = JaxResNet((2, 2, 2, 2), num_classes=2, num_filters=WIDTH,
                      dtype=jnp.float32)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)),
                                        train=False))(jax.random.key(0))
    return model, _randomized(init, seed=1)


@pytest.fixture(scope="module")
def classifier_world1(classifier_variables):
    _, variables = classifier_variables
    return workers.classifier_step(state_dict_from_flax(variables), CW)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def classifier_runs(request, classifier_variables, tmp_path_factory):
    """Each rank's two steps and its ``Trainer.fit`` (files under
    ``fit``, shared by the ranks), in one spawn per world."""
    _, variables = classifier_variables
    w = request.param
    root = tmp_path_factory.mktemp(f"classifier{w}")
    res = workers.run_world(workers.classifier_worker, w, str(root / "ranks"),
                            state_dict_from_flax(variables), CW,
                            str(root / "fit"))
    return w, res, root / "fit"


@pytest.fixture(scope="module")
def classifier_world(classifier_runs):
    w, res, _ = classifier_runs
    return w, [r["step"] for r in res]


def test_dp_classifier_step_equals_world1(classifier_world, classifier_world1):
    w, res = classifier_world
    want = classifier_world1
    for out in res:
        for got_m, want_m in zip(out["metrics"], want["metrics"]):
            # the loss is the global one on every rank; correct and count
            # are the rank's and sum to world 1's
            close(got_m["loss"], want_m["loss"], LOSS_RTOL)
        for k, g in want["grads"].items():
            close(out["grads"][k], g, GRAD_RTOL)
        for k, v in want["stats"].items():
            close(out["stats"][k], v, STATS_RTOL)
        for k, v in want["sd"].items():
            if v.is_floating_point():
                after_adam(out["sd"][k], v, len(want["metrics"]))
    for step in range(len(want["metrics"])):
        for key in ("correct", "count"):
            assert sum(o["metrics"][step][key] for o in res) == \
                want["metrics"][step][key]
    # six valid rows: world 4's last rank holds none of them
    assert [o["metrics"][0]["count"] for o in res] == (
        [4.0, 2.0] if w == 2 else [2.0, 2.0, 2.0, 0.0])


def test_dp_classifier_ranks_stay_bit_identical(classifier_world):
    _, res = classifier_world
    for out in res[1:]:
        for k, v in res[0]["sd"].items():
            assert torch.equal(out["sd"][k], v), k
        for k, g in res[0]["grads"].items():
            assert torch.equal(out["grads"][k], g), k


@pytest.fixture(scope="module")
def jax_classifier_step(classifier_variables):
    """The JAX step's loss function on the global batch sharded over 4
    devices, with the port's augmentation draws: loss, gradients, new
    statistics."""
    model, variables = classifier_variables
    d = workers.step_inputs()
    params = augment.sample_augment_params(torch.Generator().manual_seed(11),
                                           BATCH)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = _mesh_put(jaugment.augment_batch(jparams, jnp.asarray(d["imgs"])))
    labels = _mesh_put(d["labels"].astype(np.int32))
    valid = _mesh_put(d["valid"])

    def loss_fn(p):
        logits, upd = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return jlosses.weighted_cross_entropy(
            logits, labels, jnp.asarray(CW), valid), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return (float(loss),
            state_dict_from_flax({"params": jax.device_get(grads),
                                  "batch_stats": variables["batch_stats"]}),
            state_dict_from_flax({"params": variables["params"],
                                  "batch_stats": jax.device_get(
                                      upd["batch_stats"])}))


def test_dp_classifier_step_equals_jax_on_a_4_device_mesh(classifier_world,
                                                         jax_classifier_step):
    _, res = classifier_world
    loss, grads, stats = jax_classifier_step
    for out in res:
        close(out["metrics"][0]["loss"], loss, LOSS_RTOL * 10)
        for k, g in out["grads"].items():
            close(g, grads[k], JAX_GRAD_RTOL)
        for k, v in out["stats"].items():
            close(v, stats[k], JAX_STATS_RTOL)


def test_dp_classifier_draws_are_the_global_batchs():
    """``preprocess_batch(rows=)``: each rank's rows of the global draw,
    so the ranks' outputs stack to world 1's exactly."""
    imgs = torch.from_numpy(workers.step_inputs()["imgs"])
    whole = augment.preprocess_batch(torch.Generator().manual_seed(5), imgs)
    parts = [augment.preprocess_batch(torch.Generator().manual_seed(5),
                                      imgs[r * 2:(r + 1) * 2], rows=(r * 2, 8))
             for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)
    v1, v2 = augment.simclr_two_views(torch.Generator().manual_seed(6), imgs,
                                      SIZE)
    halves = [augment.simclr_two_views(torch.Generator().manual_seed(6),
                                       imgs[r * 4:(r + 1) * 4], SIZE,
                                       rows=(r * 4, 8)) for r in range(2)]
    assert torch.equal(torch.cat([h[0] for h in halves]), v1)
    assert torch.equal(torch.cat([h[1] for h in halves]), v2)
    with pytest.raises(ValueError, match="outside a global batch"):
        augment.preprocess_batch(torch.Generator(), imgs[:4], rows=(6, 8))


# ---------------------------------------------------------------------------
# the SimCLR step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def simclr_variables():
    model = JaxSimCLRModel(dtype=jnp.float32)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)),
                                        train=False))(jax.random.key(0))
    return model, _randomized(init, seed=2)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def simclr_runs(request, simclr_variables, tmp_path_factory):
    """Each rank's SimCLR step with both losses, one spawn per world; and
    world 1's."""
    _, variables = simclr_variables
    w = request.param
    sd = simclr_state_dict_from_flax(variables)
    res = workers.run_world(workers.simclr_worker, w,
                            str(tmp_path_factory.mktemp(f"simclr{w}")), sd)
    return w, res, {impl: workers.simclr_step(sd, impl)
                    for impl in ("xla", "pallas")}


@pytest.fixture(params=["xla", "pallas"], ids=["dense", "kernel-route"])
def simclr_world(request, simclr_runs):
    w, res, one = simclr_runs
    impl = request.param
    return w, impl, [r[impl] for r in res], one[impl]


def test_dp_simclr_step_equals_world1(simclr_world):
    _, _, res, want = simclr_world
    for out in res:
        close(out["loss"], want["loss"], LOSS_RTOL)
        for k, g in want["grads"].items():
            close(out["grads"][k], g, GRAD_RTOL)
        for k, v in want["stats"].items():
            close(out["stats"][k], v, STATS_RTOL)
    for out in res[1:]:
        for k, v in res[0]["sd"].items():
            assert torch.equal(out["sd"][k], v), k


@pytest.fixture(scope="module")
def jax_simclr_step(simclr_variables):
    """JAX's SimCLR loss function on the port's views of the global batch,
    sharded over 4 devices: loss, gradients, new statistics."""
    model, variables = simclr_variables
    d = workers.step_inputs(4)
    v1, v2 = augment.simclr_two_views(torch.Generator().manual_seed(12),
                                      torch.from_numpy(d["imgs"]), SIZE)
    v1, v2 = (_mesh_put(v.float().numpy()) for v in (v1, v2))
    valid = _mesh_put(d["valid"].astype(bool))

    def loss_fn(params):
        z1, upd = model.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              v1, train=True, mutable=["batch_stats"])
        z2, upd = model.apply({"params": params,
                               "batch_stats": upd["batch_stats"]},
                              v2, train=True, mutable=["batch_stats"])
        return jax_nt_xent_loss(z1, z2, workers.TAU, valid=valid), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return float(loss), simclr_state_dict_from_flax(jax.device_get(
        {"params": grads, "batch_stats": upd["batch_stats"]}))


def test_dp_simclr_step_equals_jax_on_a_4_device_mesh(simclr_world,
                                                      jax_simclr_step):
    _, _, res, _ = simclr_world
    loss, after = jax_simclr_step
    for out in res:
        close(out["loss"], loss, LOSS_RTOL * 10)
        for k, g in out["grads"].items():
            close(g, after[k], JAX_GRAD_RTOL)
        for k, v in out["stats"].items():
            close(v, after[k], JAX_STATS_RTOL)


def test_world1_steps_keep_the_single_process_path():
    """No group: the step takes no collective (no process group exists in
    this process) and BatchNorm keeps ``F.batch_norm``."""
    import torch.distributed as dist

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        BatchNorm2d,
    )

    assert not dist.is_initialized()
    assert BatchNorm2d.group is None


def test_dp_trainer_fit_equals_world1_and_rank0_writes(classifier_variables,
                                                       classifier_runs,
                                                       tmp_path):
    """``Trainer(group=)``: one epoch of two global batches (the second
    wrap-padded) on every rank; history and weights equal world 1's, the
    ranks' weights bit-identical, and only rank 0's files on disk (the
    ranks share the directory)."""
    _, variables = classifier_variables
    _, res, fit_dir = classifier_runs
    sd = state_dict_from_flax(variables)
    os.makedirs(tmp_path / "one")
    want = workers.trainer_fit(0, 1, None, sd, CW, str(tmp_path / "one"))
    assert sorted(os.listdir(fit_dir)) == sorted(
        os.listdir(tmp_path / "one")) == ["clf_best.pt", "clf_epoch1.pt",
                                          "history.json"]
    for out in (r["fit"] for r in res):
        (h,), (h1,) = out["history"], want["history"]
        assert h["steps"] == h1["steps"] == 2 and h["epoch"] == 0
        close(h["train_loss"], h1["train_loss"], LOSS_RTOL)
        assert h["train_acc"] == h1["train_acc"] and h["val_acc"] == h1["val_acc"]
        for k, v in want["sd"].items():
            if "running" in k:
                close(out["sd"][k], v, AFTER_STEPS_STATS_RTOL)
            elif v.is_floating_point():
                after_adam(out["sd"][k], v, h["steps"])
            assert torch.equal(out["sd"][k], res[0]["fit"]["sd"][k]), k


def test_cli_train_under_a_process_group_equals_one_process(tmp_path):
    """``--train`` as two gloo ranks (what ``torchrun --nproc_per_node=2``
    runs, with ``--device cpu``): rank 0 writes the artifacts and the
    history, which equal one process's run of the same command (an
    epoch of three steps at batch 4)."""
    import json

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        TrainConfig,
    )
    from test_torch_port_train import _store

    _store(tmp_path / "data")

    def argv(name):
        cfg = tmp_path / f"{name}.json"
        cfg.write_text(json.dumps({"log_dir": str(tmp_path / name / "logs"),
                                   "model": {"pretrained": False}}))
        return ["--train", "--epochs", "1", "--batch_size", "4", "--data_dir",
                str(tmp_path / "data"), "--models_dir",
                str(tmp_path / name / "models"), "--config", str(cfg),
                "--device", "cpu"]

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
        main as cli,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )

    assert cli.main(argv("one")) == 0
    res = workers.run_world(workers.cli_worker, 2, str(tmp_path / "ranks"),
                            argv("dp"))
    assert [r["rc"] for r in res] == [0, 0]
    names = sorted(os.listdir(tmp_path / "dp" / "models"))
    assert names == sorted(os.listdir(tmp_path / "one" / "models"))
    assert "resnet18_patch_classifier.pt" in names
    history = [json.loads((tmp_path / n / "logs" / "train_history.json")
                          .read_text()) for n in ("one", "dp")]
    for h1, hw in zip(*history):
        close(hw["train_loss"], h1["train_loss"], LOSS_RTOL)
        assert hw["train_acc"] == h1["train_acc"]
        assert hw["val_acc"] == h1["val_acc"]
    want = load_model(str(tmp_path / "one" / "models" /
                          "resnet18_patch_classifier"))
    got = load_model(str(tmp_path / "dp" / "models" /
                         "resnet18_patch_classifier"))
    for k, v in want.items():
        if "running" in k:
            # after several steps the statistics follow weights that differ
            # within the Adam bound (measured: 3e-4 of max|value|)
            close(got[k], v, AFTER_STEPS_STATS_RTOL)
        elif v.is_floating_point():
            after_adam(got[k], v, 3 * len(history[0]),
                       lr=TrainConfig().learning_rate)
