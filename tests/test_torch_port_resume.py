"""Train-state checkpoints of the port (``train/checkpoints.py::
CheckpointManager``, ``Trainer.save_checkpoint`` and
``restore_checkpoint``), as ``tests/test_resume.py`` asks of the JAX
package: after a restore the update count, the weights, the BN statistics
and Adam's moments are those that were saved (equal, exactly), Adam's
first moments are nonzero, and an empty directory restores nothing.
"""

import os

import numpy as np
import pytest
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18Classifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    CheckpointManager,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
    make_simclr_train_step,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    SimCLRModel,
)

torch.set_num_threads(2)

WIDTH = 8  # stem width of the narrow ResNet18


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    rng = np.random.default_rng(0)
    data = config.DataConfig(data_dir=str(tmp_path_factory.mktemp("data")))
    w = patch_store.PackedPatchWriter(data.patches_dir, 3, "slide_0", 32)
    labels = (np.arange(10) % 3 == 0).astype(np.int64)
    recs = w.write_batch(rng.integers(0, 256, (10, 32, 32, 3), dtype=np.uint8),
                         np.stack([np.arange(10) * 32, np.zeros(10, int)], 1),
                         labels)
    w.close()
    return datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=32)


def _trainer(ds, seed=0):
    return trainer.Trainer(
        ResNet18Classifier(num_filters=WIDTH,
                           generator=torch.Generator().manual_seed(seed)),
        ds, None, batch_size=4, learning_rate=1e-3, seed=0, device="cpu")


def test_trainer_checkpoint_restores_the_full_train_state(ds, tmp_path):
    tr = _trainer(ds)
    tr.fit(num_epochs=1)
    assert tr.state.step == 3  # 10 rows at batch 4
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    tr.save_checkpoint(mgr, epoch=1)
    saved = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    saved_opt = tr.state.optimizer.state_dict()

    fresh = _trainer(ds, seed=9)  # other weights until the restore
    assert not torch.equal(fresh.state.model.fc.weight, saved["fc.weight"])
    assert fresh.restore_checkpoint(mgr) == 1
    assert fresh.state.step == 3
    for k, v in fresh.state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k  # weights and BN buffers
    opt = fresh.state.optimizer.state_dict()
    fc = [i for i, (n, _) in enumerate(fresh.state.model.named_parameters())
          if n == "fc.weight"][0]
    assert opt["state"][fc]["exp_avg"].abs().max() > 0
    for i, st in saved_opt["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt["state"][i][key], st[key]), (i, key)
    assert opt["param_groups"] == saved_opt["param_groups"]
    # training goes on from the restored state
    fresh.train_epoch(1)
    assert fresh.state.step == 6
    mgr.close()

    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.latest_step() is None
    assert _trainer(ds).restore_checkpoint(empty) is None
    assert empty.restore(_trainer(ds).state) is None
    empty.close()


def test_restored_step_continues_like_the_saved_one(ds, tmp_path):
    """One step from a restored state equals one step from the state that
    was saved (same batch, same augmentation draw)."""
    imgs, labels = ds.read_batch(range(4))
    batch = (torch.from_numpy(imgs), torch.from_numpy(labels).long(),
             torch.ones(4))
    step = trainer.make_train_step(np.array([1.0, 2.0], np.float32))
    a = create_train_state(ResNet18Classifier(
        num_filters=WIDTH, generator=torch.Generator().manual_seed(1)),
        1e-3, torch.device("cpu"))
    a, _ = step(a, torch.Generator().manual_seed(3), *batch)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(7, a)
    b = create_train_state(ResNet18Classifier(
        num_filters=WIDTH, generator=torch.Generator().manual_seed(2)),
        1e-3, torch.device("cpu"))
    assert mgr.restore(b) is b and b.step == 1
    outs = [step(s, torch.Generator().manual_seed(4), *batch)
            for s in (a, b)]
    assert outs[0][1]["loss"].item() == outs[1][1]["loss"].item()
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert torch.equal(p, q), n
    assert a.step == b.step == 2


def test_max_to_keep_and_step_selection(tmp_path):
    model = ResNet18Classifier(num_filters=WIDTH)
    state = create_train_state(model, 1e-3, torch.device("cpu"))
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    for step in (1, 2, 10, 3):
        state.step = step * 100
        with torch.no_grad():
            model.fc.bias.fill_(float(step))
        mgr.save(step, state)
    assert mgr.steps() == [3, 10]  # the two largest steps
    assert mgr.latest_step() == 10
    assert sorted(os.listdir(tmp_path / "c")) == ["ckpt_10.pt", "ckpt_3.pt"]
    target = create_train_state(ResNet18Classifier(num_filters=WIDTH), 1e-3,
                                torch.device("cpu"))
    mgr.restore(target, 3)
    assert target.step == 300
    assert torch.equal(target.model.fc.bias, torch.full((2,), 3.0))
    mgr.restore(target)
    assert target.step == 1000
    with pytest.raises(FileNotFoundError):
        mgr.restore(target, 1)


def test_every_train_step_counts_its_updates():
    """The classifier and SimCLR steps both count updates in ``step``, the
    number a checkpoint restores (flax's ``TrainState.step``)."""
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    state = create_train_state(SimCLRModel(projection_dim=16,
                                           projection_hidden_dim=32),
                               1e-3, torch.device("cpu"))
    step = make_simclr_train_step(0.5, out_size=32)
    for _ in range(2):
        state, loss = step(state, torch.Generator().manual_seed(0), imgs,
                           torch.ones(4))
    assert state.step == 2 and np.isfinite(loss.item())
