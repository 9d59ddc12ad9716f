"""Patch-classifier training on one card.

Counterpart of the JAX package's ``train/trainer.py``:

- :func:`train_resnet_classifier`, the default weighted-loss trainer: Adam
  at 1e-4, class weights ``(1/count)/min``, validation accuracy each epoch,
  ``_best`` and ``_epoch{N}`` checkpoints, the final artifact
  ``resnet18_patch_classifier``;
- :func:`train_resnet_classifier_strategic`, the strategy trainer:
  ``balanced`` (balanced sampling, plain CE), ``weighted_loss``
  (``total/count`` weights), ``self_supervised`` (SimCLR pretraining when no
  encoder is on disk, then its encoder under a fresh head, ``total/count``
  weights).

A step (:func:`make_train_step`) draws the augmentation from a
``torch.Generator`` on the card, runs it through the hand-written kernel
(``ops/augment.py``, one launch), the forward under bf16 autocast over
float32 parameters, the weighted cross entropy in float32 with the ``valid``
mask of a wrap-padded last batch (whose padded rows still enter BN's batch
statistics, as in the JAX step), the backward and one Adam update.
``frozen_bn`` keeps every BatchNorm on its running statistics, which stay
as they are, while γ and β train. Metrics stay on the card until the epoch
ends. :meth:`Trainer.save_checkpoint` and :meth:`Trainer.restore_checkpoint`
write and read the full train state (weights, BN statistics, Adam's
moments, the update count) through ``train/checkpoints.py``'s
``CheckpointManager``.

With a process ``group`` (``torchrun``, one process a card: ``parallel/``)
the step is the JAX trainer's SPMD step over the ranks. Every rank walks
the same batch order and loads its contiguous rows of each global batch;
the augmentation is drawn for the global batch and each rank's rows taken;
BatchNorm normalizes with the global batch's statistics; the loss is the
global weighted mean, each rank's gradient its share; the gradients are
summed over the ranks in one flat bucket, so Adam makes the same update
everywhere. Rank 0 alone writes artifacts, history and checkpoints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
    preprocess_batch,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    BalancedSampler,
    BatchIterator,
    PatchDataset,
    make_train_val_datasets,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    PatchManifest,
    load_or_scan_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.prefetch import (
    Prefetcher,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    classifier_trunk_from_simclr,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet,
    ResNet18Classifier,
    set_process_group,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
    process_batch_slice,
    to_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
    barrier,
    is_main,
    rank_and_size,
    replicate,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    SUFFIX,
    load_model,
    model_artifact_path,
    save_model,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
    class_weights_inv_min,
    class_weights_total_over_count,
    weighted_cross_entropy,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)

log = get_logger("train")


def set_bn_frozen(model: torch.nn.Module, frozen: bool) -> None:
    """Every BatchNorm of ``model`` in eval mode (``frozen``) or in the
    model's own mode."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.train(model.training and not frozen)


def classifier_loss(model: torch.nn.Module, imgs: torch.Tensor,
                    labels: torch.Tensor, class_weights=None,
                    valid: torch.Tensor | None = None, group=None):
    """The step's loss and logits: the forward of the augmented batch
    (under bf16 autocast on the card), then the weighted cross entropy in
    float32 (over ``group``'s global batch, see ``weighted_cross_entropy``)."""
    with torch.autocast("cuda", torch.bfloat16,
                        enabled=imgs.device.type == "cuda"):
        logits = model(imgs)
    return (weighted_cross_entropy(logits, labels, class_weights, valid,
                                   group), logits)


def make_train_step(class_weights=None, frozen_bn: bool = False,
                    group=None) -> Callable:
    """``train_step(state, generator, imgs_u8, labels, valid) → (state,
    metrics)``: augment (draws from ``generator``) → forward → weighted CE →
    backward → Adam; BN statistics move in training mode unless
    ``frozen_bn``. ``metrics`` (loss, correct, count) are device scalars.

    With a ``group`` the batch is this rank's rows of the global batch
    (rank r holds rows [r·b, (r+1)·b)): the draws are the global batch's,
    ``metrics["loss"]`` is the global loss, correct and count are this
    rank's, and the gradients are summed over the group before Adam. The
    model's BatchNorm must take the group (``set_process_group``)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_grads,
    )

    rank, world = rank_and_size(group)
    weights = None if class_weights is None else np.asarray(class_weights,
                                                            np.float32)
    cw: dict[torch.device, torch.Tensor] = {}  # on each device, made once

    def train_step(state: TrainState, generator: torch.Generator,
                   imgs_u8: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor):
        dev = imgs_u8.device
        if weights is not None and dev not in cw:
            cw[dev] = torch.as_tensor(weights).to(dev)
        model = state.model
        model.train()
        set_bn_frozen(model, frozen_bn)
        b = imgs_u8.shape[0]
        imgs = preprocess_batch(generator, imgs_u8, training=True,
                                rows=None if group is None
                                else (rank * b, world * b))
        state.optimizer.zero_grad(set_to_none=True)
        loss, logits = classifier_loss(model, imgs, labels, cw.get(dev), valid,
                                       group)
        loss.backward()
        if group is not None:
            all_reduce_grads(model.parameters(), group)
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            metrics = {
                "loss": loss.detach(),
                "correct": ((logits.argmax(dim=-1) == labels).float()
                            * valid).sum(),
                "count": valid.sum(),
            }
        return state, metrics

    return train_step


@torch.no_grad()
def eval_step(model: torch.nn.Module, imgs_u8: torch.Tensor,
              labels: torch.Tensor, valid: torch.Tensor) -> dict:
    """Correct predictions and real rows of one batch, normalize only, the
    model in eval mode (its mode is restored after)."""
    was_training = model.training
    model.eval()
    with torch.autocast("cuda", torch.bfloat16,
                        enabled=imgs_u8.device.type == "cuda"):
        logits = model(normalize(imgs_u8))
    model.train(was_training)
    return {
        "correct": ((logits.argmax(dim=-1) == labels).float() * valid).sum(),
        "count": valid.sum(),
    }


def load_trunk(model: ResNet, sd: dict[str, torch.Tensor]) -> None:
    """Load a pretrained trunk into ``model``: every entry of ``sd`` but the
    head, and the head too when its shapes match the model's."""
    own = model.state_dict()
    head = {k: v for k, v in sd.items() if k.startswith("fc.")}
    take = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    if head and all(k in own and own[k].shape == v.shape
                    for k, v in head.items()):
        take.update(head)
    missing = [k for k in own if k not in take and not k.startswith("fc.")
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"pretrained weights lack {missing[:4]}...")
    model.load_state_dict(take, strict=False)


class Trainer:
    """Epoch-driven trainer around :func:`make_train_step`; with a process
    ``group``, one rank of the data-parallel trainer (``batch_size`` is the
    global batch, which the group's size must divide)."""

    def __init__(
        self,
        model: ResNet,
        train_ds: PatchDataset,
        val_ds: PatchDataset | None,
        batch_size: int,
        learning_rate: float,
        class_weights=None,
        sampler=None,
        seed: int = 0,
        pretrained_variables: dict[str, torch.Tensor] | None = None,
        frozen_bn: bool = False,
        device: str | torch.device = "cuda",
        group=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.group = group
        rows = process_batch_slice(batch_size, *rank_and_size(group))
        self.batch_iter = BatchIterator(
            train_ds, batch_size, shuffle=True, seed=seed, sampler=sampler,
            rows=rows,
        )
        self.val_iter = (
            BatchIterator(val_ds, batch_size, shuffle=False, rows=rows)
            if val_ds else None
        )
        if pretrained_variables:
            load_trunk(model, pretrained_variables)
        set_process_group(model, group)
        self.state = create_train_state(model, learning_rate, self.device)
        replicate(model, group)
        self.train_step = make_train_step(class_weights, frozen_bn=frozen_bn,
                                          group=group)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.history: list[dict] = []

    def _batches(self, batches):
        for imgs, labels, valid in batches:
            yield (to_device(imgs, self.device),
                   to_device(labels.astype(np.int64), self.device),
                   to_device(valid, self.device))

    def train_epoch(self, epoch: int) -> dict:
        # metrics stay on the card until the epoch ends: a fetch per step
        # would wait for each step before the host gathers the next batch
        step_metrics: list[dict] = []
        t0 = time.perf_counter()
        for imgs, labels, valid in self._batches(
                Prefetcher(self.batch_iter, depth=2)):
            self.state, metrics = self.train_step(
                self.state, self.generator, imgs, labels, valid)
            step_metrics.append(metrics)
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            epoch_totals,
        )

        totals = epoch_totals(step_metrics, self.group, self.device)
        return {
            "epoch": epoch,
            "train_loss": totals["loss"],
            "train_acc": totals["correct"] / max(totals["count"], 1.0),
            "steps": len(step_metrics),
            "seconds": time.perf_counter() - t0,
        }

    def evaluate(self) -> float:
        if self.val_iter is None:
            return float("nan")
        out = [eval_step(self.state.model, *batch)
               for batch in self._batches(self.val_iter)]
        if not out:
            return float("nan")
        correct, count = self._over_group(torch.stack(
            [torch.stack([o[k].float() for o in out]).sum()
             for k in ("correct", "count")])).tolist()
        return correct / max(count, 1.0)

    def _over_group(self, sums: torch.Tensor) -> torch.Tensor:
        """This rank's sums → the group's."""
        if self.group is None:
            return sums
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            all_reduce_sum,
        )

        return all_reduce_sum(sums, self.group)

    def fit(
        self,
        num_epochs: int,
        checkpoint_every: int | None = None,
        checkpoint_prefix: str | None = None,
        history_path: str | None = None,
        save_best: bool = True,
    ) -> list[dict]:
        """Train ``num_epochs`` epochs; under a group every rank runs it and
        rank 0 writes the checkpoints and the history."""
        main = is_main(self.group)
        best_val = -1.0
        for epoch in range(num_epochs):
            stats = self.train_epoch(epoch)
            stats["val_acc"] = self.evaluate()
            self.history.append(stats)
            if (
                save_best
                and checkpoint_prefix
                and np.isfinite(stats["val_acc"])
                and stats["val_acc"] > best_val
            ):
                best_val = stats["val_acc"]
                if main:
                    save_model(f"{checkpoint_prefix}_best", self.variables())
            log.info(
                "Epoch %d/%d, Train Loss: %.4f, Train Acc: %.4f, Val Acc: %.4f (%.1fs)",
                epoch + 1, num_epochs, stats["train_loss"],
                stats["train_acc"], stats["val_acc"], stats["seconds"],
            )
            if history_path and main:
                self._write_history(history_path)
            if (
                main
                and checkpoint_every
                and checkpoint_prefix
                and (epoch + 1) % checkpoint_every == 0
            ):
                save_model(
                    f"{checkpoint_prefix}_epoch{epoch + 1}", self.variables()
                )
                log.info("Checkpoint saved: %s_epoch%d", checkpoint_prefix, epoch + 1)
        barrier(self.group)
        return self.history

    def _write_history(self, path: str) -> None:
        """Per-epoch metrics as JSON."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.history, f, indent=2)

    def save_checkpoint(self, manager, epoch: int) -> None:
        """Persist the full train state under ``epoch`` through a
        ``checkpoints.CheckpointManager`` (rank 0 writes; every rank waits)."""
        if is_main(self.group):
            manager.save(epoch, self.state)
        barrier(self.group)

    def restore_checkpoint(self, manager) -> int | None:
        """Restore the latest full train state in place; the epoch it was
        saved under, or None when there is no checkpoint. Under a group
        every rank reads it, then takes rank 0's tensors (broadcast)."""
        step = manager.latest_step()
        if step is None:
            return None
        manager.restore(self.state, step)
        replicate(self.state.model, self.group)
        replicate(self.state.optimizer, self.group)
        return step

    def variables(self) -> dict[str, torch.Tensor]:
        """The model's state dict, on the CPU."""
        return {k: v.detach().cpu().clone()
                for k, v in self.state.model.state_dict().items()}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _load_datasets(cfg: Config, level: int,
                   manifest: PatchManifest | None = None):
    manifest = (manifest if manifest is not None
                else load_or_scan_manifest(cfg.data.patches_dir, level))
    if len(manifest) == 0:
        raise FileNotFoundError(
            f"No patches at level {level} under {cfg.data.patches_dir}; "
            "run extraction first (--patch)."
        )
    if len(manifest.slides()) < 2:
        log.warning("One slide (%s): the slide-level split puts it on both "
                    "sides, so validation reads the training patches",
                    manifest.slides())
    return make_train_val_datasets(
        manifest,
        val_fraction=cfg.data.val_fraction,
        split_seed=cfg.data.split_seed,
        balance_val_seed=cfg.data.balance_val_seed,
    )


def _classifier(cfg: Config) -> ResNet:
    return ResNet18Classifier(
        num_classes=cfg.model.num_classes,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        frozen_bn=cfg.train.freeze_bn,
    )


def train_resnet_classifier(
    cfg: Config, level: int = 3, epochs: int | None = None,
    pretrained_variables: dict[str, torch.Tensor] | None = None,
    device: str | torch.device = "cuda",
    group=None,
) -> Trainer:
    """The default weighted-loss trainer on the patches of ``level``; writes ``resnet18_patch_classifier`` (+``_best``,
    periodic) under ``cfg.models_dir`` and the history under
    ``cfg.log_dir``. ``pretrained_variables`` overrides the torchvision
    ImageNet start. ``group``: one rank of the data-parallel trainer (rank 0
    writes)."""
    log.info("Training ResNet18 classifier...")
    train_ds, val_ds = _load_datasets(cfg, level)
    weights = class_weights_inv_min(train_ds.labels, cfg.model.num_classes)
    log.info("Class weights (inv/min): %s", weights)

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.torch_import import (
        load_pretrained_resnet18,
    )

    pretrained = pretrained_variables or (
        load_pretrained_resnet18() if cfg.model.pretrained else None
    )
    if cfg.train.freeze_bn and pretrained is None:
        log.warning(
            "--freeze_bn without a warm start: BatchNorm will normalize "
            "with the INIT statistics (mean 0 / var 1) for the whole run — "
            "intended for fine-tuning from pretrained/SimCLR weights."
        )
    trainer = Trainer(
        _classifier(cfg),
        train_ds,
        val_ds,
        batch_size=cfg.train.batch_size,
        learning_rate=cfg.train.learning_rate,
        class_weights=weights,
        seed=cfg.train.seed,
        pretrained_variables=pretrained,
        frozen_bn=cfg.train.freeze_bn,
        device=device,
        group=group,
    )
    prefix = model_artifact_path(cfg.models_dir, "resnet18_patch_classifier")
    trainer.fit(
        epochs or cfg.train.epochs,
        checkpoint_every=cfg.train.checkpoint_every_epochs,
        checkpoint_prefix=prefix,
        history_path=os.path.join(cfg.log_dir, "train_history.json"),
    )
    _save_final(prefix, trainer)
    return trainer


def _save_final(prefix: str, trainer: Trainer) -> None:
    """The final artifact, written by rank 0; every rank waits for it."""
    if is_main(trainer.group):
        save_model(prefix, trainer.variables())
        log.info("Training complete. Model saved %s.", prefix)
    barrier(trainer.group)


def train_resnet_classifier_strategic(
    cfg: Config,
    level: int = 3,
    strategy: str = "weighted_loss",
    epochs: int | None = None,
    manifest: PatchManifest | None = None,
    device: str | torch.device = "cuda",
    group=None,
) -> Trainer:
    """The strategy trainer on the patches of ``level`` (or on an in-memory
    ``manifest``, for a machine without pyarrow); writes
    ``resnet18_patch_classifier_{strategy}``. ``self_supervised`` pretrains
    SimCLR only when ``<models_dir>/simclr_encoder.pt`` is missing.
    ``group``: one rank of the data-parallel trainer (and of the SimCLR
    pretraining)."""
    if strategy not in ("balanced", "weighted_loss", "self_supervised"):
        raise ValueError(f"unknown strategy {strategy!r}")
    log.info("Training ResNet18 classifier with strategy=%s...", strategy)
    train_ds, val_ds = _load_datasets(cfg, level, manifest)

    weights = None
    sampler = None
    pretrained = None
    if strategy in ("weighted_loss", "self_supervised"):
        # total/count weights serve both the weighted_loss and the
        # self_supervised criterion, as in the reference
        weights = class_weights_total_over_count(
            train_ds.labels, cfg.model.num_classes
        )
        log.info("Class weights (total/count): %s", weights)
    if strategy == "balanced":
        sampler = BalancedSampler(train_ds.labels, seed=cfg.train.seed)
    elif strategy == "self_supervised":
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
            pretrain_simclr,
        )

        encoder_path = model_artifact_path(cfg.models_dir, "simclr_encoder")
        # the resume gate tests the file save_model writes (the JAX package
        # tests its checkpoint directory, which has no suffix)
        if not os.path.exists(encoder_path + SUFFIX):
            log.info("No SimCLR encoder at %s%s: pretraining it", encoder_path,
                     SUFFIX)
            pretrain_simclr(
                cfg, level=level, device=device,
                dataset=None if manifest is None else PatchDataset(manifest),
                group=group)
        # the SimCLR trunk lives under "encoder."; lifted to the classifier's
        # names under a fresh head
        pretrained = classifier_trunk_from_simclr(load_model(encoder_path))

    trainer = Trainer(
        _classifier(cfg),
        train_ds,
        val_ds,
        batch_size=cfg.train.batch_size,
        learning_rate=cfg.train.learning_rate,
        class_weights=weights,
        sampler=sampler,
        seed=cfg.train.seed,
        pretrained_variables=pretrained,
        frozen_bn=cfg.train.freeze_bn,
        device=device,
        group=group,
    )
    prefix = model_artifact_path(
        cfg.models_dir, f"resnet18_patch_classifier_{strategy}"
    )
    trainer.fit(
        epochs or cfg.train.strategy_epochs,
        history_path=os.path.join(cfg.log_dir, f"train_history_{strategy}.json"),
    )
    _save_final(prefix, trainer)
    return trainer
