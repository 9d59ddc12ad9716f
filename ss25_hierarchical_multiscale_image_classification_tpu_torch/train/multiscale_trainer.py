"""Hierarchical multiscale classifier training.

Counterpart of the JAX package's ``train/multiscale_trainer.py``
(``deep_supervision_loss``, ``warm_start_from_classifier``,
``train_multiscale_classifier``). It trains
``models/hierarchical.py::HierarchicalPatchClassifier`` on the co-located
patches of ``data/multiscale.py::MultiscaleDataset`` on one card:

- a step (:func:`make_multiscale_train_step`) draws ONE augmentation for
  the batch and applies it to every level (``preprocess_multiscale_batch``:
  on the card the ``augment`` kernel, once per level), runs the shared trunk
  once on the stacked S·B batch under bf16 autocast with training BN (its
  statistics over every level together, wrap-padded rows included), and
  takes the fusion head's weighted cross entropy plus ``aux_weight`` times
  the per-scale heads' (:func:`deep_supervision_loss`), then one Adam
  update;
- with a process ``group`` (``torchrun``, one process a card:
  ``parallel/``) the step is the JAX trainer's over its mesh: every rank
  walks the same cell order and loads its contiguous rows of each global
  batch (``shard_batch``'s split of the S·B stack), the augmentation is
  drawn for the global batch and each rank's rows taken (the ``augment``
  kernel runs once a level on those rows), BatchNorm normalizes with the
  statistics of the whole stacked S·B batch of the group, the losses are the
  global batch's, the gradients are summed over the ranks and Adam makes the
  same update everywhere; rank 0 calibrates and writes the artifact;
- after training, the validation cells calibrate the detection scores
  (``evaluation/calibration.py``: temperatures, the default surface, the
  cascade's operating point), which ship inside the artifact
  ``hierarchical_classifier.pt`` in the format of
  ``models/convert.py::hierarchical_artifact``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Mapping

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
    preprocess_multiscale_batch,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.multiscale import (
    MultiscaleDataset,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.prefetch import (
    Prefetcher,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.calibration import (
    fit_cascade_margin,
    fit_temperature,
    pick_combine_mode,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    hierarchical_artifact,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.hierarchical import (
    HierarchicalPatchClassifier,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    set_process_group,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
    process_batch_slice,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
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
    weighted_cross_entropy,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
    to_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)

log = get_logger("train.multiscale")


def deep_supervision_loss(aux: torch.Tensor, labels: torch.Tensor,
                          weights, valid: torch.Tensor, group=None
                          ) -> torch.Tensor:
    """Per-scale auxiliary cross entropy over (B, S, C) logits (over
    ``group``'s global batch, see ``weighted_cross_entropy``).

    The flatten is sample-major (row r is sample r // S at scale r % S), so
    labels and ``valid`` are repeated S times each; tiling them would pair
    row r with sample r % B, almost every row with another sample's label."""
    s = aux.shape[1]
    return weighted_cross_entropy(aux.reshape(-1, aux.shape[-1]),
                                  labels.repeat_interleave(s), weights,
                                  valid.repeat_interleave(s), group)


def warm_start_from_classifier(state: Mapping[str, torch.Tensor],
                               clf_state: Mapping[str, torch.Tensor]
                               ) -> dict[str, torch.Tensor]:
    """The multiscale classifier's state dict ``state`` seeded from a
    trained single-level classifier's (``resnet18_patch_classifier``): every
    ``trunk.*`` entry, weights and BN statistics, from the classifier's
    entry of the same name, and ``aux_head`` from its ``fc`` where the
    shapes match, so that the per-level ensemble starts at the single-level
    model's quality. The scale embedding and the fusion head keep their
    values."""
    out = dict(state)
    for key in state:
        if key.startswith("trunk.") and not key.endswith("num_batches_tracked"):
            out[key] = clf_state[key.removeprefix("trunk.")]
    if ("fc.weight" in clf_state and "aux_head.weight" in state
            and clf_state["fc.weight"].shape == state["aux_head.weight"].shape):
        out["aux_head.weight"] = clf_state["fc.weight"]
        out["aux_head.bias"] = clf_state["fc.bias"]
    return out


def multiscale_loss(model: HierarchicalPatchClassifier, batch: dict,
                    labels: torch.Tensor, class_weights, valid: torch.Tensor,
                    aux_weight: float, group=None):
    """The step's loss and fused logits: the forward of the augmented
    ``{level: batch}`` (under bf16 autocast on the card), the fusion head's
    weighted cross entropy plus ``aux_weight`` times
    :func:`deep_supervision_loss`, in float32 (over ``group``'s global
    batch)."""
    dev = next(iter(batch.values())).device
    with torch.autocast("cuda", torch.bfloat16, enabled=dev.type == "cuda"):
        logits, aux = model(batch, with_aux=True)
    loss = weighted_cross_entropy(logits, labels, class_weights, valid, group)
    loss = loss + aux_weight * deep_supervision_loss(aux, labels,
                                                     class_weights, valid,
                                                     group)
    return loss, logits


def make_multiscale_train_step(class_weights=None, aux_weight: float = 0.5,
                               group=None) -> Callable:
    """``train_step(state, generator, imgs_u8, labels, valid) → (state,
    metrics)`` with ``imgs_u8`` a ``{level: uint8 (B, S, S, 3)}`` dict on
    one device: one shared augmentation draw from ``generator`` → forward →
    loss → backward → Adam. ``metrics`` (loss, correct, count) are device
    scalars.

    With a ``group`` the batch is this rank's rows of the global batch
    (rank r holds rows [r·b, (r+1)·b) of every level): the draw is the
    global batch's, ``metrics["loss"]`` the global loss, correct and count
    this rank's, and the gradients are summed over the group before Adam.
    The model's BatchNorm must take the group (``set_process_group``)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_grads,
    )

    rank, world = rank_and_size(group)
    weights = None if class_weights is None else np.asarray(class_weights,
                                                            np.float32)
    cw: dict[torch.device, torch.Tensor] = {}  # on each device, made once

    def train_step(state: TrainState, generator: torch.Generator,
                   imgs_u8: dict, labels: torch.Tensor, valid: torch.Tensor):
        dev = labels.device
        if weights is not None and dev not in cw:
            cw[dev] = torch.as_tensor(weights).to(dev)
        state.model.train()
        b = labels.shape[0]
        batch = preprocess_multiscale_batch(
            generator, imgs_u8, training=True,
            rows=None if group is None else (rank * b, world * b))
        state.optimizer.zero_grad(set_to_none=True)
        loss, logits = multiscale_loss(state.model, batch, labels, cw.get(dev),
                                       valid, aux_weight, group)
        loss.backward()
        if group is not None:
            all_reduce_grads(state.model.parameters(), group)
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
def eval_logits(model: HierarchicalPatchClassifier, imgs_u8: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (B, C) and per-scale (B, S, C) logits of ``{level: uint8}``
    cells, normalize only, the model in eval mode (under bf16 autocast on
    the card)."""
    model.eval()
    batch = {lvl: normalize(x) for lvl, x in imgs_u8.items()}
    dev = next(iter(batch.values())).device
    with torch.autocast("cuda", torch.bfloat16, enabled=dev.type == "cuda"):
        return model(batch, with_aux=True)


def _upload(batches, dev: torch.device):
    for imgs, labels, valid in batches:
        yield ({lvl: to_device(x, dev) for lvl, x in imgs.items()},
               to_device(labels.astype(np.int64), dev), to_device(valid, dev))


def train_epoch(state: TrainState, train_step: Callable,
                generator: torch.Generator, dataset: MultiscaleDataset,
                batch_size: int, seed: int, indices: np.ndarray,
                device: torch.device, group=None) -> dict:
    """One epoch of ``train_step`` over the cells ``indices``, shuffled by
    ``seed``, read on a prefetch thread and uploaded through pinned memory
    (with a ``group``, this rank's rows of each global batch of
    ``batch_size``). Returns the summed ``loss``, ``correct`` and ``count``
    (the group's) and the number of ``steps``; the metrics stay on the card
    until the epoch ends."""
    rows = (None if group is None
            else process_batch_slice(batch_size, *rank_and_size(group)))
    step_out = []
    batches = Prefetcher(dataset.batches(batch_size, shuffle=True, seed=seed,
                                         indices=indices, rows=rows), depth=2)
    for imgs, labels, valid in _upload(batches, device):
        state, metrics = train_step(state, generator, imgs, labels, valid)
        step_out.append(metrics)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        epoch_totals,
    )

    return {**epoch_totals(step_out, group, device), "steps": len(step_out)}


def train_multiscale_classifier(
    cfg: Config,
    levels=(2, 3),
    epochs: int | None = None,
    dataset: MultiscaleDataset | None = None,
    fusion: str = "concat",
    batch_size: int | None = None,
    aux_weight: float = 0.5,
    init_from: str | None = "auto",
    input_mode: str = "resize",
    device: str | torch.device = "cuda",
    group=None,
) -> dict:
    """Train the fusion classifier on ``device``, write
    ``<models_dir>/hierarchical_classifier.pt`` and return ``{"variables"
    (the artifact's state dict), "history", "levels", "calibration"}``.
    ``group``: one rank of the data-parallel trainer (``batch_size`` is the
    global batch, which the group's size must divide; rank 0 calibrates
    and writes, every rank returns the same result).

    ``dataset=None`` joins the levels' manifests under ``patches_dir`` in
    ``input_mode``. ``init_from`` warm-starts the trunk and the aux head
    (:func:`warm_start_from_classifier`): ``"auto"`` from
    ``<models_dir>/resnet18_patch_classifier.pt`` when that file exists, a
    path (without ``.pt``) from that artifact, None not at all. After
    training, the validation cells of ``split_by_slide`` fit the fused and
    per-scale temperatures, the default surface, its mixture weights and,
    when the base level screens, the cascade margin."""
    dev = resolve_device(device)
    if dataset is None:
        dataset = MultiscaleDataset.from_patches_dir(
            cfg.data.patches_dir, levels=levels, input_mode=input_mode
        )
    if len(dataset) == 0:
        raise FileNotFoundError(
            f"no aligned multiscale cells at levels {levels}; extract "
            "patches at every requested level first"
        )
    levels = tuple(dataset.levels)
    batch_size = batch_size or cfg.train.batch_size
    train_idx, val_idx = dataset.split_by_slide(
        cfg.data.val_fraction, cfg.data.split_seed
    )
    log.info("multiscale split: %d train / %d val cells",
             len(train_idx), len(val_idx))

    model = HierarchicalPatchClassifier(
        levels=levels, num_classes=cfg.model.num_classes, fusion=fusion,
        generator=torch.Generator().manual_seed(cfg.train.seed),
    )
    if init_from == "auto":
        # the artifact on disk carries the suffix (the JAX package tests
        # its checkpoint directory, which has none)
        candidate = model_artifact_path(cfg.models_dir,
                                        "resnet18_patch_classifier")
        init_from = candidate if os.path.exists(candidate + SUFFIX) else None
    if init_from:
        model.load_state_dict(warm_start_from_classifier(
            model.state_dict(), load_model(init_from)))
        log.info("warm-started trunk + aux head from %s", init_from)

    set_process_group(model, group)
    state = create_train_state(model, cfg.train.learning_rate, dev)
    replicate(model, group)
    weights = class_weights_inv_min(dataset.labels[train_idx],
                                    cfg.model.num_classes)
    train_step = make_multiscale_train_step(weights, aux_weight, group)

    epochs = epochs or cfg.train.strategy_epochs
    history = []
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed + 7919)
    for epoch in range(epochs):
        t0 = time.perf_counter()
        totals = train_epoch(state, train_step, generator, dataset,
                             batch_size, cfg.train.seed + epoch, train_idx,
                             dev, group)
        acc = totals["correct"] / max(totals["count"], 1.0)
        history.append({"epoch": epoch, "loss": totals["loss"], "acc": acc})
        log.info(
            "multiscale epoch %d/%d: loss %.4f acc %.4f (%.1fs)",
            epoch + 1, epochs, totals["loss"], acc, time.perf_counter() - t0,
        )

    calibration = None
    if is_main(group):
        calibration = _calibrate(model, dataset, val_idx, batch_size, dev)
    calibration = broadcast_object(calibration, group)
    sd = hierarchical_artifact(model.state_dict(), calibration)
    if is_main(group):
        save_model(model_artifact_path(cfg.models_dir,
                                       "hierarchical_classifier"), sd)
    barrier(group)
    return {"variables": sd, "history": history, "levels": levels,
            "calibration": calibration}


def _calibrate(model: HierarchicalPatchClassifier,
               dataset: MultiscaleDataset, val_idx: np.ndarray,
               batch_size: int, dev: torch.device) -> dict:
    """The post-hoc calibration on the held-out cells ``val_idx``:
    temperatures, the default surface and its mixture weights, the cascade
    margin (module docstring)."""
    val_logits, val_aux, val_labels = [], [], []
    for imgs, labels, valid in dataset.batches(batch_size, shuffle=False,
                                               indices=val_idx):
        logits, aux = eval_logits(
            model, {lvl: to_device(x, dev) for lvl, x in imgs.items()})
        keep = valid > 0
        val_logits.append(logits.float().cpu().numpy()[keep])
        val_aux.append(aux.float().cpu().numpy()[keep])
        val_labels.append(labels[keep])
    input_mode = dataset.input_mode
    calibration = {"temperature": 1.0, "aux_temperature": 1.0,
                   "ensemble_weight": 1.0, "ensemble_base_weight": 0.5,
                   "combine": "fusion",
                   # serving rebuilds the same fine-stream input (0 = resize,
                   # 1 = crop: the artifact holds numbers only)
                   "input_mode": 1 if input_mode == "crop" else 0}
    if val_logits:
        logits = np.concatenate(val_logits)
        aux = np.concatenate(val_aux)
        labels_np = np.concatenate(val_labels)
        # shuffle=False walks val_idx in order and `keep` drops the wrap
        # padding, so the kept rows align 1:1 with val_idx
        slides_np = np.array(
            [dataset.samples[int(i)].slide for i in val_idx]
        )[: len(labels_np)]
        cells_np = np.array(
            [dataset.samples[int(i)].cell for i in val_idx], np.float64
        )[: len(labels_np)]
        s = aux.shape[1]
        t_fusion = fit_temperature(logits, labels_np)
        t_aux = fit_temperature(
            # sample-major flatten (B, S, C): repeat, not tile
            aux.reshape(-1, aux.shape[-1]), np.repeat(labels_np, s)
        )
        # mixed in calibrated log-odds, the space the producer ranks
        # detections in (infer/multiscale.py::_combine_scores); the base
        # (detection-grid) level is the last, the largest level number
        m_fusion = (logits[:, 1] - logits[:, 0]) / t_fusion
        m_per_level = (aux[:, :, 1] - aux[:, :, 0]) / t_aux
        m_aux = m_per_level.mean(axis=1)
        m_aux_base = m_per_level[:, -1]
        mode, weights, proxies = pick_combine_mode(
            m_fusion, m_aux, labels_np, slides_np, m_aux_base=m_aux_base
        )
        calibration = {
            "temperature": float(t_fusion),
            "aux_temperature": float(t_aux),
            "ensemble_weight": float(weights["ensemble_weight"]),
            "ensemble_base_weight": float(weights["ensemble_base_weight"]),
            "combine": mode,
            "input_mode": 1 if input_mode == "crop" else 0,
        }
        # the cascade's operating point, or none when the base-level screen
        # is uninformative on validation (then --cascade auto runs the full
        # fused pass)
        margin = fit_cascade_margin(
            m_aux_base, labels_np, slides=slides_np, cells=cells_np
        )
        if margin is not None:
            calibration["cascade_margin"] = margin
            calibration["cascade_val_screen_rate"] = float(
                (m_aux_base[labels_np == 0] < margin).mean()
            )
        log.info("calibration: %s (proxies %s)", calibration, proxies)
    return calibration
