"""Patch-classifier evaluation on the validation split.

Counterpart of the JAX package's ``evaluation/classifier_eval.py``: the
saved classifier (``<models_dir>/resnet18_patch_classifier.pt``) over the
class-balanced validation split of the level's patches, normalize only,
reported as accuracy, precision, recall, F1 and the confusion matrix. On
the card the forward runs in bf16 autocast over the float32 weights, as the
trainer's evaluation does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    BatchIterator,
    make_train_val_datasets,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    load_or_scan_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.evaluation.metrics import (
    classification_report,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    resnet18_from_state_dict,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    SUFFIX,
    load_model,
)

log = get_logger("evaluation.classifier")


def evaluate_resnet_classifier(
    cfg: Config,
    level: int = 3,
    model_path: str | None = None,
    batch_size: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Evaluate the saved classifier (``model_path`` without ``.pt``) on
    the balanced validation split of ``level``; returns the metric
    report."""
    dev = resolve_device(device)
    manifest = load_or_scan_manifest(cfg.data.patches_dir, level)
    if len(manifest) == 0:
        raise FileNotFoundError(f"no patches at level {level}")
    _, val_ds = make_train_val_datasets(
        manifest,
        val_fraction=cfg.data.val_fraction,
        split_seed=cfg.data.split_seed,
        balance_val_seed=cfg.data.balance_val_seed,
    )

    model_path = model_path or os.path.join(
        cfg.models_dir, "resnet18_patch_classifier"
    )
    if not os.path.exists(model_path + SUFFIX):
        raise FileNotFoundError(f"model not found: {model_path}{SUFFIX}")
    model = resnet18_from_state_dict(load_model(model_path)).to(
        dev, memory_format=torch.channels_last)

    preds_all, labels_all = [], []
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16,
                                         enabled=dev.type == "cuda"):
        for imgs, labels, valid in BatchIterator(
            val_ds, batch_size or cfg.train.batch_size, shuffle=False
        ):
            logits = model(normalize(torch.from_numpy(imgs).to(dev))).cpu()
            n = int(valid.sum())
            preds_all.append(np.argmax(logits[:n].numpy(), axis=-1))
            labels_all.append(labels[:n])
    preds = np.concatenate(preds_all) if preds_all else np.zeros((0,), np.int64)
    labels = np.concatenate(labels_all) if labels_all else np.zeros((0,), np.int64)

    report = classification_report(labels, preds, cfg.model.num_classes)
    log.info("Validation accuracy: %.4f", report["accuracy"])
    return report
