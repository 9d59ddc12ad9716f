"""Generic image-classification harness.

Counterpart of the JAX package's ``train/generic_classifier.py``: a
dataset from arrays with the 70/15/15 train/val/test split
(:class:`ArrayDataset`, drawn exactly as there), and train/eval loops for
any port image classifier ``model(x) → logits`` on NHWC float images in
[0, 1] (``UNetClassifier``, ``ResNet``, …): Adam on the unweighted cross
entropy, batches shuffled by ``np.random.default_rng(seed + epoch)`` with
the short tail dropped. The JAX package's StableHLO export becomes
:meth:`GenericClassifierTrainer.export`: ``torch.export`` of the eval-mode
model, saved with ``torch.export.save`` (``torch.export.load(path)
.module()`` runs it). Legacy code: no CLI path reaches it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
    weighted_cross_entropy,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)

log = get_logger("train.generic")


@dataclasses.dataclass
class ArrayDataset:
    """Images (N, H, W, 3) uint8 + labels (N,), split 70/15/15."""

    train_x: np.ndarray
    train_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray

    @classmethod
    def from_arrays(
        cls, images: np.ndarray, labels: np.ndarray, seed: int = 0
    ) -> "ArrayDataset":
        n = len(images)
        order = np.random.default_rng(seed).permutation(n)
        n_train = int(n * 0.7)
        n_val = int(n * 0.15)
        tr = order[:n_train]
        va = order[n_train : n_train + n_val]
        te = order[n_train + n_val :]
        return cls(
            images[tr], labels[tr], images[va], labels[va], images[te], labels[te]
        )


class GenericClassifierTrainer:
    """Train/evaluate any port classifier ``model(x) → logits`` on
    ``device`` (``input_shape``: one batch's NHWC shape, the export's
    example)."""

    def __init__(self, model: torch.nn.Module, input_shape, num_classes: int,
                 learning_rate: float = 1e-3,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.input_shape = tuple(input_shape)
        self.num_classes = num_classes
        self.state = create_train_state(model, learning_rate, self.device)
        self.model = self.state.model

    def _x(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(images, np.float32) / 255.0).to(self.device)

    def train_step(self, x: torch.Tensor, y: torch.Tensor):
        """One Adam step on a batch: (loss, accuracy), device scalars."""
        self.model.train()
        self.state.optimizer.zero_grad(set_to_none=True)
        logits = self.model(x)
        loss = weighted_cross_entropy(logits, y)
        loss.backward()
        self.state.optimizer.step()
        self.state.step += 1
        return loss.detach(), (logits.argmax(-1) == y).float().mean()

    def fit(self, ds: ArrayDataset, epochs: int = 5, batch_size: int = 64,
            seed: int = 0) -> list[dict]:
        history = []
        n = len(ds.train_x)
        for epoch in range(epochs):
            order = np.random.default_rng(seed + epoch).permutation(n)
            total, steps = 0.0, 0
            for start in range(0, n - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                y = torch.from_numpy(np.asarray(ds.train_y[idx], np.int64))
                loss, _acc = self.train_step(self._x(ds.train_x[idx]),
                                             y.to(self.device))
                total += float(loss)
                steps += 1
            val_acc = self.evaluate(ds.val_x, ds.val_y, batch_size)
            history.append(
                {"epoch": epoch, "loss": total / max(steps, 1), "val_acc": val_acc}
            )
            log.info("epoch %d: loss %.4f val_acc %.4f", epoch,
                     history[-1]["loss"], val_acc)
        return history

    @torch.no_grad()
    def evaluate(self, images, labels, batch_size: int = 64) -> float:
        self.model.eval()
        correct, count = 0.0, 0
        for start in range(0, len(images), batch_size):
            x = self._x(images[start : start + batch_size])
            y = torch.from_numpy(
                np.asarray(labels[start : start + batch_size], np.int64))
            logits = self.model(x).cpu()
            correct += float((logits.argmax(-1) == y).sum())
            count += len(y)
        return correct / max(count, 1)

    def export(self, path: str, input_shape=None) -> None:
        """Save the eval-mode model as a ``torch.export`` program (example
        input: float32 ``input_shape``, default the trainer's) with
        ``torch.export.save``."""
        self.model.eval()
        example = torch.zeros(tuple(input_shape or self.input_shape),
                              dtype=torch.float32, device=self.device)
        program = torch.export.export(self.model, (example,))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.export.save(program, path)
        log.info("exported torch.export program to %s", path)
