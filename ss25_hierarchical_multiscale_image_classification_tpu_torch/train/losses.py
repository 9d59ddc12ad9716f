"""Classification losses and class-weight schemes.

Counterpart of the JAX package's ``train/losses.py``
(``weighted_cross_entropy``, ``accuracy``, ``class_weights_inv_min``,
``class_weights_total_over_count``). The default trainer weights classes
by ``(1/count)/min(1/count)``, the strategy trainer by ``total/count``.
"""

from __future__ import annotations

import numpy as np
import torch


def _counts(labels: np.ndarray, num_classes: int) -> np.ndarray:
    return np.array([max(int((labels == c).sum()), 1)
                     for c in range(num_classes)], np.float64)


def class_weights_inv_min(labels: np.ndarray, num_classes: int = 2
                          ) -> np.ndarray:
    """``(1/count)/min(1/count)`` per class, float32 (a class without rows
    counts as one)."""
    w = 1.0 / _counts(labels, num_classes)
    return (w / w.min()).astype(np.float32)


def class_weights_total_over_count(labels: np.ndarray, num_classes: int = 2
                                   ) -> np.ndarray:
    """``total/count`` per class, float32."""
    return (len(labels) / _counts(labels, num_classes)).astype(np.float32)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights=None,
                           valid: torch.Tensor | None = None,
                           group=None) -> torch.Tensor:
    """Per-class-weighted softmax cross entropy with torch
    ``CrossEntropyLoss(weight=...)`` normalisation: ``Σ w_{y_i} ℓ_i /
    Σ w_{y_i}`` (a weighted mean), with padded batch rows (``valid`` 0)
    weighted 0.

    Args:
        logits: (B, C) float.
        labels: (B,) int.
        class_weights: (C,) float or None (plain mean).
        valid: (B,) {0,1} mask for padded batch rows.
        group: process group whose ranks hold the other rows of the global
            batch: the value is the global batch's loss on every rank, and
            the gradient this rank's share, its rows' weighted sum over the
            **global** weight sum (ranks whose wrap-padded rows leave them
            fewer valid rows weigh less, as in the global mean).
    Returns:
        scalar loss.
    """
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    log_probs = (shifted.gather(1, labels.long()[:, None])[:, 0]
                 - torch.log(torch.exp(shifted).sum(dim=-1)))
    nll = -log_probs  # (B,)
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=torch.float32,
                            device=logits.device)[labels.long()]
    else:
        w = torch.ones_like(nll)
    if valid is not None:
        w = w * valid.float()
    if group is None:
        return (w * nll).sum() / torch.clamp_min(w.sum(), 1e-8)
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        sum_of_shares,
    )

    total = all_reduce_sum(w.sum().detach(), group)
    return sum_of_shares((w * nll).sum() / torch.clamp_min(total, 1e-8), group)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    correct = (logits.argmax(dim=-1) == labels).float()
    if valid is None:
        return correct.mean()
    v = valid.float()
    return (correct * v).sum() / torch.clamp_min(v.sum(), 1.0)
