"""Uncertainty estimation: softmax thresholding and MC dropout.

Counterpart of the JAX package's ``evaluation/uncertainty.py``. MC dropout
runs as one batched forward over the samples (the inputs repeated along the
batch axis), not a Python loop of passes; its keep masks come from a passed
``torch.Generator`` where JAX splits a key.
"""

from __future__ import annotations

from typing import Callable

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    UncertaintyConfig,
)

_DEFAULTS = UncertaintyConfig()


def softmax_thresholding(logits, threshold: float = _DEFAULTS.softmax_threshold
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Predictions gated on confidence.

    Returns (preds (B,), probs (B, C), confident (B,) bool): ``preds`` is the
    argmax; ``confident`` marks rows whose max probability ≥ threshold.
    """
    probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float32), dim=-1)
    preds = probs.argmax(dim=-1)
    confident = probs.amax(dim=-1) >= threshold
    return preds, probs, confident


def monte_carlo_dropout(
    apply_fn: Callable[[torch.Tensor, torch.Generator], object],
    inputs: torch.Tensor,
    generator: torch.Generator,
    n_samples: int = _DEFAULTS.monte_carlo_samples,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MC-dropout predictive mean and (population) variance.

    Args:
        apply_fn: ``apply_fn(x, generator)`` → logits, or a tuple whose first
            item is the logits, of a batch ``x`` with stochastic dropout on,
            its keep masks drawn from ``generator``.
        inputs: (B, ...) batch; it is repeated ``n_samples`` times along the
            batch axis and passed to ``apply_fn`` once.
        generator: source of the dropout masks.
        n_samples: stochastic forward passes.

    Returns:
        (mean_probs (B, C), var_probs (B, C)).
    """
    b = inputs.shape[0]
    x = inputs.repeat(n_samples, *([1] * (inputs.dim() - 1)))  # (S·B, ...)
    out = apply_fn(x, generator)
    logits = out[0] if isinstance(out, tuple) else out
    probs = torch.softmax(logits.float(), dim=-1).reshape(n_samples, b, -1)
    return probs.mean(dim=0), probs.var(dim=0, correction=0)
