"""Train state: a model on its device and its Adam optimizer.

Counterpart of the JAX package's ``train/state.py::create_train_state``.
flax keeps parameters, batch statistics, optimizer state and the update
count ``step`` in one immutable ``TrainState``; here the model holds its
parameters and BN running statistics (updated in place by training-mode
forwards), the optimizer its moments, and ``step`` counts the updates that
the train steps applied (what a train-state checkpoint restores). optax's ``adam`` defaults (b1 0.9, b2 0.999, eps 1e-8
outside the square root) are ``torch.optim.Adam``'s. On the card the update
is Adam's ``fused=True`` step, one library kernel over all parameters.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, learning_rate: float,
                       device: torch.device) -> TrainState:
    """Move ``model`` to ``device`` (float32 parameters, ``channels_last``
    convolutions) in training mode and give it ``Adam(learning_rate)``."""
    model.to(device=device, memory_format=torch.channels_last)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           fused=device.type == "cuda")
    return TrainState(model, opt)
