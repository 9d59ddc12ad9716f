"""Model artifacts: state dicts on disk.

Counterpart of the JAX package's ``train/checkpoints.py`` (``save_model``,
``load_model``, ``model_artifact_path``). The JAX package writes orbax
checkpoints; the port writes ``torch.save`` of a state dict to
``<models_dir>/<name>.pt``, the file its CLI loads. Full train-state
checkpoints for resuming come with the classifier trainer.
"""

from __future__ import annotations

import os

import torch

SUFFIX = ".pt"


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def save_model(path: str, state_dict: dict[str, torch.Tensor]) -> None:
    """Write ``state_dict`` (moved to the CPU) to ``path`` + ``.pt``."""
    path = _abspath(path) + SUFFIX
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_model(path: str) -> dict[str, torch.Tensor]:
    """The state dict that :func:`save_model` wrote for ``path``."""
    return torch.load(_abspath(path) + SUFFIX, map_location="cpu",
                      weights_only=True)


def model_artifact_path(models_dir: str, name: str) -> str:
    """Artifact names of the reference, without the extension:
    ``resnet18_patch_classifier``, ``simclr_encoder`` ..."""
    return os.path.join(models_dir, name)
