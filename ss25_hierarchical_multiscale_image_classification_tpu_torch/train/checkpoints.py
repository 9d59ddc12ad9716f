"""Model artifacts and train-state checkpoints on disk.

Counterpart of the JAX package's ``train/checkpoints.py``
(``CheckpointManager``, ``save_model``, ``load_model``,
``model_artifact_path``). The JAX package writes orbax checkpoints; the
port writes ``torch.save`` files:

- a model artifact is a state dict at ``<models_dir>/<name>.pt``, the file
  its CLI loads;
- a train-state checkpoint (:class:`CheckpointManager`) holds the model's
  state dict (BN buffers included), the optimizer's state dict and the
  update count, one file a step under the manager's directory, for a
  resume that continues where the run stopped. As in the JAX package, the
  augmentation's random stream is not part of it.
"""

from __future__ import annotations

import os
import re

import torch

SUFFIX = ".pt"
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


class CheckpointManager:
    """Step-indexed train-state checkpoints (``<directory>/ckpt_<step>.pt``),
    the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = _abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        """The steps on disk, ascending."""
        return sorted(int(m.group(1)) for m in map(_CKPT_RE.match,
                                                  os.listdir(self.directory))
                      if m)

    def save(self, step: int, state) -> None:
        """Write ``state`` (a ``train/state.py::TrainState``) as ``step``,
        through a temporary file, then drop the oldest beyond
        ``max_to_keep``."""
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step)}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, target, step: int | None = None):
        """Load checkpoint ``step`` (default the latest) into ``target``, a
        ``TrainState`` whose model and optimizer have the saved shapes, in
        place: tensors land on the model's device. Returns ``target``, or
        None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        dev = next(target.model.parameters()).device
        ckpt = torch.load(self._path(step), map_location=dev,
                          weights_only=True)
        target.model.load_state_dict(ckpt["model"])
        target.optimizer.load_state_dict(ckpt["optimizer"])
        target.step = int(ckpt["step"])
        return target

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""


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
