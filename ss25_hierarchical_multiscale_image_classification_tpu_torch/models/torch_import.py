"""torchvision's ImageNet-pretrained ResNet18 as the classifier's warm start.

Counterpart of the JAX package's ``models/torch_import.py::
load_pretrained_resnet18``: the reference starts its classifier from
torchvision's ImageNet weights. The port reads them only from a file
already on disk, ``~/.cache/torch/hub/checkpoints/resnet18-f37072fd.pth``
(torchvision's cache), and never downloads: without the file it returns
None and training starts from He init. The port's ResNet keeps torchvision's
parameter names, so the state dict maps onto it as it is.
"""

from __future__ import annotations

import os

import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("models.torch_import")

_TORCHVISION_CACHE = os.path.join("~", ".cache", "torch", "hub", "checkpoints")
_RESNET18_WEIGHTS = "resnet18-f37072fd.pth"


def pretrained_path() -> str:
    return os.path.join(os.path.expanduser(_TORCHVISION_CACHE),
                        _RESNET18_WEIGHTS)


def load_pretrained_resnet18(include_head: bool = False
                             ) -> dict[str, torch.Tensor] | None:
    """The ImageNet-pretrained state dict (the trunk; with
    ``include_head`` also torchvision's 1000-way ``fc``) when the
    torchvision checkpoint is on disk, else None (→ He init). Never touches
    the network."""
    path = pretrained_path()
    if not os.path.exists(path):
        log.warning(
            "No local torchvision ResNet18 weights (%s); using He init. "
            "The reference's pretrained-init semantics apply when the file "
            "is present.", path,
        )
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items()
            if include_head or not k.startswith("fc.")}
