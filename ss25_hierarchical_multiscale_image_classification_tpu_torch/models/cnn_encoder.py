"""ResNet50-based instance encoder for the MIL track.

Counterpart of the JAX package's ``models/cnn_encoder.py``: a ResNet50
trunk (``models/resnet.py::ResNet50`` without its head) projected
2048 → ``feature_dim``. With ``freeze_trunk`` (the default) the trunk's
BatchNorm stays in eval mode under ``train()`` and its output is detached,
so no gradient reaches it, as ``jax.lax.stop_gradient`` cuts it there.
Legacy code: no CLI path reaches it, as in the JAX package. Input NHWC
(B, H, W, 3) normalized images, output float32 (B, feature_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet50,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.unet import (
    lecun_init_,
)


class CNNEncoder(nn.Module):
    def __init__(self, feature_dim: int = 512, freeze_trunk: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.feature_dim = feature_dim
        self.freeze_trunk = freeze_trunk
        self.trunk = ResNet50(num_classes=None, generator=generator)
        self.projection = nn.Linear(2048, feature_dim)
        lecun_init_(self.projection, generator)
        self.eval()

    def train(self, mode: bool = True) -> "CNNEncoder":
        super().train(mode)
        if self.freeze_trunk:
            self.trunk.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.trunk(x)
        if self.freeze_trunk:
            h = h.detach()
        w = self.projection.weight
        if not torch.is_autocast_enabled(h.device.type):
            h = h.to(w.dtype)
        return self.projection(h).float()

    def get_feature_dimension(self) -> int:
        return self.feature_dim
