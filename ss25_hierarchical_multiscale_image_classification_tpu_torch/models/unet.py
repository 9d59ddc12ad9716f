"""UNet (segmentation trunk + classification variant).

Counterpart of the JAX package's ``models/unet.py`` (``center_crop``,
``_DoubleConv``, ``UNet``, ``UNetClassifier``): an encoder/decoder UNet with
center-crop skip concatenation (``padding="SAME"``, or ``"VALID"`` for the
reference's valid-convolution topology) and the classification head on the
last decoder feature map (global average pool → Linear). Legacy code: no
CLI path reaches it, as in the JAX package.

Public layout is NHWC, as in the JAX package; the convolutions run NCHW
through ``permute`` views (``channels_last`` memory). Parameters start from
flax's default initialisers (LeCun-normal kernels truncated at two standard
deviations, zero biases) drawn from ``generator``; JAX weights arrive
through ``models/convert.py::unet_state_dict_from_flax``. The compute
dtype is the parameters'.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: flax's ``truncated_normal`` draws at ±2 and rescales by this to keep the
#: requested standard deviation.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default ``lecun_normal`` kernels (fan in = the input
    channels times the taps) and zero biases for every Conv2d,
    ConvTranspose2d and Linear of ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            taps = math.prod(m.weight.shape[2:])
            fan_in = (m.in_channels if isinstance(m, (nn.Conv2d,
                                                      nn.ConvTranspose2d))
                      else m.in_features) * taps
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def center_crop(x: torch.Tensor, target_h: int, target_w: int
                ) -> torch.Tensor:
    """Center-crop NHWC to (target_h, target_w), the skip connection's
    crop."""
    h, w = x.shape[1], x.shape[2]
    dy = (h - target_h) // 2
    dx = (w - target_w) // 2
    return x[:, dy:dy + target_h, dx:dx + target_w, :]


class _DoubleConv(nn.Module):
    """Two 3×3 convolutions with bias, each followed by ReLU."""

    def __init__(self, in_ch: int, filters: int, padding: str):
        super().__init__()
        pad = {"SAME": 1, "VALID": 0}[padding]
        self.conv0 = nn.Conv2d(in_ch, filters, 3, padding=pad)
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class _UNetTrunk(nn.Module):
    """The encoder, the bottleneck and the decoder: NCHW in, the last
    decoder map (B, features[0], H', W') out."""

    def __init__(self, features: Sequence[int], bottleneck: int,
                 padding: str):
        super().__init__()
        self.down = nn.ModuleList()
        ch = 3
        for f in features:
            self.down.append(_DoubleConv(ch, f, padding))
            ch = f
        self.bottleneck = _DoubleConv(ch, bottleneck, padding)
        ch = bottleneck
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        for f in reversed(features):
            self.up.append(nn.ConvTranspose2d(ch, f, 2, stride=2))
            self.dec.append(_DoubleConv(2 * f, f, padding))
            ch = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for up, dec, skip in zip(self.up, self.dec, reversed(skips)):
            x = up(x)
            skip = center_crop(skip.permute(0, 2, 3, 1), x.shape[2],
                               x.shape[3]).permute(0, 3, 1, 2)
            x = dec(torch.cat([skip, x], dim=1))
        return x


def _nchw(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    w = next(model.parameters())
    if not torch.is_autocast_enabled(x.device.type):
        x = x.to(w.dtype)
    return x


class UNet(nn.Module):
    """Encoder/decoder UNet: (B, H, W, 3) → per-pixel float32 logits
    (B, H', W', out_channels); H' = H with ``"SAME"`` padding."""

    def __init__(self, out_channels: int = 2,
                 features: Sequence[int] = (64, 128, 256, 512),
                 bottleneck_features: int = 1024, padding: str = "SAME",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = _UNetTrunk(tuple(features), bottleneck_features,
                                padding)
        self.head = nn.Conv2d(features[0], out_channels, 1)
        lecun_init_(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.head(self.trunk(_nchw(self, x)))
        return y.permute(0, 2, 3, 1).float()


class UNetClassifier(nn.Module):
    """UNet trunk (``"SAME"``, bottleneck 2·features[-1]) + global average
    pool + Linear head: (B, H, W, 3) → float32 (B, num_classes)."""

    def __init__(self, num_classes: int = 200,
                 features: Sequence[int] = (64, 128, 256, 512),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = _UNetTrunk(tuple(features), features[-1] * 2, "SAME")
        self.head = nn.Linear(features[0], num_classes)
        lecun_init_(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.trunk(_nchw(self, x)).mean(dim=(2, 3))
        return self.head(y).float()
