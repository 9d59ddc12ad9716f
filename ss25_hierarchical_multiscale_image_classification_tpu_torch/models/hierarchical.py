"""Hierarchical multiscale patch classifier.

Counterpart of the JAX package's ``models/hierarchical.py``
(``HierarchicalPatchClassifier``). The levels of one location (patch sizes
1792/896/448/224 at levels 0-3 cover the same level-0 field of view) are
classified together: a **shared** ResNet18 trunk runs on every scale with
the scale axis folded into the batch (one S·B trunk call instead of S calls
of B), a learned per-scale embedding is added to the pooled features, and a
fusion head gives the logits: ``concat`` (the S·512 features into
``head_hidden``) or ``attention`` (softmax weights over the scales from
``attn_v`` → tanh → ``attn_w``). The shared ``aux_head`` gives each scale's
own logits (deep supervision in training, the per-level ensemble at
inference); artifacts from before the aux heads have none.

Parameter names follow the flax module (``trunk.*`` in torchvision layout,
``scale_embed``, ``head_hidden``, ``head_out``, ``aux_head``, ``attn_v``,
``attn_w``); :func:`..models.convert.hierarchical_state_dict_from_flax`
carries a JAX artifact across.

The dtype chain is the JAX module's: the trunk gives float32 pooled
features, ``scale_embed`` (kept in float32, the JAX ``param_dtype``) is cast
to the features' dtype and added, the heads run in the model dtype (the
heads' parameters' dtype), the attention softmax runs in float32 and its
weights are cast back to the features' dtype for the weighted sum, and the
logits come out in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
    ResNet18FeatureExtractor,
)

FEATURE_DIM = 512


class HierarchicalPatchClassifier(nn.Module):
    """Multiscale fusion classifier.

    ``forward`` takes ``{level: (B, S, S, 3)}`` co-located patches, already
    normalized and at the trunk's input size, and gives (B, num_classes)
    float32 logits (and (B, levels, num_classes) per-scale logits with
    ``with_aux``). ``aux=False`` builds the module of an artifact without
    aux heads. Parameters are drawn from ``generator`` (seed 0 when none is
    given) with the flax initialisers: ``scale_embed`` normal(0.02), Dense
    kernels LeCun-normal, biases zero.
    """

    def __init__(
        self,
        levels: Sequence[int] = (2, 3),
        num_classes: int = 2,
        fusion: str = "concat",
        fusion_hidden_dim: int = 256,
        aux: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if fusion not in ("concat", "attention"):
            raise ValueError(f"unknown fusion {fusion!r}")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.levels = tuple(levels)
        self.fusion = fusion
        s = len(self.levels)
        self.trunk = ResNet18FeatureExtractor(generator=g)
        self.scale_embed = nn.Parameter(
            torch.empty(s, FEATURE_DIM).normal_(0.0, 0.02, generator=g))

        def dense(n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
            # built empty, then filled: PyTorch's global generator stays
            # untouched
            layer = nn.Linear(n_in, n_out, bias=bias,
                              device="meta").to_empty(device="cpu")
            with torch.no_grad():
                layer.weight.normal_(0.0, 1.0 / math.sqrt(n_in), generator=g)
                if bias:
                    layer.bias.zero_()
            return layer

        self.attn_v = self.attn_w = None
        if fusion == "attention":
            self.attn_v = dense(FEATURE_DIM, fusion_hidden_dim)
            self.attn_w = dense(fusion_hidden_dim, 1, bias=False)
            fused = FEATURE_DIM
        else:
            fused = s * FEATURE_DIM
        self.head_hidden = dense(fused, fusion_hidden_dim)
        self.head_out = dense(fusion_hidden_dim, num_classes)
        self.aux_head = dense(FEATURE_DIM, num_classes) if aux else None
        self.eval()

    @property
    def dtype(self) -> torch.dtype:
        """The heads' compute dtype."""
        return self.head_out.weight.dtype

    def for_inference(self, device: str | torch.device,
                      dtype: torch.dtype) -> "HierarchicalPatchClassifier":
        """On ``device`` in eval mode with the trunk (channels_last) and the
        heads in ``dtype``; ``scale_embed`` stays float32."""
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        self.scale_embed.data = self.scale_embed.data.float()
        return self.eval()

    def forward(self, patches_by_level: dict, with_aux: bool = False):
        levels = sorted(patches_by_level)
        if list(levels) != sorted(self.levels):
            raise ValueError(
                f"expected levels {sorted(self.levels)}, got {levels}")
        b = patches_by_level[levels[0]].shape[0]
        parts = [patches_by_level[lvl] for lvl in levels]
        if not torch.is_autocast_enabled(parts[0].device.type):
            # one rounding to the trunk's dtype, as the trunk's own cast
            dt = self.trunk.conv1.weight.dtype
            parts = [p.to(dt) for p in parts]
        # fold scales into the batch: ONE trunk call on (S·B, H, W, 3)
        feats = self.trunk(torch.cat(parts))  # (S·B, 512) float32
        feats = feats.reshape(len(levels), b, -1).transpose(0, 1)  # (B, S, 512)
        if with_aux:
            return self.fuse(feats), self.aux_logits(feats)
        return self.fuse(feats)

    def aux_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, S, 512) pooled per-scale features → (B, S, num_classes)
        per-scale float32 logits (the single-magnification opinions that the
        ensemble averages with the fusion head)."""
        if self.aux_head is None:
            raise ValueError("this classifier has no aux heads")
        e = feats + self.scale_embed[None].to(feats.dtype)
        return self.aux_head(e.to(self.dtype)).float()

    def base_aux_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, 512) pooled trunk features of the BASE level → its aux
        logits: the sorted index −1 scale embedding and the shared aux
        head (the cascade's screen)."""
        if self.aux_head is None:
            raise ValueError("this classifier has no aux heads")
        e = feats + self.scale_embed[-1][None].to(feats.dtype)
        return self.aux_head(e.to(self.dtype)).float()

    def fuse(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, S, 512) pooled per-scale features → (B, num_classes) float32
        logits: everything after the shared trunk, so that the int8 path can
        run the trunk quantized and the heads here."""
        b, s = feats.shape[0], feats.shape[1]
        feats = feats + self.scale_embed[None].to(feats.dtype)
        if self.fusion == "attention":
            a = self.attn_w(torch.tanh(self.attn_v(feats.to(self.dtype))))
            attn = torch.softmax(a[..., 0].float(), dim=-1)
            fused = torch.einsum("bs,bsd->bd", attn.to(feats.dtype), feats)
        else:
            fused = feats.reshape(b, s * feats.shape[2])
        x = torch.relu(self.head_hidden(fused.to(self.dtype)))
        return self.head_out(x).float()
