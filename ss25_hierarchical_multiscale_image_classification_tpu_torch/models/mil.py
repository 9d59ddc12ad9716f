"""Attention-MIL bag classifier with masked, shape-static bags.

Counterpart of the JAX package's ``models/mil.py``: attention pooling
``softmax(w · tanh(V h))`` over a bag's instances (or masked mean or max
pooling), then an MLP head with dropout. Bags are padded to a static size
with a boolean mask; padded slots get the logit −1e9 before the softmax.

The functions below take the classifier's state dict (``params``) in place
of the flax params tree, and a ``torch.Generator`` in place of a JAX key.
:func:`streaming_attention_pool` pools through the hand-written kernel of
``ops/mil_pool.py``; :func:`sharded_attention_pool` pools a bag whose
instances are spread over the ranks of a process group.

State-dict names: ``attention.V`` and ``attention.w`` (flax
``MILAttentionPooling_0/V`` and ``/w``), ``dense_0`` and ``dense_1``
(flax ``Dense_0`` and ``Dense_1``); ``models/convert.py`` maps them.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.mil_pool import (
    mil_attention_pool,
)

_NEG_INF = -1e9
# flax's lecun_normal: a normal truncated at ±2 standard deviations, whose
# scale is divided by this (the truncated unit normal's standard deviation)
# so that the samples keep the variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``Dense`` initialisation: LeCun-normal weight, zero bias."""
    std = 1.0 / math.sqrt(layer.in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """flax ``nn.Dropout`` in training mode: keep each value with
    probability ``1 − rate`` (keep mask from ``generator``) and scale the
    kept ones by ``1 / (1 − rate)``."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class MILAttentionPooling(nn.Module):
    """Attention pooling: a = softmax(w · tanh(V h)), bag = Σ a_k h_k."""

    def __init__(self, input_dim: int, hidden_dim: int = 128):
        super().__init__()
        self.V = nn.Linear(input_dim, hidden_dim)
        self.w = nn.Linear(hidden_dim, 1, bias=False)

    def forward(self, h: torch.Tensor, mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """h: (..., K, D) instances; mask: (..., K) bool, True = real.

        Returns (bag (..., D), attention (..., K))."""
        a = self.w(torch.tanh(self.V(h)))[..., 0]
        if mask is not None:
            a = torch.where(mask, a, _NEG_INF)
        attn = torch.softmax(a.float(), dim=-1)
        bag = torch.einsum("...k,...kd->...d", attn.to(h.dtype), h)
        return bag, attn


def mean_pool(h: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked mean pooling over the instance axis."""
    if mask is None:
        return h.mean(dim=-2)
    m = mask.to(h.dtype)[..., None]
    return (h * m).sum(dim=-2) / torch.clamp_min(m.sum(dim=-2), 1.0)


def max_pool(h: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked max pooling over the instance axis."""
    if mask is not None:
        h = torch.where(mask[..., None], h, _NEG_INF)
    return h.amax(dim=-2)


class MILClassifier(nn.Module):
    """Bag classifier: pooling ∈ {attention, mean, max} + MLP
    D → head_hidden_dim → ReLU → dropout → num_classes.

    flax infers the instance width at ``init``; here it is ``input_dim``.
    Linear layers start as flax's (LeCun-normal, zero bias) from
    ``generator`` (seed 0 when none is given)."""

    def __init__(self, input_dim: int = 512, num_classes: int = 2,
                 attention_hidden_dim: int = 128, head_hidden_dim: int = 128,
                 pooling: str = "attention", dropout_rate: float = 0.25,
                 generator: torch.Generator | None = None):
        super().__init__()
        if pooling not in ("attention", "mean", "max"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.pooling = pooling
        self.dropout_rate = dropout_rate
        if pooling == "attention":
            self.attention = MILAttentionPooling(input_dim, attention_hidden_dim)
        self.dense_0 = nn.Linear(input_dim, head_hidden_dim)
        self.dense_1 = nn.Linear(head_hidden_dim, num_classes)
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(0))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m, generator)
        self.eval()

    def forward(self, bags: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """bags: (B, K, D) padded instance features; mask: (B, K) bool.
        ``train`` turns dropout on, with keep masks from ``generator``.

        Returns (logits (B, num_classes) float32, attention (B, K) or None)."""
        attn = None
        if self.pooling == "attention":
            pooled, attn = self.attention(bags, mask)
        elif self.pooling == "mean":
            pooled = mean_pool(bags, mask)
        else:
            pooled = max_pool(bags, mask)
        x = torch.relu(self.dense_0(pooled))
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.dense_1(x).float(), attn


def attention_params(params: Mapping[str, torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V (D, H), V bias (H,), w (H,)) of a ``MILClassifier`` state dict, in
    the JAX layout that the kernel takes."""
    return (params["attention.V.weight"].T, params["attention.V.bias"],
            params["attention.w.weight"][0])


def attention_weights(params: Mapping[str, torch.Tensor], h: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-instance attention ``softmax(w · tanh(h V + b))`` over the bag
    axis (masked), in plain PyTorch: the streaming path's attention map."""
    v, vb, w = attention_params(params)
    a = torch.tanh(h.float() @ v.float() + vb.float()) @ w.float()
    if mask is not None:
        a = torch.where(mask, a, _NEG_INF)
    return torch.softmax(a, dim=-1)


def apply_head(params: Mapping[str, torch.Tensor], pooled: torch.Tensor,
               dropout_rate: float = 0.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """MLP head of ``MILClassifier`` on externally pooled bags (..., D):
    Dense → ReLU → [dropout] → Dense. ``generator`` turns dropout on (the
    MC-dropout sampling path: pooling is deterministic, so sampling re-runs
    only the head)."""
    x = pooled.float() @ params["dense_0.weight"].float().T + params["dense_0.bias"]
    x = torch.relu(x)
    if generator is not None and dropout_rate > 0.0:
        x = dropout(x, dropout_rate, generator)
    return (x @ params["dense_1.weight"].float().T + params["dense_1.bias"]).float()


def streaming_attention_pool(params: Mapping[str, torch.Tensor],
                             h: torch.Tensor, mask: torch.Tensor,
                             block_k: int = 512) -> torch.Tensor:
    """Attention-pool padded bags (B, K, D) through the streaming kernel
    (``ops/mil_pool.py``; the plain version for CPU tensors).

    The bags are zero-padded (mask False) up to a multiple of
    ``min(block_k, K)``, as the JAX function pads for its Pallas blocks.
    The kernel needs no padding, but a bag without a real instance pools to
    the mean of all its rows, padding included, so the padding is kept for
    the two packages to agree there.
    """
    b, k, d = h.shape
    block_k = min(block_k, k)
    pad = (-k) % block_k
    if pad:
        h = torch.cat([h, h.new_zeros(b, pad, d)], dim=1)
        mask = torch.cat([mask, mask.new_zeros(b, pad)], dim=1)
    v, vb, w = attention_params(params)
    return mil_attention_pool(h, mask, v, w, v_bias=vb)


def sharded_attention_pool(h_local: torch.Tensor, mask_local: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor,
                           v_bias: torch.Tensor | None = None,
                           group=None) -> torch.Tensor:
    """Attention pooling of a bag whose instances are sharded over the ranks
    of ``group``: this rank's (K_local, D) instances and (K_local,) mask,
    V (D, H), w (H,), optional V bias (H,) → the (D,) pooled bag, the same
    on every rank. The JAX function's two-phase collective: the global
    maximum of the scores, then the normaliser and the weighted feature sum
    over the group, in plain PyTorch (as in JAX, not the kernel), so no
    rank holds the whole bag.

    ``p`` is weighted by the mask, so a bag without a real instance pools to
    0 here, where the unsharded pool gives the mean of its rows. Without a
    group the local instances are the bag.
    """
    a = torch.tanh(h_local.float() @ v.float()
                   + (0.0 if v_bias is None else v_bias.float())) @ w.float()
    a = torch.where(mask_local, a, _NEG_INF)
    m = a.max()
    if group is not None:
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            all_reduce_max,
        )

        m = all_reduce_max(m, group)
    p = torch.exp(a - m) * mask_local.float()
    # the normaliser and the weighted sum in one collective
    parts = torch.cat([p.sum()[None], p @ h_local.float()])
    if group is not None:
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            all_reduce_sum,
        )

        parts = all_reduce_sum(parts, group)
    return parts[1:] / torch.clamp_min(parts[0], 1e-30)


def pad_bag(features: np.ndarray, max_bag_size: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """Pad (K, D) instance features to (max_bag_size, D) + mask. Oversized
    bags are cut by a uniform stride, so spatial coverage is kept rather
    than dropping the tail."""
    k, d = features.shape
    mask = np.zeros((max_bag_size,), bool)
    if k > max_bag_size:
        # the gathered rows are the whole output: nothing to pad or copy
        idx = np.linspace(0, k - 1, max_bag_size).astype(np.int64)
        mask[:] = True
        return features[idx], mask
    out = np.zeros((max_bag_size, d), features.dtype)
    out[:k] = features
    mask[:k] = True
    return out, mask
