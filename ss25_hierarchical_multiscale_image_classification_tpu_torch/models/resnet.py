"""The ResNet family in PyTorch, in torchvision state-dict layout.

Counterpart of the JAX package's ``models/resnet.py`` (``BasicBlock``,
``Bottleneck``, ``ResNet``, ``ResNet18Classifier``,
``ResNet18FeatureExtractor``, ``UnifiedResNet``, ``ResNet50``,
``strip_head``, ``merge_trunk``). Parameter names follow torchvision
(``conv1``, ``bn1``, ``layer{1..4}.{j}.conv1/bn1/conv2/bn2[/conv3/bn3]/
downsample.{0,1}``, ``fc``), so reference ``.pth`` checkpoints load with
``load_state_dict`` and JAX weights arrive through
:func:`..models.convert.state_dict_from_flax`. ResNet50 (Bottleneck, the
MIL track's encoder trunk, ``models/cnn_encoder.py``) is legacy code that
no CLI path reaches, as in the JAX package.

Semantics kept from the JAX model:

- 3×3 convs pad (1, 1) symmetrically, at stride 2 too (``nn.Conv2d``'s
  ``padding=1``; the JAX model spells it out because SAME would pad (0, 1));
- the stem maxpool pads with −inf (``nn.MaxPool2d`` does);
- eval-mode BatchNorm at ``eps=1e-5`` with the stored running statistics;
- training-mode BatchNorm with flax's running statistics (:class:`BatchNorm2d`);
  the stem's training BatchNorm, ReLU and maxpool run on the card as one
  function over hand-written kernels (``ops/stem_train.py``);
- ``frozen_bn=True``: BatchNorm normalizes with the stored running
  statistics in training mode too and leaves them as they are, while γ and
  β still train (every BN layer stays in eval mode inside a model that is
  otherwise in training mode);
- the classifier returns float32 logits, the feature extractor float32
  (B, 8·num_filters) pooled features.

Public layout is NHWC, as in the JAX package: ``forward`` takes (B, H, W, 3)
and runs NCHW through a ``permute`` view, which for a contiguous NHWC tensor
is already ``channels_last`` in memory. The compute dtype is the parameters'
dtype: float32 in the CPU tests, bfloat16 on the card (the JAX default
``dtype=jnp.bfloat16``), set with ``model.to(dtype=...)`` for inference.
Training keeps float32 parameters and runs under
``torch.autocast("cuda", torch.bfloat16)``, which then sets the compute
dtype.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.stem_train import (
    stem_train,
    stem_train_refusal,
)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training mode keeps flax's running statistics.

    Both normalize a training batch with its own mean and biased variance.
    They differ in the running statistics: flax moves them by
    ``momentum`` (0.1 here, flax's 0.9 from the other side) toward the
    batch mean and the **biased** variance, PyTorch toward the unbiased one,
    which at a 1×1 layer4 over a batch of 4 is a third larger. Here
    ``F.batch_norm`` hands this batch's mean and unbiased variance to two
    temporaries (momentum 1 from zero), and the update uses the variance
    times (n−1)/n. Every row of the batch counts, wrap-padded ones too, as
    in the JAX model. Eval mode is ``nn.BatchNorm2d``'s.

    With a process ``group`` (:func:`set_process_group`), a training batch
    is normalized with the statistics of the **global** batch, every rank's
    rows together, as the JAX trainers' SPMD step computes them, with the
    biased variance over the global n, which the running variance follows
    too (flax's rule: ``nn.SyncBatchNorm`` moves it toward the unbiased
    one). On a CUDA tensor the statistics, the normalization and the
    backward are PyTorch's synchronized-BatchNorm kernels (one pass each,
    the per-rank mean, inverse deviation and count gathered over the
    group); elsewhere, :meth:`_global_forward_plain`: per channel the sum,
    then the sum of squared deviations from the global mean, each summed
    over the group through autograd in float32.
    """

    group = None  # the process group of the global statistics, if any

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._global_forward(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=self.momentum * (n - 1) / n)
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
                global_batch_norm,
            )

            y, mean, var = global_batch_norm(x, self.weight, self.bias,
                                             self.eps, self.group)
        else:
            y, mean, var = self._global_forward_plain(x)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=self.momentum)
        return y

    def _global_forward_plain(self, x: torch.Tensor):
        """(y, global mean, global biased variance) in plain float32 ops:
        the CPU's route, and what the CUDA route is held to."""
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
            all_reduce_sum,
        )
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
            rank_and_size,
        )

        n = x.numel() // x.shape[1] * rank_and_size(self.group)[1]
        x32 = x.float()
        mean = all_reduce_sum(x32.sum(dim=(0, 2, 3)), self.group) / n
        d = x32 - mean[None, :, None, None]
        var = all_reduce_sum((d * d).sum(dim=(0, 2, 3)), self.group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = d * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


def set_process_group(model: nn.Module, group) -> None:
    """Every :class:`BatchNorm2d` of ``model`` takes its training statistics
    over ``group``'s global batch (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


class BasicBlock(nn.Module):
    """3×3 + 3×3 residual block (torchvision ``BasicBlock``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 residual block, expansion 4 (torchvision
    ``Bottleneck``, ResNet50)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride, bias=False),
                BatchNorm2d(out, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ResNet trunk of ``block`` (BasicBlock or Bottleneck) with an optional
    ``fc`` head.

    ``num_classes=None`` is the fc-stripped feature extractor. Parameters
    are initialised from ``generator`` (seed 0 when none is given) and never
    from PyTorch's global generator: the layers are built on the meta device
    and then filled, as the JAX model's ``init`` fills from its key.
    ``frozen_bn`` keeps every BatchNorm in eval mode under ``train()``.
    """

    def __init__(
        self,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        num_classes: int | None = 2,
        num_filters: int = 64,
        generator: torch.Generator | None = None,
        frozen_bn: bool = False,
        block: type[nn.Module] = BasicBlock,
    ):
        super().__init__()
        self.frozen_bn = frozen_bn
        with torch.device("meta"):
            self.conv1 = nn.Conv2d(3, num_filters, 7, 2, 3, bias=False)
            self.bn1 = BatchNorm2d(num_filters, eps=1e-5)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            inplanes = num_filters
            for i, count in enumerate(stage_sizes):
                planes = num_filters * 2**i
                blocks = []
                for j in range(count):
                    stride = 2 if i > 0 and j == 0 else 1
                    blocks.append(block(inplanes, planes, stride))
                    inplanes = planes * getattr(block, "expansion", 1)
                self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.num_stages = len(stage_sizes)
            self.fc = (
                nn.Linear(inplanes, num_classes) if num_classes is not None
                else None
            )
        self.to_empty(device="cpu")
        self.reset_parameters(
            generator if generator is not None
            else torch.Generator().manual_seed(0)
        )
        self.eval()

    def train(self, mode: bool = True) -> "ResNet":
        super().train(mode)
        if self.frozen_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal (fan_out) convs, unit BN with zeroed last-BN scale per
        block, LeCun-normal head: the JAX model's initialisers (the shapes'
        distributions; flax draws other values from its key)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=generator)
                m.bias.zero_()
        for m in self.modules():
            if isinstance(m, BasicBlock):
                m.bn2.weight.zero_()
            elif isinstance(m, Bottleneck):
                m.bn3.weight.zero_()

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """``maxpool(relu(bn1(x)))`` of conv1's output: on the card's
        training forward (``ops/stem_train.py::stem_train_refusal`` admits
        it) one autograd function over hand-written kernels, else the
        modules."""
        if stem_train_refusal(self.bn1, x, self.frozen_bn) is None:
            bn = self.bn1
            return stem_train(x, bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, bn.momentum, bn.eps)
        return self.maxpool(self.relu(self.bn1(x)))

    def forward(self, x: torch.Tensor, from_stem: bool = False
                ) -> torch.Tensor:
        """(B, H, W, 3) normalized images → float32 logits (B, classes), or
        float32 features (B, 8·num_filters·expansion) when there is no
        head.

        With ``from_stem=True``, ``x`` is the already-pooled stem output
        (B, H/4, W/4, num_filters), e.g. of the fused stem kernels
        (``ops/fused_stem.py``), and ``conv1``, ``bn1``, ReLU and the
        maxpool are skipped; their parameters stay in the state dict."""
        x = x.permute(0, 3, 1, 2)
        if not torch.is_autocast_enabled(x.device.type):
            x = x.to(self.conv1.weight.dtype)
        if not from_stem:
            x = self._stem(self.conv1(x))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        x = x.mean(dim=(2, 3))  # global average pool → (B, C)
        if self.fc is None:
            return x.float()
        return self.fc(x).float()


def ResNet18Classifier(num_classes: int = 2, num_filters: int = 64,
                       generator: torch.Generator | None = None,
                       frozen_bn: bool = False) -> ResNet:
    """ResNet18 with an ``fc`` head of ``num_classes`` logits."""
    return ResNet((2, 2, 2, 2), num_classes, num_filters, generator,
                  frozen_bn)


def ResNet18FeatureExtractor(num_filters: int = 64,
                             generator: torch.Generator | None = None
                             ) -> ResNet:
    """fc-stripped ResNet18 → (B, 8·num_filters) features."""
    return ResNet((2, 2, 2, 2), None, num_filters, generator)


def UnifiedResNet(mode: str = "features", num_classes: int = 2,
                  **kw) -> ResNet:
    """The ResNet18 feature extractor (``mode="features"``) or classifier
    (``"classifier"``) behind one flag."""
    if mode == "features":
        return ResNet18FeatureExtractor(**kw)
    if mode == "classifier":
        return ResNet18Classifier(num_classes=num_classes, **kw)
    raise ValueError(f"unknown mode {mode!r}")


def ResNet50(num_classes: int | None = 2, num_filters: int = 64,
             generator: torch.Generator | None = None,
             frozen_bn: bool = False) -> ResNet:
    """Bottleneck ResNet50: (B, classes) logits, or (B, 32·num_filters)
    features with ``num_classes=None``."""
    return ResNet((3, 4, 6, 3), num_classes, num_filters, generator,
                  frozen_bn, block=Bottleneck)


def strip_head(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A classifier's state dict without its ``fc`` head, so that the trunk
    loads into a feature extractor."""
    return {k: v for k, v in sd.items() if not k.startswith("fc.")}


def merge_trunk(target: Mapping[str, torch.Tensor],
                source: Mapping[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
    """``target``'s entries, each non-head one replaced by ``source``'s of
    the same name where ``source`` has it (same trunk topology); the ``fc``
    head and target-only entries stay ``target``'s."""
    return {k: v if k.startswith("fc.") else source.get(k, v)
            for k, v in target.items()}
