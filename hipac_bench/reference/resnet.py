"""Plain float32 ResNet18 (He et al., arXiv:1512.03385, Table 1, 18 layers).

A functional forward over a dict of tensors named in torchvision's layout
(``conv1``, ``bn1``, ``layer{1..4}.{0,1}.conv1/bn1/conv2/bn2[/downsample.0/1]``,
``fc``), in NCHW float32. It imports nothing of the program under test.

Departures from the published model, all shared with the program it judges:

- the input is NHWC, ImageNet-normalized, and is permuted to NCHW here;
- the head is ``fc`` 512 → ``num_classes`` (2 for the patch classifier) or
  absent (the SimCLR encoder's 512 features);
- in training mode BatchNorm normalizes with the batch's mean and biased
  variance, as every framework does; running statistics are not kept here,
  since no step that is compared reads them.

``quant`` is applied to every weight of a product and ``act`` to every
activation where it is made: the input, each product's, BatchNorm's,
ReLU's, the pool's and the residual sum's output (identity by default).
The lower-precision control computes in float8 as the program computes in
bfloat16: it passes :func:`fp8_round` (weights in e4m3) and :func:`fp8_act`
(activations in e4m3, the gradients flowing back into them in e5m2, the
usual recipe of float8 training), each with one scale for the tensor.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

#: (stage, planes, first stride) of ResNet18's four stages, two blocks each
STAGES = ((1, 64, 1), (2, 128, 2), (3, 256, 2), (4, 512, 2))
BN_EPS = 1e-5


def conv_shapes(num_filters: int = 64) -> list[tuple[str, tuple[int, ...]]]:
    """Every convolution weight of ResNet18 as (name, (out, in, kh, kw))."""
    out = [("conv1", (num_filters, 3, 7, 7))]
    inplanes = num_filters
    for stage, planes, stride in STAGES:
        planes = planes * num_filters // 64
        for j in range(2):
            pre = f"layer{stage}.{j}"
            cin = inplanes if j == 0 else planes
            out.append((f"{pre}.conv1", (planes, cin, 3, 3)))
            out.append((f"{pre}.conv2", (planes, planes, 3, 3)))
            if j == 0 and (stride != 1 or inplanes != planes):
                out.append((f"{pre}.downsample.0", (planes, inplanes, 1, 1)))
        inplanes = planes
    return out


def bn_names(num_filters: int = 64) -> list[tuple[str, int]]:
    """Every BatchNorm of ResNet18 as (name, channels), after its conv."""
    names = []
    for conv, shape in conv_shapes(num_filters):
        if conv == "conv1":
            names.append(("bn1", shape[0]))
        elif conv.endswith("downsample.0"):
            names.append((conv[:-1] + "1", shape[0]))
        else:
            names.append((conv.replace("conv", "bn"), shape[0]))
    return names


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448, e4m3's largest finite value), back to float32;
    the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` through ``dtype`` and back, its largest magnitude at ``top``."""
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Act(torch.autograd.Function):
    """An activation in float8 e4m3 (largest finite 448); the gradient that
    flows back into it in e5m2 (largest finite 57344)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8_act(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Act.apply(x)


@contextlib.contextmanager
def float32_exact():
    """cuDNN and cuBLAS in full float32: TF32 off inside, restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul


def _bn(x, p, name, train: bool, stats: dict | None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    inv = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + \
        b[None, :, None, None]


def forward(p: dict, x_nhwc: torch.Tensor, train: bool = False,
            stats: dict | None = None, quant=identity,
            act=identity) -> torch.Tensor:
    """Normalized (B, H, W, 3) images → float32 logits (B, classes), or the
    (B, 512) pooled features when ``p`` has no ``fc.weight``. ``stats``,
    where given in training mode, receives each BatchNorm's batch mean and
    biased variance by name."""
    x = act(x_nhwc.permute(0, 3, 1, 2).float())

    def conv(x, name, stride, pad):
        return act(F.conv2d(x, quant(p[f"{name}.weight"]), None, stride, pad))

    def bn(x, name):
        return act(_bn(x, p, name, train, stats))

    x = act(F.relu(bn(conv(x, "conv1", 2, 3), "bn1")))
    x = act(F.max_pool2d(x, 3, 2, 1))
    for stage, _planes, stride in STAGES:
        for j in range(2):
            pre = f"layer{stage}.{j}"
            s = stride if j == 0 else 1
            if f"{pre}.downsample.0.weight" in p:
                idt = bn(conv(x, f"{pre}.downsample.0", s, 0),
                         f"{pre}.downsample.1")
            else:
                idt = x
            out = act(F.relu(bn(conv(x, f"{pre}.conv1", s, 1),
                                f"{pre}.bn1")))
            out = bn(conv(out, f"{pre}.conv2", 1, 1), f"{pre}.bn2")
            x = act(F.relu(act(out + idt)))
    x = act(x.mean(dim=(2, 3)))
    if "fc.weight" not in p:
        return x
    return act(F.linear(x, quant(p["fc.weight"]), p["fc.bias"]))


def margins(p: dict, x_nhwc: torch.Tensor) -> torch.Tensor:
    """Eval-mode tumor logit margins ``logits[:, 1] − logits[:, 0]``."""
    logits = forward(p, x_nhwc)
    return logits[:, 1] - logits[:, 0]
