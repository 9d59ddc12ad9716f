"""Weights made from a seed on the device, and the slide model's
calibration.

ResNet18's convolutions are He-normal (fan out), BatchNorm scales uniform
in [0.5, 1.5] and shifts normal with deviation 0.1 (so that no branch starts
at zero and every leaf has a gradient), the head LeCun-normal; the SimCLR
projection LeCun-normal with zero biases. Each kind is one draw from a
``torch.Generator`` on the device, cut into the leaves. Names follow
torchvision's layout, which the program's models load.

:func:`calibrate_classifier` sets the BatchNorm statistics from tissue
cells by the plain reference's training-mode forward, and turns the head
into a linear probe that tells the tumor cells from the others, so that
the margins spread over the cells and detections fall on tumor (a check of
a random model's margins could not tell a forward that ignores its input
otherwise).
"""

from __future__ import annotations

import math

import torch

from hipac_bench.reference import augment as ref_aug
from hipac_bench.reference import resnet as ref


def _normal_leaves(g, shapes: list[tuple[str, tuple, float]], device):
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, std in shapes:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return out


def resnet18(g: torch.Generator, device, num_classes: int | None = 2,
             prefix: str = "") -> dict:
    """A ResNet18 state dict (float32 on ``device``) from ``g``."""
    convs = [(f"{prefix}{n}.weight", s, math.sqrt(2.0 / (s[0] * s[2] * s[3])))
             for n, s in ref.conv_shapes()]
    if num_classes is not None:
        convs.append((f"{prefix}fc.weight", (num_classes, 512),
                      1.0 / math.sqrt(512)))
    sd = _normal_leaves(g, convs, device)
    bns = ref.bn_names()
    channels = sum(c for _, c in bns)
    gamma = torch.rand(channels, generator=g, device=device) + 0.5
    beta = torch.randn(channels, generator=g, device=device) * 0.1
    at = 0
    for name, c in bns:
        sd[f"{prefix}{name}.weight"] = gamma[at:at + c]
        sd[f"{prefix}{name}.bias"] = beta[at:at + c]
        sd[f"{prefix}{name}.running_mean"] = torch.zeros(c, device=device)
        sd[f"{prefix}{name}.running_var"] = torch.ones(c, device=device)
        sd[f"{prefix}{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
        at += c
    if num_classes is not None:
        sd[f"{prefix}fc.bias"] = torch.zeros(num_classes, device=device)
    return {k: v.contiguous() for k, v in sd.items()}


def simclr(g: torch.Generator, device, hidden: int = 512,
           out: int = 128) -> dict:
    """The SimCLR model's state dict: the encoder under ``encoder.``, the
    projection 512 → ``hidden`` → ``out`` under ``projector.0`` and
    ``projector.2``."""
    sd = resnet18(g, device, None, prefix="encoder.")
    sd.update(_normal_leaves(g, [
        ("projector.0.weight", (hidden, 512), 1.0 / math.sqrt(512)),
        ("projector.2.weight", (out, hidden), 1.0 / math.sqrt(hidden)),
    ], device))
    sd["projector.0.bias"] = torch.zeros(hidden, device=device)
    sd["projector.2.bias"] = torch.zeros(out, device=device)
    return {k: v.contiguous() for k, v in sd.items()}


@torch.no_grad()
def calibrate_classifier(sd: dict, cells_u8: torch.Tensor,
                         tumor: torch.Tensor, margin_std: float) -> dict:
    """``sd`` with BatchNorm statistics from ``cells_u8`` (uint8 tissue
    cells on the device) and a linear probe for a head: it reads the
    features along the difference of the tumor cells' (``tumor``) and the
    other cells' mean, scaled so that the margins over the cells have
    deviation ``margin_std``, zero halfway between the two means (the
    first principal direction and the median, where one class is
    missing)."""
    x = ref_aug.normalize(cells_u8)
    stats: dict = {}
    with ref.float32_exact():
        ref.forward(sd, x, train=True, stats=stats)
        out = dict(sd)
        for name, (mean, var) in stats.items():
            out[f"{name}.running_mean"] = mean.contiguous()
            out[f"{name}.running_var"] = var.contiguous()
        trunk = {k: v for k, v in out.items() if not k.startswith("fc.")}
        feats = ref.forward(trunk, x).double()
    if bool(tumor.any()) and bool((~tumor).any()):
        hi, lo = feats[tumor].mean(dim=0), feats[~tumor].mean(dim=0)
        d = (hi - lo) / torch.linalg.vector_norm(hi - lo)
        c = float((hi + lo) @ d) / 2
    else:
        centred = feats - feats.mean(dim=0)
        d = torch.linalg.svd(centred, full_matrices=False).Vh[0]
        c = float(torch.median(feats @ d))
    k = margin_std / float((feats @ d).std())
    w = (k * d).float()
    out["fc.weight"] = torch.stack([-w / 2, w / 2]).contiguous()
    out["fc.bias"] = torch.tensor([k * c / 2, -k * c / 2], dtype=torch.float32,
                                  device=w.device)
    return out
