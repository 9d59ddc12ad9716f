"""Inference folds of ResNet18: BatchNorm folded into the convs, the ImageNet
normalize folded into the stem, an optional space-to-depth stem.

Counterpart of the float half of the JAX package's ``models/quantized.py``
(``_fold``, ``fold_batchnorm``, ``folded_forward``,
``_fold_normalize_into_stem``, ``_stem_kernel_s2d``,
``fold_resnet18_inference``, ``folded_forward_inference``); its int8 half
(``quantize_*``, ``calibrate``, ``quant_forward``) comes with the int8 path
and will calibrate through :func:`folded_forward` here.

The folds read the port's torchvision-layout state dict and keep conv
kernels OIHW; they run in numpy float64 in the JAX module's order of
operations (``k·g``, ``b − m·g``), so the folded weights equal JAX's exactly
after the HWIO → OIHW transpose.

:func:`folded_forward_inference` is the deployment forward of
``--extract_features``: it takes the raw NHWC uint8 batch, forms ``t = u8 −
128`` (exact in bfloat16) as a channels_last view, and runs

- ``stem_s2d=False``: the library 7×7/2 convolution, then the hand-written
  ``bias_relu_pool`` kernel with the stem bias map (``ops/fused_stem.py``):
  one pass over the conv plane where bias add, ReLU and maxpool would take
  three;
- ``stem_s2d=True``: a 2×2 space-to-depth of ``t`` padded (2, 1), then the
  hand-written ``fused_stem`` kernel with the rearranged weights and the
  bias map: the whole stem in one launch;
- the stages as library convolutions with the folded bias, ReLU and the
  residual add as plain ops, a float32 mean and a float32 head.

On CPU tensors both stems run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
    bias_relu_pool,
    fused_stem,
)

_STAGES = ((1, 2), (2, 2), (3, 2), (4, 2))  # (stage index, blocks) for ResNet18
_EPS = 1e-5


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------


def _fold(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps):
    """Fold BatchNorm into the preceding conv (OIHW kernel): returns
    (kernel', bias') float32."""
    g = np.asarray(bn_scale, np.float64) / np.sqrt(
        np.asarray(bn_var, np.float64) + eps
    )
    k = np.asarray(kernel, np.float64) * g[:, None, None, None]
    b = np.asarray(bn_bias, np.float64) - np.asarray(bn_mean, np.float64) * g
    return k.astype(np.float32), b.astype(np.float32)


def fold_batchnorm(state: Mapping[str, torch.Tensor], eps: float = _EPS) -> dict:
    """Collapse every Conv+BN pair of a ResNet18 state dict (torchvision
    layout) into ``{name: (kernel OIHW, bias)}`` float32 arrays.

    Returned names, as in the JAX module: ``stem``, ``s{i}b{j}c1``,
    ``s{i}b{j}c2``, ``s{i}b{j}down`` (when present) and ``fc`` as
    ``(kernel (in, out), bias)`` unfolded.
    """
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()
          if not k.endswith("num_batches_tracked")}

    def fold(conv: str, bn: str):
        return _fold(sd[f"{conv}.weight"], sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                     sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], eps)

    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    out["stem"] = fold("conv1", "bn1")
    for i, blocks in _STAGES:
        for j in range(blocks):
            block = f"layer{i}.{j}"
            out[f"s{i}b{j}c1"] = fold(f"{block}.conv1", f"{block}.bn1")
            out[f"s{i}b{j}c2"] = fold(f"{block}.conv2", f"{block}.bn2")
            if f"{block}.downsample.0.weight" in sd:
                out[f"s{i}b{j}down"] = fold(f"{block}.downsample.0",
                                            f"{block}.downsample.1")
    if "fc.weight" in sd:
        out["fc"] = (
            np.ascontiguousarray(sd["fc.weight"].T, np.float32),
            np.asarray(sd["fc.bias"], np.float32),
        )
    return out


# ---------------------------------------------------------------------------
# Float forward on folded weights (calibration / reference path)
# ---------------------------------------------------------------------------


def folded_forward(folded: dict, imgs_u8: torch.Tensor, with_fc: bool = True,
                   collect: bool = False):
    """Float32 forward on the BN-folded weights of :func:`fold_batchnorm`,
    on the device of ``imgs_u8`` (NHWC uint8).

    With ``collect=True`` also returns ``{point: max_abs}`` at every
    activation-quantization point (the calibration observables).
    """
    dev = imgs_u8.device
    w = {name: (torch.from_numpy(k).to(dev), torch.from_numpy(b).to(dev))
         for name, (k, b) in folded.items()}
    obs: dict[str, torch.Tensor] = {}

    def note(name, x):
        if collect:
            obs[name] = x.abs().max().float()
        return x

    x = note("in", normalize(imgs_u8, torch.float32)).permute(0, 3, 1, 2)
    x = F.conv2d(x, *w["stem"], 2, 3).relu()
    x = note("p0", F.max_pool2d(x, 3, 2, 1))
    for i, blocks in _STAGES:
        for j in range(blocks):
            stride = 2 if i > 1 and j == 0 else 1
            res = x
            y = F.conv2d(x, *w[f"s{i}b{j}c1"], stride, 1)
            y = note(f"s{i}b{j}y1", y.relu())
            y = F.conv2d(y, *w[f"s{i}b{j}c2"], 1, 1)
            if f"s{i}b{j}down" in w:
                res = F.conv2d(res, *w[f"s{i}b{j}down"], stride, 0)
            x = note(f"s{i}b{j}o", (y + res).relu())
    feats = x.mean(dim=(2, 3))
    if with_fc and "fc" in w:
        out = feats @ w["fc"][0] + w["fc"][1]
    else:
        out = feats
    return (out, obs) if collect else out


# ---------------------------------------------------------------------------
# Inference folds
# ---------------------------------------------------------------------------


def _fold_normalize_into_stem(
    folded: dict, input_hw: tuple[int, int] = (224, 224)
) -> np.ndarray:
    """Fold the ImageNet normalize into the stem conv so the forward
    consumes raw ``u8 − 128`` pixels with no separate normalize pass.

    normalized = (u8 − mean)/std = (t + 128 − mean)/std with t = u8 − 128.
    The 1/std per-input-channel factor folds into the kernel; the
    (128 − mean)/std offset becomes a per-position bias map A (float32, one
    conv of a constant plane with zero padding), which is exact at the
    borders, where the float model's zero padding contributes nothing: a
    per-channel constant is wrong in the two border cells.

    Mutates ``folded['stem']`` (kernel /= std) and returns A with shape
    (H_out, W_out, C_out).
    """
    kernel, bias = folded["stem"]
    std = (np.asarray(IMAGENET_STD, np.float64) * 255.0).reshape(1, 3, 1, 1)
    mean = np.asarray(IMAGENET_MEAN, np.float64) * 255.0
    kernel_f = (np.asarray(kernel, np.float64) / std).astype(np.float32)
    folded["stem"] = (kernel_f, bias)

    h, w = input_hw
    plane = torch.from_numpy((128.0 - mean).astype(np.float32))
    plane = plane.reshape(1, 3, 1, 1).expand(1, 3, h, w)
    a = F.conv2d(plane, torch.from_numpy(kernel_f), None, 2, 3)
    return a[0].permute(1, 2, 0).contiguous().numpy()  # (H/2, W/2, C_out)


def _stem_kernel_s2d(kernel_f: np.ndarray) -> np.ndarray:
    """Rearrange the (7, 7, 3, C) HWIO stem kernel for a space-to-depth input.

    With s(Y, X, (r·2+rx)·3+c) = in(2Y+r, 2X+rx, c), the 7×7 stride-2 conv is
    exactly a 4×4 stride-1 conv over the (H/2, W/2, 12) plane with padding
    (2, 1): zero-pad the kernel to 8×8 at the front (taps −4..3), then tap
    (2q+r − 4) maps to s2d kernel position q, channel slot (r·2+rx)·3+c.
    Returns (4, 4, 12, C).
    """
    k8 = np.zeros((8, 8) + kernel_f.shape[2:], kernel_f.dtype)
    k8[1:, 1:] = kernel_f
    out = np.zeros((4, 4, 12, kernel_f.shape[3]), kernel_f.dtype)
    for qy in range(4):
        for qx in range(4):
            for r in range(2):
                for rx in range(2):
                    s = (r * 2 + rx) * 3
                    out[qy, qx, s : s + 3] = k8[2 * qy + r, 2 * qx + rx]
    return out


def fold_resnet18_inference(
    state: Mapping[str, torch.Tensor],
    input_hw: tuple[int, int] = (224, 224),
    stem_s2d: bool = False,
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Inference-folded weights in ``dtype`` from a ResNet18 state dict: BN
    folded into the convs, ImageNet normalize folded into the stem, optional
    space-to-depth stem.

    Returns the pytree of :func:`folded_forward_inference`, on the CPU (move
    it with :func:`folded_to`): ``kernels`` (OIHW, channels_last, ``dtype``),
    ``biases`` (``dtype``), ``fc`` ((in, out) ``dtype``, float32 bias) or
    None, ``stem_bias_map`` (H/2, W/2, C) in ``dtype`` (the stem's BN bias
    plus the normalize-offset map), and with ``stem_s2d`` the stem as the
    (C, 12, 4, 4) kernel of the space-to-depth plane plus ``stem_w2``
    (4, 48, C), the same weights in the layout of the ``fused_stem`` kernel
    (KX-major groups, row KY·12 + slot).
    """
    folded = fold_batchnorm(state)
    bias_map = _fold_normalize_into_stem(folded, input_hw)
    if stem_s2d and (input_hw[0] % 2 or input_hw[1] % 2):
        raise ValueError("stem_s2d requires even input H/W")
    stem_w2 = None
    if stem_s2d:
        k = _stem_kernel_s2d(folded["stem"][0].transpose(2, 3, 1, 0))  # HWIO
        folded["stem"] = (np.ascontiguousarray(k.transpose(3, 2, 0, 1)),
                          folded["stem"][1])
        stem_w2 = torch.from_numpy(
            k.transpose(1, 0, 2, 3).reshape(4, 48, k.shape[3]).copy()
        ).to(dtype)
    kernels, biases, fc = {}, {}, None
    for name, (k, b) in folded.items():
        if name == "fc":
            fc = (torch.from_numpy(k).to(dtype), torch.from_numpy(b))
            continue
        kernels[name] = torch.from_numpy(k).to(dtype).contiguous(
            memory_format=torch.channels_last)
        biases[name] = torch.from_numpy(b).to(dtype)
    # stem epilogue: BN bias + normalize-offset map in one precomputed map
    stem_map = (torch.from_numpy(bias_map) + biases["stem"].float()).to(dtype)
    fp = {
        "kernels": kernels,
        "biases": biases,
        "fc": fc,
        "stem_bias_map": stem_map,
    }
    if stem_w2 is not None:
        fp["stem_w2"] = stem_w2
    return fp


def folded_to(fp: dict[str, Any], device: str | torch.device) -> dict[str, Any]:
    """The pytree of :func:`fold_resnet18_inference` on ``device``."""
    def move(node):
        if isinstance(node, torch.Tensor):
            t = node.to(device)
            if t.dim() == 4:  # .to() keeps strides only where it copies
                t = t.contiguous(memory_format=torch.channels_last)
            return t
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(move(v) for v in node)
        return node

    return move(fp)


def folded_forward_inference(fp: dict[str, Any], imgs_u8: torch.Tensor,
                             with_fc: bool = True) -> torch.Tensor:
    """Forward on :func:`fold_resnet18_inference` weights, in their dtype,
    of a raw NHWC uint8 batch on the weights' device: float32 logits, or the
    float32 pooled features with ``with_fc=False`` or no head.

    The stem runs on the ``fused_stem`` kernel when ``fp`` holds a
    space-to-depth stem and else as a library conv followed by the
    ``bias_relu_pool`` kernel (CUDA tensors; CPU tensors take the kernels'
    plain versions); everything after it is library convs and plain ops.
    """
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4 or imgs_u8.shape[-1] != 3:
        raise ValueError(f"expected a (B, H, W, 3) uint8 batch, got "
                         f"{tuple(imgs_u8.shape)} {imgs_u8.dtype}")
    k, b = fp["kernels"], fp["biases"]
    dtype = k["stem"].dtype
    t = imgs_u8.to(dtype) - 128  # exact in bfloat16
    if k["stem"].shape[-1] == 4:  # space-to-depth stem
        n, h, w, _ = t.shape
        s = t.reshape(n, h // 2, 2, w // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
        s = F.pad(s.reshape(n, h // 2, w // 2, 12), (0, 0, 2, 1, 2, 1))
        x = fused_stem(s, fp["stem_w2"], fp["stem_bias_map"], out_dtype=dtype,
                       mm_dtype=dtype)
    else:
        # NHWC → NCHW as a view: channels_last in memory, no copy
        y = F.conv2d(t.permute(0, 3, 1, 2), k["stem"], None, 2, 3)
        x = bias_relu_pool(y.permute(0, 2, 3, 1), fp["stem_bias_map"],
                           out_dtype=dtype)
    x = x.permute(0, 3, 1, 2)
    for i, blocks in _STAGES:
        for j in range(blocks):
            stride = 2 if i > 1 and j == 0 else 1
            y1 = F.conv2d(x, k[f"s{i}b{j}c1"], b[f"s{i}b{j}c1"], stride, 1)
            y = F.conv2d(y1.relu_(), k[f"s{i}b{j}c2"], b[f"s{i}b{j}c2"], 1, 1)
            if f"s{i}b{j}down" in k:
                x = F.conv2d(x, k[f"s{i}b{j}down"], b[f"s{i}b{j}down"],
                             stride, 0)
            x = y.add_(x).relu_()
    feats = x.mean(dim=(2, 3), dtype=torch.float32)
    if with_fc and fp["fc"] is not None:
        return feats @ fp["fc"][0].float() + fp["fc"][1]
    return feats
