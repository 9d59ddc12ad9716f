"""Inference folds of ResNet18 and its post-training int8 (w8a8) forward:
BatchNorm folded into the convs, the ImageNet normalize folded into the stem,
an optional space-to-depth stem; then symmetric int8 weights (per output
channel) and activations (per tensor), with every convolution on a
hand-written int8 kernel.

Counterpart of the JAX package's ``models/quantized.py``: the float half
(``_fold``, ``fold_batchnorm``, ``folded_forward``,
``_fold_normalize_into_stem``, ``_stem_kernel_s2d``,
``fold_resnet18_inference``, ``folded_forward_inference``) and the int8 half
(``QuantizedResNet18``, ``_quantize_weights``, ``calibrate``,
``quantize_resnet18``, ``quantize_folded``, ``_requant``, ``quant_forward``).

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

:func:`quant_forward` is the int8 forward of ``--int8``. A quantized tree
(:meth:`QuantizedResNet18.tree`, or ``models/quant_artifact.py::load_quantized``)
holds int8 kernels ``(C_out, C_in, KH, KW)`` in channels_last memory, float32
weight scales and biases, one float32 activation scale per quantization
point (calibrated through :func:`folded_forward` with ``collect=True``), the
float32 head and the stem's bias map. Every inter-layer tensor is NHWC int8.
The stem, the stage 2–4 convolutions and the downsamples run on
``ops/int8_conv.py::int8_conv_requant`` (PyTorch has no int8 convolution on
CUDA), the maxpool after the stem on ``ops/int8_pool.py::int8_maxpool``
(nor an int8 maxpool), stage 1 on ``ops/int8_block.py::fused_stage1_int8``;
the mean and the head are plain ops. On CPU tensors the kernels' plain
versions run, with the same arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

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
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.fused_stem import (
    bias_relu_pool,
    fused_stem,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_block import (
    fused_stage1_int8,
    pack_stage1_kernels,
    stage1_params_from_qtree,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_pool import (
    int8_maxpool,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.int8_conv import (
    int8_conv_requant,
    pack_int8_kernel,
    requant_reference,
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


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedResNet18:
    """int8 weights and scales, on the CPU until :func:`quantized_to` moves
    the tree."""

    qkernels: dict[str, torch.Tensor]   # int8 (O, I, KH, KW), channels_last
    wscales: dict[str, torch.Tensor]    # float32 per output channel
    biases: dict[str, torch.Tensor]     # float32 per output channel
    ascales: dict[str, torch.Tensor]    # float32 scalars per quant point
    fc: tuple[torch.Tensor, torch.Tensor] | None
    stem_bias_map: torch.Tensor | None = None  # float32 (H/2, W/2, C)

    def tree(self) -> dict[str, Any]:
        return {
            "qkernels": self.qkernels, "wscales": self.wscales,
            "biases": self.biases, "ascales": self.ascales, "fc": self.fc,
            "stem_bias_map": self.stem_bias_map,
        }

    def forward(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        return quant_forward(self.tree(), imgs_u8, with_fc=True)

    def features(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        return quant_forward(self.tree(), imgs_u8, with_fc=False)


def _quantize_weights(folded: dict) -> tuple[dict, dict, dict]:
    """Symmetric per-output-channel int8 weights of a BN-folded tree (OIHW
    kernels): ``(qkernels, wscales, biases)`` as tensors."""
    qk, ws, bs = {}, {}, {}
    for name, (kernel, bias) in folded.items():
        if name == "fc":
            continue
        k = np.asarray(kernel, np.float32)
        s = np.max(np.abs(k), axis=(1, 2, 3)) / 127.0
        s = np.maximum(s, 1e-12).astype(np.float32)
        q = np.clip(np.rint(k / s[:, None, None, None]), -127, 127)
        qk[name] = torch.from_numpy(q.astype(np.int8)).contiguous(
            memory_format=torch.channels_last)
        ws[name] = torch.from_numpy(s)
        bs[name] = torch.from_numpy(np.array(bias, np.float32))
    return qk, ws, bs


def calibrate(folded: dict, calib_batches: Iterable,
              device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Max-abs activation scales from float32 passes of
    :func:`folded_forward` (``collect=True``, TF32 off) over
    ``calib_batches``, an iterable of uint8 (B, H, W, 3) arrays or tensors,
    on ``device``."""
    dev = resolve_device(device)
    maxes: dict[str, float] | None = None
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        for batch in calib_batches:
            if not isinstance(batch, torch.Tensor):
                batch = torch.as_tensor(np.asarray(batch))
            imgs = batch.to(dev)
            obs = folded_forward(folded, imgs, with_fc=False, collect=True)[1]
            o = {k: float(v) for k, v in obs.items()}
            maxes = o if maxes is None else {k: max(maxes[k], v)
                                             for k, v in o.items()}
    if maxes is None:
        raise ValueError("calibrate() needs at least one batch")
    return {k: torch.tensor(max(v / 127.0, 1e-12), dtype=torch.float32)
            for k, v in maxes.items()}


def quantize_resnet18(
    state: Mapping[str, torch.Tensor], calib_batches: Iterable,
    fold_stem_normalize: bool = True, stem_s2d: bool | None = None,
    device: str | torch.device = "cuda",
) -> QuantizedResNet18:
    """Fold BN, quantize the weights per channel, calibrate the activation
    scales on ``device``.

    ``stem_s2d`` additionally reformulates the stem as a space-to-depth 4×4
    conv (needs even input H/W and ``fold_stem_normalize``), the same sums as
    the direct 7×7/2 conv; ``None`` enables it whenever it applies.
    """
    return quantize_folded(
        fold_batchnorm(state), calib_batches,
        fold_stem_normalize=fold_stem_normalize, stem_s2d=stem_s2d,
        device=device,
    )


def quantize_folded(
    folded: dict, calib_batches: Iterable, fold_stem_normalize: bool = True,
    stem_s2d: bool | None = None, device: str | torch.device = "cuda",
) -> QuantizedResNet18:
    """Quantize an already BN-folded ``{name: (kernel OIHW, bias)}`` tree."""
    # materialize once: calibrate() consumes the iterable, and the size probe
    # below must see the same batches
    calib_batches = list(calib_batches)
    folded = {k: (np.asarray(v[0]), np.asarray(v[1])) for k, v in folded.items()}
    ascales = calibrate(folded, calib_batches, device)
    bias_map = None
    if fold_stem_normalize:
        hw = (224, 224)
        if calib_batches:
            hw = (int(calib_batches[0].shape[1]), int(calib_batches[0].shape[2]))
        bias_map = torch.from_numpy(_fold_normalize_into_stem(folded, hw))
        if stem_s2d is None:
            stem_s2d = hw[0] % 2 == 0 and hw[1] % 2 == 0
        if stem_s2d:
            k = _stem_kernel_s2d(folded["stem"][0].transpose(2, 3, 1, 0))
            folded["stem"] = (np.ascontiguousarray(k.transpose(3, 2, 0, 1)),
                              folded["stem"][1])
    elif stem_s2d:
        raise ValueError("stem_s2d requires fold_stem_normalize")
    qk, ws, bs = _quantize_weights(folded)
    fc = None
    if "fc" in folded:
        fc = (torch.from_numpy(np.array(folded["fc"][0], np.float32)),
              torch.from_numpy(np.array(folded["fc"][1], np.float32)))
    return QuantizedResNet18(qk, ws, bs, ascales, fc, stem_bias_map=bias_map)


# ---------------------------------------------------------------------------
# int8 forward
# ---------------------------------------------------------------------------


def _requant(y32, mscale, bias, s_out, residual_f32=None, relu=True):
    """Conv epilogue in plain ops: int32 → float32 dequantize (+ bias,
    + residual), ReLU, requantize to int8 at scale ``s_out`` (a tensor)."""
    return requant_reference(y32, mscale, bias, s_out, residual_f32, relu)


def _conv_names(qk: Mapping[str, Any]) -> list[str]:
    """The convolutions of stages 2–4 in the forward's order."""
    names = []
    for i, blocks in _STAGES[1:]:
        for j in range(blocks):
            names.append(f"s{i}b{j}c1")
            if f"s{i}b{j}down" in qk:
                names.append(f"s{i}b{j}down")
            names.append(f"s{i}b{j}c2")
    return names


def quant_plan(qp: Mapping[str, Any]) -> dict[str, Any]:
    """What :func:`quant_forward` needs besides the tree, made once: per
    convolution the kernel-layout weights, the dequantization scale (input
    activation scale × weight scale) and the bias (the stem's with its bias
    map added), and the packed stage-1 parameters."""
    qk, ws, bs, sc = qp["qkernels"], qp["wscales"], qp["biases"], qp["ascales"]
    plan: dict[str, Any] = {}
    if qp.get("stem_bias_map") is not None:
        stem_mscale, stem_bias = ws["stem"], bs["stem"] + qp["stem_bias_map"]
    else:
        stem_mscale, stem_bias = sc["in"] * ws["stem"], bs["stem"]
    on_card = qk["stem"].device.type == "cuda"
    pack = pack_int8_kernel if on_card else (lambda k: None)
    plan["stem"] = (pack(qk["stem"]), stem_mscale, stem_bias)
    s_x = sc["s1b1o"]
    for name in _conv_names(qk):
        block = name[:4]
        s_in = sc[f"{block}y1"] if name.endswith("c2") else s_x
        plan[name] = (pack(qk[name]), s_in * ws[name], bs[name])
        if name.endswith("c2"):
            s_x = sc[f"{block}o"]
    stage1 = stage1_params_from_qtree(qp)
    plan["stage1"] = stage1 + (pack_stage1_kernels(stage1[0])
                               if on_card else None,)
    return plan


def quantized_to(qp: Mapping[str, Any],
                 device: str | torch.device) -> dict[str, Any]:
    """A quantized tree on ``device``, with its :func:`quant_plan` under
    ``"plan"`` so that a forward derives nothing per call."""
    dev = resolve_device(device)

    def move(node):
        if isinstance(node, torch.Tensor):
            t = node.to(dev)
            if t.dim() == 4:  # .to() keeps strides only where it copies
                t = t.contiguous(memory_format=torch.channels_last)
            return t
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(move(v) for v in node)
        return node

    out = move({k: v for k, v in qp.items() if k != "plan"})
    out["plan"] = quant_plan(out)
    return out


def quant_forward(qp: Mapping[str, Any], imgs_u8: torch.Tensor,
                  with_fc: bool = True) -> torch.Tensor:
    """int8 forward of a quantized tree (:meth:`QuantizedResNet18.tree`,
    best through :func:`quantized_to`) on the tree's device: float32 logits,
    or the float32 pooled features with ``with_fc=False`` or no head.

    ``imgs_u8`` is a raw NHWC uint8 batch, (B, H, W, 3) or, for a
    space-to-depth stem, the host-made (B, H/2, W/2, 12) layout. With a
    folded stem the convs consume ``u8 − 128`` (exact in int8, no
    quantization error on the input); else the batch is normalized and
    quantized at the calibrated input scale. Every inter-layer tensor is
    int8; the epilogues run in float32 inside the kernels.
    """
    if imgs_u8.dtype != torch.uint8 or imgs_u8.dim() != 4:
        raise ValueError(f"expected a (B, H, W, C) uint8 batch, got "
                         f"{tuple(imgs_u8.shape)} {imgs_u8.dtype}")
    qk, sc = qp["qkernels"], qp["ascales"]
    plan = qp.get("plan") or quant_plan(qp)
    s_p0 = sc["p0"]
    packed, mscale, bias = plan["stem"]

    if qp.get("stem_bias_map") is not None:
        # normalize folded into the stem weights: the conv consumes raw
        # u8 − 128 pixels; the bias map restores the (128 − mean)/std offset
        # with exact zero-pad border semantics
        t = (imgs_u8.to(torch.int16) - 128).to(torch.int8)
        s2d_stem = qk["stem"].shape[-1] == 4
        if imgs_u8.shape[-1] == 12:
            # batch already in space-to-depth layout (host-side gather)
            if not s2d_stem:
                raise ValueError("pre-s2d input needs an s2d stem kernel")
        elif s2d_stem:
            n, h, w, _ = t.shape
            t = t.reshape(n, h // 2, 2, w // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
            t = t.reshape(n, h // 2, w // 2, 12)
        if s2d_stem:
            x = int8_conv_requant(t, qk["stem"], mscale, bias, s_p0, 1,
                                  ((2, 1), (2, 1)), packed=packed)
        else:
            x = int8_conv_requant(t, qk["stem"], mscale, bias, s_p0, 2, 3,
                                  packed=packed)
    else:
        # explicit path: normalize (u8 affine) and quantize at the input scale
        dev = imgs_u8.device
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev) * 255.0
        xf = (imgs_u8.to(torch.float32) - mean) / (std * sc["in"])
        xq = torch.round(xf).clamp(-127.0, 127.0).to(torch.int8)
        x = int8_conv_requant(xq, qk["stem"], mscale, bias, s_p0, 2, 3,
                              packed=packed)

    # maxpool on int8 (order swaps with the monotone requant + ReLU exactly)
    x = int8_maxpool(x)

    kernels, mscales, biases, scalars, packed1 = plan["stage1"]
    x = fused_stage1_int8(x, kernels, mscales, biases, scalars, packed=packed1)
    s_x = sc["s1b1o"]

    for i, blocks in _STAGES[1:]:
        for j in range(blocks):
            stride = 2 if j == 0 else 1
            s_y1, s_o = sc[f"s{i}b{j}y1"], sc[f"s{i}b{j}o"]
            packed, mscale, bias = plan[f"s{i}b{j}c1"]
            yq = int8_conv_requant(x, qk[f"s{i}b{j}c1"], mscale, bias, s_y1,
                                   stride, 1, packed=packed)
            res, res_scale = x, s_x
            if f"s{i}b{j}down" in qk:
                packed, mscale, bias = plan[f"s{i}b{j}down"]
                res = int8_conv_requant(x, qk[f"s{i}b{j}down"], mscale, bias,
                                        None, stride, 0, relu=False,
                                        out_f32=True, packed=packed)
                res_scale = None
            packed, mscale, bias = plan[f"s{i}b{j}c2"]
            x = int8_conv_requant(yq, qk[f"s{i}b{j}c2"], mscale, bias, s_o, 1,
                                  1, residual=res, residual_scale=res_scale,
                                  packed=packed)
            s_x = s_o

    feats = (x.to(torch.float32) * s_x).mean(dim=(1, 2))
    if with_fc and qp["fc"] is not None:
        return feats @ qp["fc"][0] + qp["fc"][1]
    return feats
