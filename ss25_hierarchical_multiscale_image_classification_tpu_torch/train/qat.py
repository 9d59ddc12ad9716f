"""Quantization-aware fine-tuning (QAT) for the int8 deployment path.

Counterpart of the JAX package's ``train/qat.py`` (``_ste``,
``fake_quant_act``, ``fake_quant_weight``, ``qat_forward``,
``qat_finetune``). The graph is the int8 forward's (``models/quantized.py``:
the BN-folded topology, symmetric per-output-channel weights, one
activation scale per quantization point ``in``, ``p0``, ``s{i}b{j}y1``,
``s{i}b{j}o``) as float math with fake quantization, whose gradient is the
straight-through estimator: ``x + (q − x).detach()`` has gradient 1
everywhere, the clipped range included (``torch.fake_quantize_*`` zeroes it
outside the range, so it is another function). Activation scales stay
frozen from a max-abs calibration; the folded weights and biases train.
The tuned tree is re-quantized with ``quantize_folded`` into the artifact
``quantized_resnet18.npz`` that ``--predict_slide --int8`` and
``--extract_features --int8`` serve.

With a process ``group`` (``torchrun``, one process a card: ``parallel/``)
the fine-tune is the JAX function's over its mesh: rank 0 calibrates the
activation scales and every rank takes them and rank 0's folded tree
(broadcast), walks the same batch order and loads its contiguous rows
of each global batch; the loss is the global batch's, the gradients are
summed over the ranks and Adam makes the same update everywhere. Rank 0
writes the artifact.

``round`` is half to even in both frameworks, and the scales divide as
tensors (on CUDA a division by a host scalar is a multiply by its
reciprocal). On the card the fine-tune's convolutions run on cuDNN in
float32 with TF32 off, the precision of the calibration.
"""

from __future__ import annotations

import os
import time
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
    _STAGES,
    calibrate,
    fold_batchnorm,
    quantize_folded,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
    to_device,
)

log = get_logger("train.qat")


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value of ``q``, the gradient of
    ``x``."""
    return x + (q - x).detach()


def fake_quant_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Per-tensor symmetric int8 fake quantization at a frozen scale."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0) * scale
    return _ste(x, q)


def fake_quant_weight(k: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake quantization of an OIHW
    kernel, the scale recomputed from the live weights (``max|k|`` over
    every axis but the output channel's, / 127, as ``_quantize_weights``)."""
    s = torch.amax(torch.abs(k), dim=(1, 2, 3), keepdim=True) / torch.tensor(
        127.0, dtype=k.dtype, device=k.device)
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(k / s), -127.0, 127.0) * s
    return _ste(k, q)


def qat_forward(fp: Mapping[str, Mapping[str, torch.Tensor]],
                ascales: Mapping[str, Any], imgs_u8: torch.Tensor,
                with_fc: bool = True) -> torch.Tensor:
    """Differentiable twin of ``quant_forward``: float32 math with fake
    quantization at every int8 tensor of the deployment graph.

    ``fp`` is the trainable folded tree ``{name: {"kernel" OIHW, "bias"}}``
    (``"fc"``: kernel (in, out)); ``ascales`` the frozen activation scales
    of ``models/quantized.py::calibrate``. Input NHWC uint8; the convs run
    NCHW in channels_last memory."""
    x = normalize(imgs_u8, torch.float32).permute(0, 3, 1, 2)
    x = fake_quant_act(x, ascales["in"])
    k = fake_quant_weight(fp["stem"]["kernel"])
    x = torch.relu(F.conv2d(x, k, fp["stem"]["bias"], 2, 3))
    x = fake_quant_act(F.max_pool2d(x, 3, 2, 1), ascales["p0"])
    for i, blocks in _STAGES:
        for j in range(blocks):
            name = f"s{i}b{j}"
            stride = 2 if i > 1 and j == 0 else 1
            res = x
            k1 = fake_quant_weight(fp[f"{name}c1"]["kernel"])
            y = F.conv2d(x, k1, fp[f"{name}c1"]["bias"], stride, 1)
            y = fake_quant_act(torch.relu(y), ascales[f"{name}y1"])
            k2 = fake_quant_weight(fp[f"{name}c2"]["kernel"])
            y = F.conv2d(y, k2, fp[f"{name}c2"]["bias"], 1, 1)
            if f"{name}down" in fp:
                kd = fake_quant_weight(fp[f"{name}down"]["kernel"])
                res = F.conv2d(res, kd, fp[f"{name}down"]["bias"], stride, 0)
            x = fake_quant_act(torch.relu(y + res), ascales[f"{name}o"])
    feats = x.mean(dim=(2, 3))
    if with_fc and "fc" in fp:
        return feats @ fp["fc"]["kernel"] + fp["fc"]["bias"]
    return feats


def trainable_folded(folded: Mapping[str, tuple], device: torch.device
                     ) -> dict[str, dict[str, torch.Tensor]]:
    """``fold_batchnorm``'s ``{name: (kernel, bias)}`` arrays → leaf float32
    tensors on ``device`` that require gradients (conv kernels in
    channels_last memory)."""
    fp = {}
    for name, (k, b) in folded.items():
        kt = torch.from_numpy(np.array(k, np.float32)).to(device)
        if kt.dim() == 4:
            kt = kt.contiguous(memory_format=torch.channels_last)
        fp[name] = {"kernel": kt.requires_grad_(),
                    "bias": torch.from_numpy(np.array(b, np.float32)).to(
                        device).requires_grad_()}
    return fp


def qat_finetune(
    cfg: Config,
    variables: Mapping[str, torch.Tensor] | None = None,
    level: int = 3,
    epochs: int | None = None,
    batch_size: int | None = None,
    learning_rate: float = 1e-5,
    n_calib_batches: int = 4,
    save: bool = True,
    input_size: int | None = None,
    device: str | torch.device = "cuda",
    group=None,
) -> dict:
    """Fine-tune the trained classifier (``variables``, a ResNet18 state
    dict; default ``<models_dir>/resnet18_patch_classifier.pt``) under fake
    quantization on ``device`` and write the re-quantized int8 artifact
    (``quantized_resnet18.npz``).

    The BN-folded classifier calibrates its activation scales on
    ``training_calibration_batches``, then Adam at ``learning_rate`` tunes
    the folded tree over shuffled batches of the level's patches, weighted
    by ``class_weights_inv_min``; the tuned tree is quantized
    anew (the activation scales recalibrated on it). Returns ``{"folded",
    "ascales", "history", "artifact_path", "quantized"}``. ``group``: one
    rank of the data-parallel fine-tune (``batch_size`` is the global
    batch, which the group's size must divide; rank 0 writes, every rank
    returns the same result)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        BatchIterator,
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        load_or_scan_manifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_grads,
        epoch_totals,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
        process_batch_slice,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
        barrier,
        broadcast_object,
        is_main,
        rank_and_size,
        replicate,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
        CLASSIFIER_ARTIFACT,
        save_quantized,
        training_calibration_batches,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.losses import (
        class_weights_inv_min,
        weighted_cross_entropy,
    )

    dev = resolve_device(device)
    if variables is None:
        variables = load_model(
            os.path.join(cfg.models_dir, "resnet18_patch_classifier"))
    manifest = load_or_scan_manifest(cfg.data.patches_dir, level)
    dataset = (PatchDataset(manifest, resize_to=input_size)
               if input_size else PatchDataset(manifest))
    calib = training_calibration_batches(
        cfg, level, n_batches=n_calib_batches,
        batch_size=min(batch_size or 128, 128), input_size=input_size,
        dataset=dataset,
    )
    folded = fold_batchnorm(variables)
    ascales = None
    if is_main(group):
        ascales = {k: v.cpu() for k, v in calibrate(folded, calib, dev).items()}
    ascales = {k: v.to(dev) for k, v in broadcast_object(ascales, group).items()}
    fp = trainable_folded(folded, dev)
    params = [t for v in fp.values() for t in v.values()]
    replicate(params, group)
    weights = torch.as_tensor(
        class_weights_inv_min(dataset.labels, cfg.model.num_classes)).to(dev)
    opt = torch.optim.Adam(params, lr=learning_rate,
                           fused=dev.type == "cuda")

    epochs = epochs or cfg.train.strategy_epochs
    batch_size = batch_size or cfg.train.batch_size
    rows = process_batch_slice(batch_size, *rank_and_size(group))
    history = []
    # cuDNN on, TF32 off (flags() alone would also turn cuDNN off)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for epoch in range(epochs):
            t0 = time.perf_counter()
            outs = []
            for imgs, labels, valid in BatchIterator(
                    dataset, batch_size, shuffle=True,
                    seed=cfg.train.seed + epoch, rows=rows):
                x = to_device(imgs, dev)
                y = to_device(labels.astype(np.int64), dev)
                v = to_device(valid, dev)
                opt.zero_grad(set_to_none=True)
                logits = qat_forward(fp, ascales, x)
                loss = weighted_cross_entropy(logits, y, weights, v, group)
                loss.backward()
                if group is not None:
                    all_reduce_grads(params, group)
                opt.step()
                with torch.no_grad():
                    outs.append({
                        "loss": loss.detach(),
                        "correct": ((logits.argmax(dim=-1) == y).float()
                                    * v).sum(),
                        "count": v.sum()})
            total = epoch_totals(outs, group, dev)
            acc = total["correct"] / max(total["count"], 1.0)
            history.append({"epoch": epoch, "loss": total["loss"],
                            "acc": acc})
            log.info("QAT epoch %d/%d: loss %.4f acc %.4f (%.1fs)",
                     epoch + 1, epochs, total["loss"], acc,
                     time.perf_counter() - t0)

    folded_tuned = {
        name: (v["kernel"].detach().cpu().contiguous().numpy(),
               v["bias"].detach().cpu().numpy())
        for name, v in fp.items()
    }
    # re-quantize the tuned weights; the activation scales recalibrate on
    # the tuned network (its distributions moved during the fine-tune)
    q = quantize_folded(folded_tuned, calib, device=dev)
    path = None
    if save:
        path = os.path.join(cfg.models_dir, CLASSIFIER_ARTIFACT)
        if is_main(group):
            path = save_quantized(path, q.tree())
            log.info("QAT int8 artifact saved: %s", path)
        barrier(group)
    return {
        "folded": folded_tuned,
        "ascales": {k: v.cpu() for k, v in ascales.items()},
        "history": history,
        "artifact_path": path,
        "quantized": q,
    }
