"""Persisted int8 quantization artifacts.

Counterpart of the JAX package's ``models/quant_artifact.py``
(``save_quantized``, ``load_quantized``, ``artifact_input_hw``,
``training_calibration_batches``, ``quantize_classifier_to_artifact``,
``quantize_trunk_to_artifact``, ``maybe_load_artifact``). The deployment flow calibrates **once** on
training tissue and persists the quantized tree (int8 kernels, per-channel
weight scales, activation scales, the folded stem bias map) as one ``.npz``
that every int8 consumer (``--extract_features --int8``, ``--predict_slide
--int8``) loads, so that outputs do not depend on batch size, batch order or
the slide: lazy calibration on a run's first batch does.

The file is the JAX package's, key for key: ``qkernels/<name>`` int8 **HWIO**,
``wscales/<name>``, ``biases/<name>``, ``ascales/<name>``, ``fc/0``,
``fc/1``, ``stem_bias_map``. An artifact written by either package loads in
the other; the port's tree keeps its kernels ``(C_out, C_in, KH, KW)`` in
channels_last memory (the layout its int8 kernels read), so saving and
loading transpose. :func:`quantize_trunk_to_artifact` writes the trunk
artifact of the multiscale classifier (``quantized_hierarchical_trunk.npz``)
in the same format.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("models.quant_artifact")

CLASSIFIER_ARTIFACT = "quantized_resnet18.npz"
TRUNK_ARTIFACT = "quantized_hierarchical_trunk.npz"

_DICT_FIELDS = ("qkernels", "wscales", "biases", "ascales")


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_quantized(path: str, qtree: Mapping[str, Any]) -> str:
    """Flatten a :meth:`QuantizedResNet18.tree` dict into one ``.npz``
    (kernels back in HWIO)."""
    path = _npz(path)
    flat: dict[str, np.ndarray] = {}
    for field in _DICT_FIELDS:
        for name, t in qtree[field].items():
            a = t.detach().cpu().numpy()
            if field == "qkernels":  # (O, I, KH, KW) → HWIO
                a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
            flat[f"{field}/{name}"] = a
    if qtree.get("fc") is not None:
        flat["fc/0"] = qtree["fc"][0].detach().cpu().numpy()
        flat["fc/1"] = qtree["fc"][1].detach().cpu().numpy()
    if qtree.get("stem_bias_map") is not None:
        flat["stem_bias_map"] = qtree["stem_bias_map"].detach().cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    log.info("quantized artifact saved: %s (%d tensors)", path, len(flat))
    return path


def tree_from_arrays(arrays: Mapping[str, Any]) -> dict[str, Any]:
    """``{"qkernels/<name>": HWIO int8, "wscales/<name>": …, "fc/0": …,
    "stem_bias_map": …}`` as arrays → the port's quantized tree on the CPU:
    kernels ``(C_out, C_in, KH, KW)`` int8 in channels_last memory, the rest
    float32 tensors."""
    tree: dict[str, Any] = {f: {} for f in _DICT_FIELDS}
    tree["stem_bias_map"] = None
    fc: list = [None, None]
    for key, value in arrays.items():
        a = np.array(value)  # a copy torch may own
        if key == "stem_bias_map":
            tree[key] = torch.from_numpy(a.astype(np.float32))
        elif key.startswith("fc/"):
            fc[int(key.split("/", 1)[1])] = torch.from_numpy(
                a.astype(np.float32))
        else:
            field, name = key.split("/", 1)
            if field == "qkernels":
                t = torch.from_numpy(a.astype(np.int8)).permute(3, 2, 0, 1)
                tree[field][name] = t.contiguous(
                    memory_format=torch.channels_last)
            else:
                t = torch.from_numpy(a.astype(np.float32))
                tree[field][name] = t.reshape(()) if field == "ascales" else t
    tree["fc"] = None if fc[0] is None else (fc[0], fc[1])
    return tree


def load_quantized(path: str) -> dict[str, Any]:
    """Inverse of :func:`save_quantized`: a ``quant_forward`` tree on the
    CPU (move it with ``models/quantized.py::quantized_to``)."""
    with np.load(_npz(path)) as z:
        return tree_from_arrays({key: z[key] for key in z.files})


def artifact_input_hw(qtree: Mapping[str, Any]) -> tuple[int, int] | None:
    """The input (H, W) the artifact's folded stem bias map is bound to
    (None when the normalize was not folded: any input size works)."""
    m = qtree.get("stem_bias_map")
    if m is None:
        return None
    h, w = int(m.shape[0]), int(m.shape[1])
    # the bias map lives at the stride-2 stem-output resolution
    stem_rows = int(qtree["qkernels"]["stem"].shape[2])
    return (2 * h, 2 * w) if stem_rows in (4, 7) else (h, w)


def training_calibration_batches(
    cfg, level: int, n_batches: int = 4, batch_size: int = 128,
    input_size: int | None = None, seed: int = 0, dataset=None,
) -> list[np.ndarray]:
    """Random training-tissue batches at the deployment input size, sampled
    across **all** training slides of the level, so that the max-abs
    activation scales reflect the tissue distribution rather than one
    slide's first band. ``dataset=None`` loads the level's manifest; a given
    ``PatchDataset`` serves installations without pyarrow."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        INPUT_SIZE,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        load_or_scan_manifest,
    )

    if dataset is None:
        manifest = load_or_scan_manifest(cfg.data.patches_dir, level)
        dataset = PatchDataset(manifest, resize_to=input_size or INPUT_SIZE)
    n = len(dataset)
    if n == 0:
        raise FileNotFoundError(f"no patches at level {level} to calibrate on")
    order = np.random.default_rng(seed).permutation(n)
    out = []
    for start in range(0, min(n, n_batches * batch_size), batch_size):
        imgs, _labels = dataset.read_batch(order[start : start + batch_size])
        out.append(np.asarray(imgs))
    return out


def quantize_classifier_to_artifact(
    cfg, level: int = 3, n_batches: int = 4, batch_size: int = 128,
    dataset=None, device: str | torch.device = "cuda",
) -> str:
    """Calibrate the trained classifier
    (``<models_dir>/resnet18_patch_classifier.pt``) on training tissue, on
    ``device``, and persist the quantized tree as
    ``<models_dir>/quantized_resnet18.npz``."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quantize_resnet18,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
        model_artifact_path,
    )

    state = load_model(model_artifact_path(cfg.models_dir,
                                           "resnet18_patch_classifier"))
    batches = training_calibration_batches(
        cfg, level, n_batches=n_batches, batch_size=batch_size, dataset=dataset
    )
    q = quantize_resnet18(state, batches, device=device)
    return save_quantized(os.path.join(cfg.models_dir, CLASSIFIER_ARTIFACT),
                          q.tree())


def quantize_trunk_to_artifact(
    cfg, levels=(2, 3), n_batches: int = 4, batch_size: int = 64,
    dataset=None, device: str | torch.device = "cuda",
) -> str:
    """Calibrate the multiscale classifier's SHARED trunk
    (``<models_dir>/hierarchical_classifier.pt``) on co-located training
    cells, all scales stacked as the multiscale int8 step feeds it, on
    ``device``, and persist ``<models_dir>/quantized_hierarchical_trunk.npz``.
    ``dataset=None`` joins the levels' manifests in the artifact's input
    mode (0 = resize, 1 = crop); a given ``MultiscaleDataset`` serves
    installations without pyarrow."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
        INPUT_SIZE,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.multiscale import (
        MultiscaleDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        split_calibration,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
        quantize_resnet18,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
        load_model,
        model_artifact_path,
    )

    state, calibration = split_calibration(load_model(model_artifact_path(
        cfg.models_dir, "hierarchical_classifier")))
    trunk = {k.removeprefix("trunk."): v for k, v in state.items()
             if k.startswith("trunk.")}
    if dataset is None:
        # calibration batches must reach the trunk the way inference feeds
        # it: the artifact's fine-stream input mode
        input_mode = ("crop" if int(calibration.get("input_mode", 0)) == 1
                      else "resize")
        dataset = MultiscaleDataset.from_patches_dir(
            cfg.data.patches_dir, levels=levels, resize_to=INPUT_SIZE,
            input_mode=input_mode)
    if len(dataset) == 0:
        raise FileNotFoundError(
            f"no aligned multiscale cells at levels {tuple(levels)} to "
            f"calibrate on")
    order = np.random.default_rng(0).permutation(len(dataset))
    batches = []
    for start in range(0, min(len(dataset), n_batches * batch_size),
                       batch_size):
        imgs, _labels = dataset.read_batch(order[start : start + batch_size])
        batches.append(np.concatenate([imgs[lvl] for lvl in dataset.levels]))
    q = quantize_resnet18(trunk, batches, device=device)
    return save_quantized(os.path.join(cfg.models_dir, TRUNK_ARTIFACT),
                          q.tree())


def maybe_load_artifact(models_dir: str, name: str) -> dict[str, Any] | None:
    """Load a persisted quantization artifact if present (the int8
    consumers' lookup); None → callers fall back to lazy calibration."""
    path = os.path.join(models_dir, name)
    if not os.path.exists(path):
        return None
    log.info("using persisted quantization artifact: %s", path)
    return load_quantized(path)
