"""Batched feature extraction over a patch level, and its artifact triplet.

Counterpart of the JAX package's ``infer/features.py``
(``make_feature_step``, ``run_feature_extraction``, ``_features_memmap``,
``_save_artifacts``, ``extract_features``, ``extract_features_with_simclr``,
``load_feature_artifacts``): the fc-stripped ResNet18 runs over every patch
of a level and writes, per level ``L``,

    features/patch_features_{L}.npy   (N, 512) float32
    features/patch_labels_{L}.npy     (N,) int
    features/patch_paths_{L}.txt      N patch names, one a line

in manifest order (names are the reference's ``{slide}_x{x}_y{y}_{label}.png``).
The MIL trainer builds its bags from them.

:func:`run_feature_extraction` runs the inference-folded forward
(``models/quantized.py``): it consumes raw uint8 batches, its stem runs on
the hand-written ``bias_relu_pool`` kernel (or, with ``stem_s2d=True``, the
``fused_stem`` kernel). Host batch gathering runs on a
:class:`~..data.prefetch.Prefetcher` thread; on the card each batch goes up
through one of two pinned buffers, and each step's features come down on a
copy stream into pinned memory, read with a one-batch lag: batch k−1's
features reach the host while batch k computes. With ``int8=True`` the
loop runs the int8 (w8a8) forward instead (``quant_forward``: every
convolution on the port's int8 kernels), from a persisted artifact or from
scales calibrated on the first dataset batches; features stay float32.

With a process ``group`` (``torchrun``, one process a card: ``parallel/``)
the loop is the JAX function's over its mesh: every rank walks the same
batches and runs its contiguous rows of each global batch (the stem and
int8 kernels on those rows); the rows' features are summed into a zeroed
global batch over the group (exact: every entry is one rank's value plus
zeros), so every rank holds the features in the original row order, and
rank 0 alone writes the triplet. Without an artifact rank 0 calibrates
the int8 scales on the first batches and every rank takes its tree
(broadcast), so the ranks' trees are bit-identical.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.augment import (
    normalize,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
    BatchIterator,
    PatchDataset,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    load_or_scan_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.prefetch import (
    Prefetcher,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    Timer,
    get_logger,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
    strip_head,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quant_artifact import (
    CLASSIFIER_ARTIFACT,
    maybe_load_artifact,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.quantized import (
    fold_resnet18_inference,
    folded_forward_inference,
    folded_to,
    quant_forward,
    quantize_resnet18,
    quantized_to,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
    process_batch_slice,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    is_main,
    rank_and_size,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.checkpoints import (
    load_model,
    model_artifact_path,
)

log = get_logger("infer.features")


def make_feature_step(model):
    """The unfolded route: ``feature_step(imgs_u8)`` normalizes a uint8 NHWC
    batch and runs ``model`` (a ``ResNet18FeatureExtractor`` in eval mode) in
    its parameters' dtype. :func:`run_feature_extraction` runs the folded
    forward instead; this is the plain forward it is held against."""
    dtype = next(model.parameters()).dtype

    @torch.inference_mode()
    def feature_step(imgs_u8: torch.Tensor) -> torch.Tensor:
        return model(normalize(imgs_u8, dtype))

    return feature_step


def _calibration_batches(dataset: PatchDataset, batch_size: int,
                         n_batches: int = 2) -> list[np.ndarray]:
    """First few dataset batches, for int8 activation-scale calibration."""
    out = []
    for imgs, _labels, _valid in BatchIterator(
        dataset, min(batch_size, 256), shuffle=False
    ):
        out.append(np.asarray(imgs))
        if len(out) >= n_batches:
            break
    return out


def lazy_qtree(state: dict[str, torch.Tensor], dataset: PatchDataset,
               batch_size: int, device: str | torch.device, group=None
               ) -> dict:
    """The int8 tree of the ResNet18 ``state`` (``quantized_to``'s, on
    ``device``) with its activation scales calibrated on the first dataset
    batches. With a ``group`` rank 0 alone calibrates and every rank takes
    its tree (broadcast), so the ranks' trees are bit-identical."""
    dev = resolve_device(device)
    qtree = None
    if is_main(group):
        qtree = quantize_resnet18(
            state, _calibration_batches(dataset, batch_size), device=dev
        ).tree()
        if group is not None:  # pickled without a device
            qtree = quantized_to(qtree, "cpu")
    return quantized_to(broadcast_object(qtree, group), dev)


def _rows_to_global(feats: torch.Tensor, group, rank: int, world: int
                    ) -> torch.Tensor:
    """This rank's (b, D) rows → the (world·b, D) float32 global batch on
    every rank, rank r's rows at [r·b, (r+1)·b)."""
    import torch.distributed as dist

    b = feats.shape[0]
    out = feats.new_zeros((world * b, *feats.shape[1:]), dtype=torch.float32)
    out[rank * b:(rank + 1) * b] = feats
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def run_feature_extraction(
    dataset: PatchDataset,
    state: dict[str, torch.Tensor],
    batch_size: int = 512,
    dtype: torch.dtype | None = None,
    out: np.ndarray | None = None,
    feature_dim: int = 512,
    device: str | torch.device = "cuda",
    stem_s2d: bool = False,
    int8: bool = False,
    qtree: dict | None = None,
    group=None,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Forward every patch through the extractor; returns
    (features (N, ``feature_dim``) float32, labels (N,), patch names).

    ``state`` is a ResNet18 state dict (a head, if any, is ignored).
    ``dtype`` defaults to bfloat16 on the card and float32 on the CPU. With
    ``out`` (e.g. a ``.npy`` memmap) features spool incrementally. Only the
    ``n_valid`` real rows of a wrap-padded last batch are kept.
    ``stem_s2d`` selects the space-to-depth stem of
    ``fold_resnet18_inference``.

    ``int8=True`` post-training-quantizes the trunk (w8a8) and runs
    ``quant_forward``: from ``qtree`` (a persisted artifact) if given, else
    with scales calibrated on the first dataset batches. With a
    space-to-depth stem the dataset's host gather emits the (B, H/2, W/2, 12)
    layout directly, the same bytes, and the device transposes nothing.

    ``group``: one rank of the data-parallel extraction (``batch_size`` is
    the global batch, which the group's size must divide); every rank
    returns the features of every row (module docstring).
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rank, world = rank_and_size(group)
    rows = process_batch_slice(batch_size, rank, world)
    if int8:
        qtree = (quantized_to(qtree, dev) if qtree is not None
                 else lazy_qtree(state, dataset, batch_size, dev, group))
        if int(qtree["qkernels"]["stem"].shape[-1]) == 4:
            dataset = dataclasses.replace(dataset, s2d=True)

        def forward(x: torch.Tensor) -> torch.Tensor:
            return quant_forward(qtree, x, with_fc=False)
    else:
        if dtype is None:
            dtype = torch.bfloat16 if on_card else torch.float32
        hw = int(getattr(dataset, "resize_to", 224) or 224)
        fp = folded_to(
            fold_resnet18_inference(state, input_hw=(hw, hw),
                                    stem_s2d=stem_s2d, dtype=dtype),
            dev,
        )

        def forward(x: torch.Tensor) -> torch.Tensor:
            return folded_forward_inference(fp, x, with_fc=False)

    batches = Prefetcher(BatchIterator(dataset, batch_size, shuffle=False,
                                       rows=rows))
    n_total = len(dataset)
    if out is None:
        out = np.empty((n_total, feature_dim), np.float32)

    if on_card:
        copy_stream = torch.cuda.Stream(dev)
        staged = [None, None]  # pinned upload buffers, shaped by the batches
        uploaded = [None, None]  # event: the slot's last upload has finished
        fetched = [torch.empty((batch_size, feature_dim), dtype=torch.float32,
                               pin_memory=True) for _ in range(2)]

    def step(k: int, imgs: np.ndarray):
        """Enqueue batch k; returns what :func:`spool` needs to read it."""
        if not on_card:
            return forward_rows(torch.from_numpy(imgs)), None
        slot = k % 2
        if staged[slot] is None:
            staged[slot] = torch.empty(imgs.shape, dtype=torch.uint8,
                                       pin_memory=True)
        else:
            uploaded[slot].synchronize()
        staged[slot].copy_(torch.from_numpy(imgs))
        x = staged[slot].to(dev, non_blocking=True)
        uploaded[slot] = torch.cuda.Event()
        uploaded[slot].record()
        feats = forward_rows(x)
        copy_stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(copy_stream):
            fetched[slot].copy_(feats, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        feats.record_stream(copy_stream)
        return fetched[slot], done

    def forward_rows(x: torch.Tensor) -> torch.Tensor:
        """The features of the global batch: this rank's, or every rank's
        rows in order."""
        feats = forward(x)
        if group is None:
            return feats
        return _rows_to_global(feats, group, rank, world)

    def spool(pending) -> None:
        (feats, done), n_valid, at = pending
        if done is not None:
            done.synchronize()
        out[at : at + n_valid] = feats[:n_valid].numpy()

    pos = 0
    pending = None
    with Timer(f"feature_extraction[{n_total} patches]", log), \
            torch.inference_mode():
        for k, (imgs, _labels, valid) in enumerate(batches):
            result = step(k, imgs)
            if pending is not None:
                spool(pending)
            n_valid = int(valid.sum()) if group is None else _global_valid(
                k, batch_size, n_total)
            pending = (result, n_valid, pos)
            pos += n_valid
        if pending is not None:
            spool(pending)

    labels = dataset.labels
    names = [rec.patch_name for rec in dataset.manifest]
    return out[:pos], labels, names


def _global_valid(k: int, batch_size: int, n_total: int) -> int:
    """The real rows of global batch ``k`` of a walk over ``n_total``."""
    return min(batch_size, n_total - k * batch_size)


def _features_memmap(features_dir: str, level: int, n: int,
                     feature_dim: int = 512) -> np.ndarray:
    """Preallocate ``patch_features_{L}.npy`` as a writable memmap so the
    extraction loop spools features straight into the artifact."""
    os.makedirs(features_dir, exist_ok=True)
    path = os.path.join(features_dir, f"patch_features_{level}.npy")
    return np.lib.format.open_memmap(
        path, mode="w+", dtype=np.float32, shape=(n, feature_dim)
    )


def _save_artifacts(
    features_dir: str, level: int, feats: np.ndarray, labels: np.ndarray,
    names: list[str],
) -> None:
    os.makedirs(features_dir, exist_ok=True)
    if isinstance(feats, np.memmap):
        feats.flush()  # spooled incrementally during extraction
    else:
        np.save(
            os.path.join(features_dir, f"patch_features_{level}.npy"), feats
        )
    np.save(os.path.join(features_dir, f"patch_labels_{level}.npy"), labels)
    with open(os.path.join(features_dir, f"patch_paths_{level}.txt"), "w") as f:
        f.write("\n".join(names))
    log.info(
        "Saved features %s (shape %s) to %s", level, feats.shape, features_dir
    )


def _level_dataset(cfg: Config, level: int,
                   dataset: PatchDataset | None) -> PatchDataset:
    if dataset is None:
        manifest = load_or_scan_manifest(cfg.data.patches_dir, level)
        if len(manifest) == 0:
            raise FileNotFoundError(f"no patches at level {level}")
        dataset = PatchDataset(manifest)
    return dataset


def _extract(cfg: Config, level: int, trunk: dict[str, torch.Tensor],
             dataset: PatchDataset, batch_size: int | None,
             device: str | torch.device | None, int8: bool = False,
             qtree: dict | None = None, group=None) -> np.ndarray:
    dev = resolve_device("cuda" if device is None else device)
    feature_dim = int(trunk["layer4.1.conv2.weight"].shape[0])
    main = is_main(group)
    out = (_features_memmap(cfg.data.features_dir, level, len(dataset),
                            feature_dim) if main else None)
    feats, labels, names = run_feature_extraction(
        dataset, trunk, batch_size or cfg.train.batch_size, out=out,
        feature_dim=feature_dim, device=dev, int8=int8, qtree=qtree,
        group=group,
    )
    if main:
        _save_artifacts(cfg.data.features_dir, level, feats, labels, names)
    barrier(group)
    return feats


def extract_features(
    cfg: Config, level: int = 3, model_path: str | None = None,
    batch_size: int | None = None, dataset: PatchDataset | None = None,
    device: str | torch.device | None = None, int8: bool = False,
    group=None,
) -> np.ndarray:
    """Classifier-trunk feature extraction: loads the trained classifier
    (``<models_dir>/resnet18_patch_classifier.pt``), strips the fc head and
    writes the level's triplet under ``cfg.data.features_dir``. Runs on the
    card unless ``device`` says otherwise. ``dataset=None`` loads the
    level's manifest; a given dataset serves installations without
    pyarrow. ``int8=True`` runs the int8 forward, from
    ``<models_dir>/quantized_resnet18.npz`` when ``--quantize`` wrote one.
    ``group``: one rank of the data-parallel extraction (rank 0 writes)."""
    dataset = _level_dataset(cfg, level, dataset)
    model_path = model_path or model_artifact_path(
        cfg.models_dir, "resnet18_patch_classifier")
    trunk = strip_head(load_model(model_path))
    qtree = None
    if int8:
        qtree = maybe_load_artifact(cfg.models_dir, CLASSIFIER_ARTIFACT)
    return _extract(cfg, level, trunk, dataset, batch_size, device, int8,
                    qtree, group)


def extract_features_with_simclr(
    cfg: Config, level: int = 3, encoder_path: str | None = None,
    batch_size: int | None = None, dataset: PatchDataset | None = None,
    device: str | torch.device | None = None, int8: bool = False,
    group=None,
) -> np.ndarray:
    """SimCLR-encoder feature extraction: reads the ``simclr_encoder.pt``
    that ``pretrain_simclr`` writes and takes its ``encoder.`` entries (a
    bare encoder state dict is taken as it is). ``int8=True`` quantizes the
    encoder with scales calibrated on the first dataset batches.
    ``group``: one rank of the data-parallel extraction (rank 0 writes)."""
    dataset = _level_dataset(cfg, level, dataset)
    encoder_path = encoder_path or model_artifact_path(cfg.models_dir,
                                                       "simclr_encoder")
    sd = load_model(encoder_path)
    if any(k.startswith("encoder.") for k in sd):
        sd = {k.removeprefix("encoder."): v for k, v in sd.items()
              if k.startswith("encoder.")}
    return _extract(cfg, level, strip_head(sd), dataset, batch_size, device,
                    int8, group=group)


def load_feature_artifacts(
    features_dir: str, level: int
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    feats = np.load(os.path.join(features_dir, f"patch_features_{level}.npy"))
    labels = np.load(os.path.join(features_dir, f"patch_labels_{level}.npy"))
    with open(os.path.join(features_dir, f"patch_paths_{level}.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    return feats, labels, names
