"""The patch-feature artifact triplet on disk.

Copies of the JAX package's ``infer/features.py::_save_artifacts`` and
``load_feature_artifacts``, held to the originals by exact tests: per level
``L``, ``patch_features_{L}.npy`` (N, D) float32, ``patch_labels_{L}.npy``
(N,) and ``patch_paths_{L}.txt`` (one patch name a line, the reference's
``{slide}_x{x}_y{y}_{label}.png``). The MIL trainer builds its bags from
them. Feature extraction itself (``--extract_features``, which spools the
features into a memmap of the artifact that the JAX ``_save_artifacts``
then only flushes) comes with a later slice.
"""

from __future__ import annotations

import os

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("infer.features")


def _save_artifacts(
    features_dir: str, level: int, feats: np.ndarray, labels: np.ndarray,
    names: list[str],
) -> None:
    os.makedirs(features_dir, exist_ok=True)
    np.save(os.path.join(features_dir, f"patch_features_{level}.npy"), feats)
    np.save(os.path.join(features_dir, f"patch_labels_{level}.npy"), labels)
    with open(os.path.join(features_dir, f"patch_paths_{level}.txt"), "w") as f:
        f.write("\n".join(names))
    log.info(
        "Saved features %s (shape %s) to %s", level, feats.shape, features_dir
    )


def load_feature_artifacts(
    features_dir: str, level: int
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    feats = np.load(os.path.join(features_dir, f"patch_features_{level}.npy"))
    labels = np.load(os.path.join(features_dir, f"patch_labels_{level}.npy"))
    with open(os.path.join(features_dir, f"patch_paths_{level}.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    return feats, labels, names
