"""Patch labeling and tissue filtering on the host.

Copies of the JAX package's ``grid/labeling.py`` host functions, held to
the originals by exact tests:

- a patch is **tumor** iff any mask pixel > 0 lies inside its window, else
  normal; slides without an annotation are all normal;
- a patch is **background** iff its mean RGB value is above 240, taken on
  the white-padded patch.
"""

from __future__ import annotations

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    TISSUE_MEAN_RGB_THRESHOLD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    LABEL_NAMES,
)

LABEL_NORMAL = 0
LABEL_TUMOR = 1
__all__ = ["LABEL_NAMES", "LABEL_NORMAL", "LABEL_TUMOR", "is_tissue_host",
           "patch_labels_from_mask_host"]


def is_tissue_host(patch: np.ndarray,
                   threshold: float = TISSUE_MEAN_RGB_THRESHOLD) -> bool:
    """True when the patch holds tissue (mean RGB <= threshold)."""
    return float(np.mean(patch)) <= threshold


def patch_labels_from_mask_host(
    mask: np.ndarray | None,
    coords: np.ndarray,
    patch_size: int,
) -> np.ndarray:
    """Labels for patches at level-space ``coords`` (N, 2) of (x, y), given
    a (H, W) mask (0/255) already padded to the grid, or None (no
    annotation: all normal)."""
    n = len(coords)
    if mask is None:
        return np.full((n,), LABEL_NORMAL, dtype=np.int32)
    labels = np.empty((n,), dtype=np.int32)
    for i, (x, y) in enumerate(coords):
        window = mask[y : y + patch_size, x : x + patch_size]
        labels[i] = LABEL_TUMOR if np.any(window > 0) else LABEL_NORMAL
    return labels
