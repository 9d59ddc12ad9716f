"""Patch labeling and tissue filtering.

Copies of the JAX package's ``grid/labeling.py`` host functions, held to
the originals by exact tests, and its batch versions (``is_tissue``,
``patch_labels_from_mask``) as torch functions on the tensor's device:

- a patch is **tumor** iff any mask pixel > 0 lies inside its window, else
  normal; slides without an annotation are all normal;
- a patch is **background** iff its mean RGB value is above 240, taken on
  the white-padded patch.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    TISSUE_MEAN_RGB_THRESHOLD,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    LABEL_NAMES,
)

LABEL_NORMAL = 0
LABEL_TUMOR = 1
__all__ = ["LABEL_NAMES", "LABEL_NORMAL", "LABEL_TUMOR", "is_tissue",
           "is_tissue_host", "patch_labels_from_mask",
           "patch_labels_from_mask_host", "tissue_sum_limit"]


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


def tissue_sum_limit(threshold: float, count: int) -> int:
    """The largest integer sum of ``count`` values whose mean is at most
    ``threshold``: ``floor(threshold · count)``, taken exactly."""
    return math.floor(Fraction(threshold) * count)


def is_tissue(patches: torch.Tensor,
              threshold: float = TISSUE_MEAN_RGB_THRESHOLD) -> torch.Tensor:
    """(N,) bool on the batch's device, True where the patch holds tissue
    (mean RGB <= threshold), for an (N, H, W, 3) batch.

    A uint8 batch is summed in int64 (a 1792² patch sums to up to 2.46·10⁹,
    past int32) and held to :func:`tissue_sum_limit`, so the partition is
    the one of the host filter's float64 mean (``data/extract.py``: the sum
    is exact below 2⁵³, and for an integer threshold the mean's rounding
    cannot cross it). The JAX function's float32 mean can differ from it
    only where the exact mean lies within float32 rounding of the
    threshold. A float batch takes the float64 mean."""
    flat = patches.reshape(patches.shape[0], -1)
    if patches.dtype.is_floating_point:
        return flat.double().mean(dim=1) <= threshold
    sums = flat.sum(dim=1, dtype=torch.int64)
    return sums <= tissue_sum_limit(threshold, flat.shape[1])


def patch_labels_from_mask(mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Any-pool labeling of a full grid: an (H, W) mask, H and W multiples
    of ``patch_size`` (pad first), to the (H // patch_size, W // patch_size)
    int32 grid of {0, 1} labels indexed [y_idx, x_idx]."""
    H, W = mask.shape
    gh, gw = H // patch_size, W // patch_size
    tiles = mask.reshape(gh, patch_size, gw, patch_size)
    return (tiles > 0).any(dim=3).any(dim=1).to(torch.int32)
