"""Patch-grid arithmetic of one slide level.

Copy of the part of the JAX package's ``grid/pyramid.py`` that slide
inference and extraction use, held to the original by exact-equality tests:
per-level patch sizes, stride, pad-to-grid, level → level-0 coordinates, a
border patch's in-bounds extent and the area that truncation would lose.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    PATCH_SIZES,
)


def patch_size_for_level(level: int, default: int = 224) -> int:
    """Per-level patch edge length."""
    return PATCH_SIZES.get(level, default)


def padded_extent(extent: int, patch_size: int) -> int:
    """Smallest multiple of ``patch_size`` >= ``extent``."""
    pad = (patch_size - extent % patch_size) % patch_size
    return extent + pad


@dataclasses.dataclass(frozen=True)
class PatchGrid:
    """The stride-grid covering one slide level.

    Coordinates are level-space pixels of the patch top-left corner. Grid
    positions whose top-left corner falls outside the unpadded image are
    excluded; border patches are white-padded to full size by the reader.
    """

    level: int
    width: int  # level-space width
    height: int  # level-space height
    downsample: float  # level-0 pixels per level pixel
    patch_size: int
    stride: int

    @classmethod
    def for_slide_level(
        cls,
        level: int,
        level_dims: tuple[int, int],
        downsample: float,
        stride: int | None = None,
    ) -> "PatchGrid":
        ps = patch_size_for_level(level)
        return cls(
            level=level,
            width=level_dims[0],
            height=level_dims[1],
            downsample=downsample,
            patch_size=ps,
            stride=stride or ps,
        )

    @property
    def padded_width(self) -> int:
        return padded_extent(self.width, self.patch_size)

    @property
    def padded_height(self) -> int:
        return padded_extent(self.height, self.patch_size)

    @property
    def nx(self) -> int:
        """Number of grid columns with top-left inside the image."""
        return -(-self.width // self.stride)

    @property
    def ny(self) -> int:
        return -(-self.height // self.stride)

    @property
    def num_patches(self) -> int:
        return self.nx * self.ny

    def coords(self) -> Iterator[tuple[int, int]]:
        """Yield (x, y) level-space top-left corners, outer loop over x,
        inner over y (the reference enumeration)."""
        for x in range(0, self.padded_width, self.stride):
            if x >= self.width:
                continue
            for y in range(0, self.padded_height, self.stride):
                if y >= self.height:
                    continue
                yield x, y

    def coords_array(self) -> np.ndarray:
        """All (x, y) corners as an (N, 2) int32 array, reference order."""
        out = np.array(list(self.coords()), dtype=np.int32)
        return out.reshape(-1, 2)

    def level0_origin(self, x: int, y: int) -> tuple[int, int]:
        """Map a level-space corner to the level-0 pixel origin of a region
        read."""
        return int(x * self.downsample), int(y * self.downsample)

    def valid_patch_extent(self, x: int, y: int) -> tuple[int, int]:
        """(w, h) of the in-bounds part of the patch at (x, y)."""
        return (
            min(self.patch_size, self.width - x),
            min(self.patch_size, self.height - y),
        )

    def coverage_loss_without_padding(self) -> float:
        """Fraction of the level's area that truncating to whole patches
        instead of padding would leave out."""
        covered_w = (self.width // self.patch_size) * self.patch_size
        covered_h = (self.height // self.patch_size) * self.patch_size
        total = self.width * self.height
        return 1.0 - (covered_w * covered_h) / total
