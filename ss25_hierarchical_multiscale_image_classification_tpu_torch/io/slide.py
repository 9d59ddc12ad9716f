"""Slide readers: the pyramidal WSI abstraction.

Copy of the JAX package's ``io/slide.py``, held to the original by
exact-equality tests: the :class:`Slide` protocol, the in-memory
:class:`ArraySlide`, the ``.wsi.npz`` :class:`NpzSlide`, and
:func:`open_slide`, which opens ``.tif``/``.tiff`` slides (CAMELYON16's
tiled BigTIFFs) as ``io/tiff_slide.py::TiffSlide`` on the port's native
decoder.

Coordinates follow OpenSlide: ``read_region(location, level, size)`` takes
``location`` in level-0 pixels and ``size`` in level pixels, and returns an
(H, W, 3) uint8 RGB array.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Slide(Protocol):
    @property
    def level_count(self) -> int: ...

    @property
    def level_dimensions(self) -> Sequence[tuple[int, int]]: ...

    @property
    def level_downsamples(self) -> Sequence[float]: ...

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray: ...

    def close(self) -> None: ...


class ArraySlide:
    """A pyramid held as a list of (H, W, 3) uint8 arrays (level 0 first)."""

    def __init__(self, levels: Sequence[np.ndarray], properties: dict | None = None):
        if not levels:
            raise ValueError("ArraySlide needs at least one level")
        self._levels = [np.ascontiguousarray(lv, dtype=np.uint8) for lv in levels]
        self._dims = [(lv.shape[1], lv.shape[0]) for lv in self._levels]
        base_w = self._dims[0][0]
        self._downsamples = [base_w / lv.shape[1] for lv in self._levels]
        self.properties = dict(properties or {})

    @property
    def level_count(self) -> int:
        return len(self._levels)

    @property
    def level_dimensions(self) -> list[tuple[int, int]]:
        return list(self._dims)

    @property
    def level_downsamples(self) -> list[float]:
        return list(self._downsamples)

    def level_array(self, level: int) -> np.ndarray:
        return self._levels[level]

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray:
        """OpenSlide-convention region read; out-of-bounds area is white."""
        ds = self._downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        w, h = int(size[0]), int(size[1])
        lv = self._levels[level]
        out = np.full((h, w, 3), 255, dtype=np.uint8)
        x1, y1 = max(x0, 0), max(y0, 0)
        x2 = min(x0 + w, lv.shape[1])
        y2 = min(y0 + h, lv.shape[0])
        if x2 > x1 and y2 > y1:
            out[y1 - y0 : y2 - y0, x1 - x0 : x2 - x0] = lv[y1:y2, x1:x2]
        return out

    def close(self) -> None:
        pass


class NpzSlide(ArraySlide):
    """Pyramid persisted as ``.wsi.npz`` (keys level_0..level_N)."""

    def __init__(self, path: str):
        with np.load(path) as data:
            keys = sorted(
                (k for k in data.files if k.startswith("level_")),
                key=lambda k: int(k.split("_")[1]),
            )
            levels = [data[k] for k in keys]
        super().__init__(levels, properties={"path": path, "format": "npz"})


def save_npz_slide(
    path: str, levels: Sequence[np.ndarray], compress: bool = False
) -> None:
    """Write a ``.wsi.npz`` pyramid, uncompressed by default (noise textures
    barely compress and deflating them is slow); :class:`NpzSlide` reads
    both."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    writer = np.savez_compressed if compress else np.savez
    writer(
        path, **{f"level_{i}": np.asarray(lv, np.uint8) for i, lv in enumerate(levels)}
    )


def open_slide(path: str) -> Slide:
    """Open any supported slide container by extension."""
    if path.endswith(".npz"):
        return NpzSlide(path)
    if path.endswith((".tif", ".tiff")):
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.tiff_slide import (
            TiffSlide,
        )

        return TiffSlide(path)
    raise ValueError(f"Unsupported slide container: {path}")
