"""Polygon → binary mask rasterization, in numpy alone.

Counterpart of the JAX package's ``grid/rasterize.py`` (``scale_polygons``,
``polygons_to_mask``, ``polygons_to_mask_band``). The JAX package draws the
masks with PIL (``ImageDraw.polygon(outline=255, fill=255)``), which the
card's machine lacks; here an even-odd scanline fill at pixel centres plus a
one-pixel outline along every edge take its place. The tests hold the two
at the level of patch labels (any mask pixel > 0 in a patch window, the only
consumer of the mask) and count the pixels where they differ, which lie on
the outline.

``scale_polygons`` is a copy, held to the original by an exact test.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def scale_polygons(
    polygons_level0: Sequence[np.ndarray],
    level_dims: tuple[int, int],
    base_dims: tuple[int, int],
) -> list[np.ndarray]:
    """Scale level-0 (x, y) float polygons to integer level coordinates,
    truncating as the reference's ``int(x * scale_x)`` does."""
    scale_x = level_dims[0] / base_dims[0]
    scale_y = level_dims[1] / base_dims[1]
    out = []
    for poly in polygons_level0:
        poly = np.asarray(poly, dtype=np.float64)
        scaled = np.empty_like(poly, dtype=np.int64)
        scaled[:, 0] = (poly[:, 0] * scale_x).astype(np.int64)
        scaled[:, 1] = (poly[:, 1] * scale_y).astype(np.int64)
        out.append(scaled)
    return out


def _fill_polygon(mask: np.ndarray, poly: np.ndarray) -> None:
    """Set the pixels of ``mask`` (H, W) that ``poly`` (K, 2) of (x, y)
    vertices covers to 255: even-odd fill at pixel centres (pixel (x, y)
    sits at the integer point (x, y)), then a one-pixel line along each
    edge. Vertices may be fractional and may lie outside the mask."""
    h, w = mask.shape
    poly = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    if len(poly) == 0:
        return
    if len(poly) == 1:
        x, y = np.rint(poly[0]).astype(np.int64)
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = 255
        return
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)

    # fill: rows whose centre lies within the polygon's y extent
    r_lo = max(int(np.ceil(y0.min())), 0)
    r_hi = min(int(np.floor(y0.max())), h - 1)
    if r_lo <= r_hi:
        ys = np.arange(r_lo, r_hi + 1, dtype=np.float64)[:, None]  # (R, 1)
        crosses = ((y0 <= ys) & (y1 > ys)) | ((y1 <= ys) & (y0 > ys))
        dy = np.where(y1 == y0, 1.0, y1 - y0)
        x_at = np.where(crosses, x0 + (ys - y0) * (x1 - x0) / dy, np.inf)
        if x_at.shape[1] % 2:
            x_at = np.pad(x_at, ((0, 0), (0, 1)), constant_values=np.inf)
        x_at.sort(axis=1)  # each row: an even number of finite crossings
        # pixel x is inside iff an odd number of crossings lie at or left
        # of it: the spans [ceil(x_2k), ceil(x_2k+1)) of each row, counted
        # in the columns [c_lo, c_hi) that the polygon spans
        c_lo = min(max(int(np.floor(x0.min())), 0), w)
        c_hi = min(max(int(np.ceil(x0.max())) + 1, c_lo), w)
        starts = np.clip(np.ceil(x_at[:, 0::2]), c_lo, c_hi) - c_lo
        ends = np.clip(np.ceil(x_at[:, 1::2]), c_lo, c_hi) - c_lo
        rows, k = np.nonzero(np.isfinite(x_at[:, 0::2]) & (ends > starts))
        diff = np.zeros((len(ys), c_hi - c_lo + 1), np.int32)
        np.add.at(diff, (rows, starts[rows, k].astype(np.int64)), 1)
        np.add.at(diff, (rows, ends[rows, k].astype(np.int64)), -1)
        inside = np.cumsum(diff[:, :-1], axis=1) > 0
        mask[r_lo:r_hi + 1, c_lo:c_hi][inside] = 255

    # outline: each edge sampled at one point per pixel step
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        n = int(np.ceil(max(abs(bx - ax), abs(by - ay)))) + 1
        t = np.linspace(0.0, 1.0, n)
        px = np.rint(ax + t * (bx - ax)).astype(np.int64)
        py = np.rint(ay + t * (by - ay)).astype(np.int64)
        keep = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        mask[py[keep], px[keep]] = 255


def polygons_to_mask(
    polygons_level0: Sequence[np.ndarray],
    level_dims: tuple[int, int],
    base_dims: tuple[int, int],
) -> np.ndarray:
    """Rasterize filled polygons (with outline) into a (H, W) uint8 mask of
    0/255 at the level whose (width, height) is ``level_dims``; the level-0
    vertices are scaled and truncated by :func:`scale_polygons`."""
    return polygons_to_mask_band(polygons_level0, level_dims, base_dims)


def polygons_to_mask_band(
    polygons_level0: Sequence[np.ndarray],
    level_dims: tuple[int, int],
    base_dims: tuple[int, int],
    x0: int = 0,
    y0: int = 0,
    band_w: int | None = None,
    band_h: int | None = None,
) -> np.ndarray:
    """The window ``[x0, x0+band_w) × [y0, y0+band_h)`` of
    :func:`polygons_to_mask`'s mask. Integer offsets move no crossing, so a
    window equals the crop of the full mask exactly, at any x0 and y0."""
    W, H = int(level_dims[0]), int(level_dims[1])
    bw = min(band_w if band_w is not None else W - x0, W - x0)
    bh = min(band_h if band_h is not None else H - y0, H - y0)
    if bw <= 0 or bh <= 0:
        return np.zeros((max(bh, 0), max(bw, 0)), np.uint8)
    mask = np.zeros((bh, bw), np.uint8)
    for poly in scale_polygons(polygons_level0, level_dims, base_dims):
        if len(poly) == 0:
            continue
        _fill_polygon(mask, poly - np.array([x0, y0]))
    return mask


def fill_polygons(polygons: Sequence[np.ndarray], width: int, height: int
                  ) -> np.ndarray:
    """(height, width) bool mask of ``polygons`` given in pixel coordinates
    of that canvas, vertices as they are (fractional ones too)."""
    mask = np.zeros((height, width), np.uint8)
    for poly in polygons:
        _fill_polygon(mask, poly)
    return mask > 0
