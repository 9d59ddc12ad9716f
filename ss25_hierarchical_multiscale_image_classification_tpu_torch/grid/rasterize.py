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

:func:`polygons_to_mask_device` is the counterpart of the JAX package's
device rasterizer ``polygons_to_mask_jax`` (the on-device extraction's),
as torch ops, equal to it bit for bit; :func:`pad_polygons` (a copy) packs
its input.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
    resolve_device,
)


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


# ---------------------------------------------------------------------------
# Device rasterizer
# ---------------------------------------------------------------------------

#: Bytes of intermediates one row tile of :func:`polygons_to_mask_device`
#: may take on its device.
MASK_TILE_BUDGET_BYTES = 256 << 20


def pad_polygons(
    polygons: Sequence[np.ndarray], max_vertices: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length polygons into static-shape arrays.

    Returns:
        verts: (P, V, 2) float32, each polygon's vertices padded by repeating
            its last vertex (repeated vertices contribute zero-length edges).
        valid: (P,) bool, False for all-padding polygon slots.
    """
    polys = [np.asarray(p, dtype=np.float32).reshape(-1, 2) for p in polygons]
    polys = [p for p in polys if len(p) > 0]
    if not polys:
        return np.zeros((1, 3, 2), np.float32), np.zeros((1,), bool)
    V = max_vertices or max(len(p) for p in polys)
    V = max(V, 3)
    packed = np.zeros((len(polys), V, 2), np.float32)
    for i, p in enumerate(polys):
        n = min(len(p), V)
        packed[i, :n] = p[:n]
        packed[i, n:] = p[n - 1]
    return packed, np.ones((len(polys),), bool)


def mask_tile_rows(p: int, v: int, width: int,
                   budget_bytes: int = MASK_TILE_BUDGET_BYTES) -> int:
    """Rows of a tile of :func:`polygons_to_mask_device` under the budget:
    per row ~6 float32/bool/int64 values an edge (P·V) and the crossing
    counts, their running sums and parities (P·(W+1))."""
    per_row = 32 * p * v + 9 * p * (width + 1) + 2 * (width + 1)
    return max(1, int(budget_bytes // per_row))


def polygons_to_mask_device(
    verts,
    valid,
    level_dims: tuple[int, int],
    base_dims: tuple[int, int],
    *,
    device: str | torch.device = "cuda",
    budget_bytes: int = MASK_TILE_BUDGET_BYTES,
) -> torch.Tensor:
    """(H, W) uint8 mask of 0/255 on ``device``: the counterpart of the JAX
    package's ``polygons_to_mask_jax``, equal to it bit for bit: an
    even-odd (crossing-number) fill at pixel centres plus, on every row an
    edge crosses, the pixels at the floor and the ceiling of the crossing.

    Args:
        verts: (P, V, 2) float32 level-0 vertices (see :func:`pad_polygons`).
        valid: (P,) bool polygon validity.
        level_dims: (width, height) of the output mask.
        base_dims: (width, height) of level 0.
        budget_bytes: bytes of intermediates a row tile may take.

    The arithmetic is JAX's, in float32: the vertices scaled by a float32
    ``(level/base)`` pair and floored, the crossing of the row ``y`` at
    ``x0 + ((y − y0)·(x1 − x0)) / dy`` with a true tensor division. JAX
    compares each crossing with every column, which takes O(P·V·W) a row;
    here, exactly as well, a crossing ``x_at`` counts at an integer column x
    when ``ceil(x_at) <= x``, so each crossing adds one to the bin
    ``clamp(ceil(x_at), 0, W)`` and the running sum over x gives the count,
    whose parity is the fill. Rows are independent, so the tile height,
    sized by ``budget_bytes``, does not change the mask.
    """
    dev = resolve_device(device)
    W, H = int(level_dims[0]), int(level_dims[1])
    verts = torch.as_tensor(np.asarray(verts, np.float32)).to(dev)
    valid = torch.as_tensor(np.asarray(valid, bool)).to(dev)
    mask = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    if H == 0 or W == 0:
        return mask
    scale = torch.tensor([level_dims[0] / base_dims[0],
                          level_dims[1] / base_dims[1]],
                         dtype=torch.float32, device=dev)
    v = torch.floor(verts * scale)  # the reference's int() truncation
    v_next = torch.roll(v, -1, dims=1)
    x0, y0 = v[..., 0], v[..., 1]  # (P, V)
    dx = v_next[..., 0] - x0
    y1 = v_next[..., 1]
    dy = y1 - y0
    denom = torch.where(dy == 0, torch.ones_like(dy), dy)
    p, nv = x0.shape
    rows = mask_tile_rows(p, nv, W, budget_bytes)
    for r0 in range(0, H, rows):
        t = min(rows, H - r0)
        yc = torch.arange(r0, r0 + t, dtype=torch.float32,
                          device=dev)[:, None, None]  # (t, 1, 1)
        crosses = ((y0 <= yc) & (y1 > yc)) | ((y1 <= yc) & (y0 > yc))
        crosses &= valid[None, :, None]  # (t, P, V)
        x_at = x0 + (yc - y0) * dx / denom
        # fill: one count a crossing at ceil(x_at), parity of the running sum
        c = torch.ceil(x_at)
        bins = torch.where(crosses, c.clamp(0, W), float(W)).long()
        counts = torch.zeros((t, p, W + 1), dtype=torch.int32, device=dev)
        counts.scatter_add_(2, bins, torch.ones_like(bins, dtype=torch.int32))
        inside = (counts.cumsum(dim=2, dtype=torch.int32)[..., :W] & 1).bool()
        del counts
        filled = inside.any(dim=1)  # (t, W)
        # outline: floor and ceiling of each crossing inside [0, W)
        marks = torch.zeros((t, W + 1), dtype=torch.uint8, device=dev)
        for edge in (torch.floor(x_at), c):
            ok = crosses & (edge >= 0) & (edge < W)
            idx = torch.where(ok, edge, float(W)).long().reshape(t, -1)
            marks.scatter_(1, idx, 1)
        hit = filled | marks[:, :W].bool()
        mask[r0:r0 + t] = hit.to(torch.uint8) * 255
    return mask
