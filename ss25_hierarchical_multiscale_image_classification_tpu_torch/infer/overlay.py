"""Tumor-heatmap overlays on slide thumbnails.

Copy of the JAX package's ``infer/overlay.py``, held to it by an exact
test: the sliding-window probability grid through the rainbow colormap,
resized over the slide's display level and alpha-blended with Pillow
(``Image.blend(img, heatmap, 0.4)``, the reference's recipe). The colormap
is matplotlib's ``rainbow`` as a numpy table (:func:`rainbow_lut`, looked
up by :func:`colormap_lookup` as matplotlib's ``Colormap.__call__`` looks
it up), equal byte for byte to matplotlib's uint8 output, so an overlay
needs Pillow alone; where Pillow is missing ``render_overlay`` raises
``ImportError`` naming it.
"""

from __future__ import annotations

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    Slide,
    open_slide,
)


#: Entries of matplotlib's default colormaps (``rcParams["image.lut"]``).
LUT_SIZE = 256


def rainbow_lut(n: int = LUT_SIZE) -> np.ndarray:
    """matplotlib's ``rainbow`` table, (n, 3) float64: (|2x − 0.5|,
    sin πx, cos πx/2) on ``linspace(0, 1, n)``, clipped to [0, 1]."""
    x = np.linspace(0, 1, n) ** 1.0
    rgb = (np.abs(2 * x - 0.5), np.sin(x * np.pi), np.cos(x * np.pi / 2))
    return np.stack([np.clip(np.array(c, dtype=float), 0, 1) for c in rgb],
                    axis=-1)


def segment_lut(segments, n: int = LUT_SIZE) -> np.ndarray:
    """One channel of a segment-data colormap, (n,) float64: the rows
    ``(x, y_left, y_right)`` interpolated linearly at ``linspace(0, 1, n)``
    as matplotlib's ``_create_lookup_table`` interpolates them."""
    a = np.array(segments, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap_lookup(lut_u8: np.ndarray, values: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 colours of the float ``values`` in a (n, 3) uint8
    table, indexed as matplotlib's ``Colormap.__call__`` indexes floats: v
    takes entry ``int(v·n)`` (``n − 1`` at v = 1), below 0 the first entry,
    from 1 up the last, NaN matplotlib's "bad" colour (black, alpha 0)."""
    n = len(lut_u8)
    xa = np.array(values, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    np.clip(xa, -1, n, out=xa)
    with np.errstate(invalid="ignore"):
        xa = np.clip(xa.astype(int), 0, n - 1)
    out = lut_u8[xa]
    out[bad] = 0
    return out


_RAINBOW_U8 = (rainbow_lut() * 255).astype(np.uint8)


def _colormap_rainbow(values: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] → (H, W, 3) uint8 via the rainbow table."""
    return colormap_lookup(_RAINBOW_U8, np.clip(values, 0.0, 1.0))


def render_overlay(
    slide_or_path: Slide | str,
    prob_grid: np.ndarray,
    display_level: int | None = None,
    alpha: float = 0.4,
    save_path: str | None = None,
    predict_level: int | None = None,
    stride: int | None = None,
) -> np.ndarray:
    """Blend the probability grid over the slide at ``display_level``
    (default: the coarsest level, the reference's level-6 analogue).

    A plain resize places cell ``i`` of the grid at fraction
    ``(i + 0.5) / n`` — the center of window ``[i·stride, i·stride +
    stride)``. That is the true window center only when stride == patch
    size; for OVERLAPPING grids (``--stride < patch``) the window extends
    to ``i·stride + patch``, so pass ``predict_level`` + ``stride`` and
    the heat is shifted by the missing ``(patch - stride)/2`` so hotspots
    align with the windows' actual fields of view.

    Returns the (H, W, 3) uint8 overlay; optionally saves a PNG.
    """
    from PIL import Image

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.pyramid import (
        patch_size_for_level,
    )

    slide = (
        open_slide(slide_or_path) if isinstance(slide_or_path, str) else slide_or_path
    )
    own = isinstance(slide_or_path, str)
    try:
        if display_level is None:
            display_level = slide.level_count - 1
        w, h = slide.level_dimensions[display_level]
        thumb = slide.read_region((0, 0), display_level, (w, h))

        heat = Image.fromarray(_colormap_rainbow(prob_grid))
        heat = heat.resize((w, h), Image.BILINEAR)
        if predict_level is not None and stride is not None:
            ps = patch_size_for_level(predict_level)
            if stride != ps:
                pw, _ = slide.level_dimensions[predict_level]
                shift = (ps - stride) / 2.0 * (w / pw)
                heat = heat.transform(
                    (w, h), Image.AFFINE,
                    # inverse map: out(x, y) = in(x - shift, y - shift)
                    (1, 0, -shift, 0, 1, -shift),
                    resample=Image.BILINEAR,
                    fillcolor=tuple(
                        int(v) for v in _colormap_rainbow(
                            np.zeros((1, 1), np.float32)
                        )[0, 0]
                    ),
                )
        blended = Image.blend(
            Image.fromarray(thumb), heat, alpha
        )  # pre_patches.py:49 blend factor 0.4
        out = np.asarray(blended)
        if save_path:
            import os

            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
            blended.save(save_path)
        return out
    finally:
        if own:
            slide.close()
