"""Tumor-heatmap overlays on slide thumbnails.

Copy of the JAX package's ``infer/overlay.py``, held to it by an exact
test: the sliding-window probability grid through matplotlib's rainbow
colormap, resized over the slide's display level and alpha-blended with
Pillow (``Image.blend(img, heatmap, 0.4)``, the reference's recipe). Pillow
and matplotlib are imported when an overlay is drawn; where either is
missing (matplotlib is, on the card's machine) ``render_overlay`` raises
``ImportError`` naming it.
"""

from __future__ import annotations

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    Slide,
    open_slide,
)


def _colormap_rainbow(values: np.ndarray) -> np.ndarray:
    """(H, W) in [0,1] → (H, W, 3) uint8 via matplotlib's rainbow map."""
    import matplotlib.cm as cm

    rgba = cm.rainbow(np.clip(values, 0.0, 1.0))
    return (rgba[..., :3] * 255).astype(np.uint8)


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
