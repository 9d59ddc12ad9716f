"""MIL attention heatmap over a patch image or a slide grid.

Copy of the JAX package's ``visualization/attention_heatmap.py``, held to
it by exact tests: softmax-normalized attention through the jet colormap,
a 50/50 blend with Pillow and an optional two-panel figure, plus the
slide-grid variant that paints per-patch MIL attention back onto the slide
layout. The jet colormap is matplotlib's as a numpy table built from its
segment data (:data:`JET_SEGMENTS`), equal byte for byte to matplotlib's
uint8 output, so the blend needs Pillow alone; the two-panel figure
(``save_path``) needs matplotlib. No CLI flag reaches this module, as in
the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.overlay import (
    colormap_lookup,
    segment_lut,
)

#: matplotlib's ``jet``: (x, y_left, y_right) rows a channel.
JET_SEGMENTS = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}

_JET_U8 = (np.stack([segment_lut(JET_SEGMENTS[c])
                     for c in ("red", "green", "blue")], axis=-1)
           * 255).astype(np.uint8)


def _jet(values: np.ndarray) -> np.ndarray:
    """Values in [0, 1] → (..., 3) uint8 via the jet table."""
    return colormap_lookup(_JET_U8, np.clip(values, 0.0, 1.0))


def visualize_attention_heatmap(
    image: np.ndarray,
    attention: np.ndarray,
    save_path: str | None = None,
    blend: float = 0.5,
) -> np.ndarray:
    """Blend a (H', W') attention map over an (H, W, 3) uint8 image.

    Attention is softmax-normalized if it doesn't already sum to ~1, then
    min-max scaled for display. Returns the blended (H, W, 3) uint8
    overlay; optionally writes a two-panel PNG (original | overlay), which
    needs matplotlib.
    """
    from PIL import Image

    attn = np.asarray(attention, np.float64)
    total = attn.sum()
    if not np.isclose(total, 1.0) and total > 0:
        e = np.exp(attn - attn.max())
        attn = e / e.sum()
    rng = attn.max() - attn.min()
    disp = (attn - attn.min()) / rng if rng > 0 else np.zeros_like(attn)

    h, w = image.shape[:2]
    heat = Image.fromarray(_jet(disp)).resize((w, h), Image.BILINEAR)
    overlay = Image.blend(Image.fromarray(image), heat, blend)
    out = np.asarray(overlay)

    if save_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        axes[0].imshow(image)
        axes[0].set_title("Input")
        axes[0].axis("off")
        axes[1].imshow(out)
        axes[1].set_title("Attention overlay")
        axes[1].axis("off")
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return out


def attention_grid_from_bag(
    attention: np.ndarray,
    coords: np.ndarray,
    stride: int,
    grid_shape: tuple[int, int],
) -> np.ndarray:
    """Scatter per-instance MIL attention onto the slide's (ny, nx) grid."""
    out = np.zeros(grid_shape, np.float32)
    for a, (x, y) in zip(attention, coords):
        out[int(y) // stride, int(x) // stride] = float(a)
    return out
