"""Synthetic tissue slides, rendered with numpy alone.

Copy of the JAX package's ``io/synthetic.py`` renderer for slides without
tumor polygons (those need PIL to rasterize), held to the original by
exact-equality tests: a white canvas with an elliptical, noise-textured
pink tissue blob, and a 2× box-averaged pyramid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    ArraySlide,
)


@dataclasses.dataclass
class SyntheticSlideSpec:
    """Procedural slide description: the level-0 canvas is white, with an
    elliptical tissue blob whose mean RGB is well under the tissue
    threshold."""

    width: int = 1024
    height: int = 768
    num_levels: int = 4
    tissue_center: tuple[float, float] = (0.5, 0.5)  # fraction of (w, h)
    tissue_radii: tuple[float, float] = (0.38, 0.4)  # fraction of (w, h)
    seed: int = 0
    noise: float = 8.0


def make_level0(spec: SyntheticSlideSpec) -> np.ndarray:
    """Render the level-0 (H, W, 3) uint8 image."""
    rng = np.random.default_rng(spec.seed)
    h, w = spec.height, spec.width
    img = np.full((h, w, 3), 255, dtype=np.float32)

    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = spec.tissue_center[0] * w, spec.tissue_center[1] * h
    rx, ry = spec.tissue_radii[0] * w, spec.tissue_radii[1] * h
    tissue = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0

    # pink-ish H&E-looking base with per-pixel noise
    base = np.array([205.0, 160.0, 190.0])
    tex = rng.normal(0.0, spec.noise, size=(h, w, 3)).astype(np.float32)
    img[tissue] = base[None, :] + tex[tissue]

    np.clip(img, 0, 255, out=img)
    return img.astype(np.uint8)


def build_pyramid(level0: np.ndarray, num_levels: int) -> list[np.ndarray]:
    """2x-downsample pyramid by box averaging (each level halves both dims)."""
    levels = [level0]
    cur = level0.astype(np.float32)
    for _ in range(1, num_levels):
        h, w = cur.shape[:2]
        h2, w2 = h // 2, w // 2
        cur = cur[: h2 * 2, : w2 * 2]
        cur = cur.reshape(h2, 2, w2, 2, 3).mean(axis=(1, 3))
        levels.append(np.clip(cur, 0, 255).astype(np.uint8))
    return levels


def make_synthetic_slide(spec: SyntheticSlideSpec | None = None) -> ArraySlide:
    """Build an in-memory synthetic slide."""
    spec = spec or SyntheticSlideSpec()
    return ArraySlide(build_pyramid(make_level0(spec), spec.num_levels))
