"""WSI mask visualizer.

Copy of the JAX package's ``visualization/wsi_viz.py``, held to it by an
exact test: the annotation mask rendered at a level and saved as a PNG,
with a patch crop at (x, y), the mask crop there and a side-by-side figure.
Pillow and matplotlib are imported when it runs and raise ``ImportError``
where they are missing. Since the tool needs Pillow anyway, the mask is
drawn with Pillow's polygon fill, as the JAX package draws it, and not with
the port's numpy rasterizer, which differs from it along the edges.
"""

from __future__ import annotations

import os


import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.rasterize import (
    scale_polygons,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.annotations import (
    parse_annotation_xml,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("torch.visualization.wsi")


def _pil_mask(polygons_level0, level_dims, base_dims) -> np.ndarray:
    """(H, W) uint8 0/255 mask of the polygons filled with their outline by
    Pillow: the JAX package's ``grid/rasterize.py::polygons_to_mask``."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", tuple(level_dims), 0)
    draw = ImageDraw.Draw(mask)
    for poly in scale_polygons(polygons_level0, level_dims, base_dims):
        if len(poly) == 0:
            continue
        coords = [(int(x), int(y)) for x, y in poly]
        if len(coords) < 2:
            draw.point(coords, fill=255)  # a single vertex: one pixel
            continue
        draw.polygon(coords, outline=255, fill=255)
    return np.asarray(mask, dtype=np.uint8)


def visualize_and_save_wsi(
    slide_path: str,
    xml_path: str,
    out_dir: str,
    level: int = 3,
    patch_xy: tuple[int, int] | None = None,
    patch_size: int = 224,
) -> dict:
    """Render the annotation mask and optional patch/mask crops.

    Returns the dict of written artifact paths.
    """
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    artifacts: dict[str, str] = {}
    slide = open_slide(slide_path)
    try:
        level_dims = slide.level_dimensions[level]
        base_dims = slide.level_dimensions[0]
        polygons = parse_annotation_xml(xml_path) if os.path.exists(xml_path) else []
        mask = _pil_mask(polygons, level_dims, base_dims)

        mask_path = os.path.join(out_dir, f"mask_level{level}.png")
        Image.fromarray(mask).save(mask_path)
        artifacts["mask"] = mask_path

        if patch_xy is not None:
            x, y = patch_xy
            ds = slide.level_downsamples[level]
            patch = slide.read_region(
                (int(x * ds), int(y * ds)), level, (patch_size, patch_size)
            )
            patch_path = os.path.join(out_dir, f"patch_x{x}_y{y}.png")
            Image.fromarray(patch).save(patch_path)
            artifacts["patch"] = patch_path

            mask_crop = mask[y : y + patch_size, x : x + patch_size]
            crop_path = os.path.join(out_dir, f"mask_crop_x{x}_y{y}.png")
            Image.fromarray(mask_crop).save(crop_path)
            artifacts["mask_crop"] = crop_path

            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 2, figsize=(8, 4))
            axes[0].imshow(patch)
            axes[0].set_title(f"patch ({x},{y}) L{level}")
            axes[0].axis("off")
            axes[1].imshow(mask_crop, cmap="gray", vmin=0, vmax=255)
            axes[1].set_title("mask crop")
            axes[1].axis("off")
            fig_path = os.path.join(out_dir, f"side_by_side_x{x}_y{y}.png")
            fig.savefig(fig_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            artifacts["figure"] = fig_path

        log.info("WSI visualization artifacts: %s", sorted(artifacts))
        return artifacts
    finally:
        slide.close()
