"""Pyramid grid arithmetic, polygon rasterization and patch labeling.

The JAX package's ``grid`` names resolve here at first use; its
``polygons_to_mask_jax`` is ``polygons_to_mask_device`` here."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "PatchGrid": "pyramid",
    "patch_size_for_level": "pyramid",
    "padded_extent": "pyramid",
    "polygons_to_mask": "rasterize",
    "polygons_to_mask_device": "rasterize",
    "is_tissue": "labeling",
    "is_tissue_host": "labeling",
    "patch_labels_from_mask": "labeling",
    "patch_labels_from_mask_host": "labeling",
})
