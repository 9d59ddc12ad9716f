"""Data layer: manifests, patch stores, extraction, datasets, augmentation.

The names of the JAX package's ``data`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "PatchManifest": "manifest",
    "PatchRecord": "manifest",
    "PatchReader": "patch_store",
    "PackedPatchWriter": "patch_store",
    "PngPatchWriter": "patch_store",
    "extract_patches": "extract",
    "extract_patches_for_slide": "extract",
    "PatchDataset": "datasets",
    "slide_level_split": "datasets",
})
