"""Visualization: attention heatmaps and the WSI mask QA renders.

The names of the JAX package's ``visualization`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "visualize_attention_heatmap": "attention_heatmap",
    "visualize_and_save_wsi": "wsi_viz",
})
