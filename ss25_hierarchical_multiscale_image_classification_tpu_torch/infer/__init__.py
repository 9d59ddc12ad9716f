"""Inference: feature extraction, full-slide detection, overlays, the slide fleet.

The names of the JAX package's ``infer`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "extract_features": "features",
    "extract_features_with_simclr": "features",
    "predict_slide": "sliding_window",
    "write_detection_csv": "sliding_window",
    "render_overlay": "overlay",
    "predict_slide_fleet": "fleet",
})
