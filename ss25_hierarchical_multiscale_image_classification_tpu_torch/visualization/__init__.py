"""Slide visualization: the WSI mask QA renders (``wsi_viz.py``)."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch.visualization.wsi_viz import (  # noqa: F401
    visualize_and_save_wsi,
)
