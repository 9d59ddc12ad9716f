"""Directory restructure and data-integrity tools (``utils/structure.py``).

The names of the JAX package's ``utils`` resolve here at first use."""

from ss25_hierarchical_multiscale_image_classification_tpu_torch._exports import (
    lazy_exports,
)

__getattr__, __dir__ = lazy_exports(__name__, {
    "check_good_files": "structure",
    "count_tumor_patches": "structure",
    "group_patches_by_slide": "structure",
    "move_files_up": "structure",
})
