"""The CLI's gate on downloaded slides.

Copies of the JAX package's ``io/download.py::images_downloaded`` (its
``patches_extracted`` lives in ``data/manifest.py``) and of
``data/extract.py::list_slides``, held to the originals by exact tests. The
download itself is not ported: the card's machine has no network.
"""

from __future__ import annotations

import os

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    SLIDE_EXTENSIONS,
    slide_name,
)


def list_slides(img_dir: str) -> list[tuple[str, str]]:
    """(name, path) for every slide container in a directory, sorted."""
    out = []
    if not os.path.isdir(img_dir):
        return out
    for f in sorted(os.listdir(img_dir)):
        if f.endswith(SLIDE_EXTENSIONS):
            out.append((slide_name(f), os.path.join(img_dir, f)))
    return out


def images_downloaded(data: DataConfig) -> bool:
    """Stage gate: a slide under ``<data_dir>/train/img``."""
    return len(list_slides(data.train_img_dir)) > 0
