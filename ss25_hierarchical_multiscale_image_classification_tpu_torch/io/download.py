"""The CLI's gate on downloaded slides, and ``--prepare``.

Copies of the JAX package's ``io/download.py::images_downloaded``,
``extract_zip`` and ``prepare_data`` (its ``patches_extracted`` lives in
``data/manifest.py``) and of ``data/extract.py::list_slides``, held to the
originals by exact tests. ``--prepare`` unzips the local
``train/mask/lesion_annotations.zip`` with the standard library's
``zipfile``. The download itself is not ported: the card's machine has no
network.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from typing import Sequence

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    SLIDE_EXTENSIONS,
    slide_name,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("io.download")


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


def extract_zip(zip_path: str, extract_to: str,
                expected: Sequence[str] | None = None) -> None:
    """Unzip ``zip_path`` into ``extract_to``. A directory that already
    holds every ``expected`` name (default ``tumor_001.xml`` …
    ``tumor_050.xml``) is left as it is; one that lacks any is removed and
    extracted anew."""
    expected = list(
        expected
        if expected is not None
        else [f"tumor_{i:03d}.xml" for i in range(1, 51)]
    )
    if os.path.exists(extract_to):
        existing = set(os.listdir(extract_to))
        if all(x in existing for x in expected):
            log.info(
                "Directory %s already contains all expected XMLs; skipping.",
                extract_to,
            )
            return
        log.warning("Directory %s is missing XMLs; re-extracting...", extract_to)
        shutil.rmtree(extract_to)
    os.makedirs(extract_to, exist_ok=True)
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(extract_to)
    log.info("Extracted %s to %s", zip_path, extract_to)


def prepare_data(data: DataConfig) -> None:
    """``--prepare``: extract ``<data_dir>/train/mask/lesion_annotations.zip``
    into ``annotations_dir`` and, where there is one, the test set's zip
    into ``test/mask/annotations``; a missing training zip is logged."""
    zip_path = os.path.join(
        data.data_dir, "train", "mask", "lesion_annotations.zip"
    )
    if not os.path.exists(zip_path):
        log.error(
            "Annotation zip not found at %s; run --download first.", zip_path
        )
        return
    extract_zip(zip_path, data.annotations_dir)
    test_zip = os.path.join(
        data.data_dir, "test", "mask", "lesion_annotations.zip"
    )
    if os.path.exists(test_zip):
        extract_zip(
            test_zip,
            os.path.join(data.data_dir, "test", "mask", "annotations"),
            expected=[],
        )
