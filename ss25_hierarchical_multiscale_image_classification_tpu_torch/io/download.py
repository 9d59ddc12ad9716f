"""CAMELYON16 acquisition and preparation: ``--download`` (``--remote``),
``--balance_dataset``, ``--prepare`` and the CLI's stage gates.

Counterpart of the JAX package's ``io/download.py`` (and of its
``data/extract.py::list_slides``), held to it by tests against a loopback
HTTP server. A download streams in 1 MiB chunks through the standard
library's ``urllib.request`` (no ``requests`` or ``tqdm``, which the card's
machine may lack), logs its progress, and on any failure logs it, removes
the partial file and returns False, so that the run goes on: where there is
no network every file logs its failure. ``--prepare`` unzips the local
``train/mask/lesion_annotations.zip`` with ``zipfile``.
"""

from __future__ import annotations

import os
import shutil
import urllib.request
import zipfile
from typing import Sequence

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    CAMELYON16_BASE_URL,
    SUBSET_LIMITS,
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    patches_extracted,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    SLIDE_EXTENSIONS,
    slide_name,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("io.download")

#: remote paths of each category
CAMELYON16_FILES: dict[str, list[str]] = {
    "train_normal": [
        f"CAMELYON16/training/normal/normal_{i:03d}.tif" for i in range(1, 112)
    ],
    "train_tumor": [
        f"CAMELYON16/training/tumor/tumor_{i:03d}.tif" for i in range(1, 112)
    ],
    "test_images": [
        f"CAMELYON16/testing/images/test_{i:03d}.tif" for i in range(1, 51)
    ],
    "train_masks": ["CAMELYON16/training/lesion_annotations.zip"],
    "test_masks": ["CAMELYON16/testing/lesion_annotations.zip"],
}

CHUNK_BYTES = 1 << 20
TIMEOUT_S = 60
#: a progress line every this many bytes of one file
PROGRESS_BYTES = 256 << 20


def download_file(url: str, destination_path: str) -> bool:
    """Stream ``url`` into ``destination_path``; True on success. Any
    failure (an HTTP status, a dropped connection, a full disk) is logged,
    the partial file removed, and False returned."""
    name = os.path.basename(destination_path)
    try:
        log.info("Downloading: %s into %s", url, destination_path)
        os.makedirs(os.path.dirname(destination_path) or ".", exist_ok=True)
        # urlopen raises HTTPError on a status >= 400
        with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r, \
                open(destination_path, "wb") as f:
            total = r.headers.get("Content-Length")
            total = None if total is None else int(total)
            done, mark = 0, PROGRESS_BYTES
            while chunk := r.read(CHUNK_BYTES):
                done += f.write(chunk)
                if done >= mark:
                    log.info("Downloading %s: %.0f / %.0f MiB", name,
                             done / 2**20, (total or 0) / 2**20)
                    mark += PROGRESS_BYTES
            # a bounded read returns b"" where the connection drops early
            if total is not None and done != total:
                raise OSError(f"connection closed after {done} of {total} "
                              "bytes")
        log.info("Successfully downloaded %s.", name)
        return True
    except Exception as e:  # network and disk errors: keep the run alive
        log.error("Failed to download %s: %s", url, e)
        if os.path.exists(destination_path):
            os.remove(destination_path)  # never leave a truncated file
        return False


def download_dataset(data: DataConfig, remote: bool = False) -> None:
    """``--download``: the first slide of each image category (every one up
    to :data:`SUBSET_LIMITS` with ``remote``) and both annotation zips into
    the data root's layout; a file already there is skipped."""
    target_dirs = {
        "train_normal": data.train_img_dir,
        "train_tumor": data.train_img_dir,
        "test_images": data.test_img_dir,
        "train_masks": os.path.join(data.data_dir, "train", "mask"),
        "test_masks": os.path.join(data.data_dir, "test", "mask"),
    }
    for file_type, target_dir in target_dirs.items():
        files = CAMELYON16_FILES[file_type]
        if file_type in SUBSET_LIMITS:
            files = files[: SUBSET_LIMITS[file_type]]
        if not remote and file_type in ("train_normal", "train_tumor",
                                        "test_images"):
            files = files[:1]
        for remote_path in files:
            name = os.path.basename(remote_path)
            destination = os.path.join(target_dir, name)
            if os.path.exists(destination):
                log.info("Skipping: %s already exists.", name)
                continue
            download_file(CAMELYON16_BASE_URL + remote_path, destination)


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


def download_all_tumor_extract_patches(
    data: DataConfig, level: int = 3, start: int = 36, end: int = 111
) -> None:
    """``--balance_dataset``: download tumor slides ``start``..``end`` (a
    slide already there is kept) and extract each one's tumor patches at
    ``level`` (host route)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.extract import (
        extract_patches,
    )

    for i in range(start, end + 1):
        name = f"tumor_{i:03d}"
        remote_path = f"CAMELYON16/training/tumor/{name}.tif"
        destination = os.path.join(data.train_img_dir, f"{name}.tif")
        if not os.path.exists(destination):
            if not download_file(CAMELYON16_BASE_URL + remote_path,
                                 destination):
                continue
        extract_patches(data, level=level, only_tumor=True,
                        slide_filter=[name])


def features_extracted(data: DataConfig, level: int) -> bool:
    """Stage gate: the level's feature matrix under ``features_dir``."""
    return os.path.exists(
        os.path.join(data.features_dir, f"patch_features_{level}.npy")
    )
