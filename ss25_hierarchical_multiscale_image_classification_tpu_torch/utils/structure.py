"""Directory restructure and data-integrity utilities.

Copy of the JAX package's ``utils/structure.py``, held to it by exact
tests: ``group_patches_by_slide``, ``move_files_up`` (``--move_files``),
``check_good_files`` (``--check_good_downloaded_files``: PNGs verified by
Pillow, packs against their ``.shape`` sidecars, the bad slides listed in a
redownload manifest), ``check_structure`` (``--check_structure``) and
``count_tumor_patches`` (``--count_tumor_patches``: the per-level census,
with a warning for tumor patches in a ``normal_*`` slide). Unlike the JAX
function, ``check_good_files`` imports Pillow before it verifies PNGs, so
that a machine without it raises instead of listing every PNG as corrupt.
"""

from __future__ import annotations

import glob
import os
import shutil
from collections import defaultdict

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("torch.utils.structure")


def group_patches_by_slide(level_dir: str) -> int:
    """Move ``level_X/{normal,tumor}/*.png`` → ``level_X/{slide_id}/``
    (``structure.py:5-28``); slide_id = first two filename tokens."""
    moved = 0
    for class_dir in ("normal", "tumor"):
        src_dir = os.path.join(level_dir, class_dir)
        if not os.path.isdir(src_dir):
            continue
        for path in glob.glob(os.path.join(src_dir, "*.png")):
            name = os.path.basename(path)
            slide_id = "_".join(name.split("_")[:2])
            dst_dir = os.path.join(level_dir, slide_id)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.move(path, os.path.join(dst_dir, name))
            moved += 1
        if not os.listdir(src_dir):
            os.rmdir(src_dir)
    log.info("Grouped %d patches by slide under %s", moved, level_dir)
    return moved


def move_files_up(level_dir: str, subdir: str = "tumor") -> int:
    """Flatten ``level/{slide}/{subdir}/*.png`` up one level
    (``src/main.py:173-202``)."""
    moved = 0
    for slide_dir in sorted(glob.glob(os.path.join(level_dir, "*"))):
        nested = os.path.join(slide_dir, subdir)
        if not os.path.isdir(nested):
            continue
        for path in glob.glob(os.path.join(nested, "*.png")):
            shutil.move(path, os.path.join(slide_dir, os.path.basename(path)))
            moved += 1
        if not os.listdir(nested):
            os.rmdir(nested)
    log.info("Moved %d nested patches up under %s", moved, level_dir)
    return moved


def check_good_files(
    patches_dir: str, manifest_out: str = "redownload.txt"
) -> list[str]:
    """Scan every stored patch for corruption; write the bad-slide manifest
    (``src/main.py:733-761``). PNG stores verify via PIL; packed stores
    verify pack size against the sidecar shape."""
    bad_slides: set[str] = set()
    pngs = glob.glob(os.path.join(patches_dir, "**", "*.png"), recursive=True)
    if pngs:
        from PIL import Image
    for path in pngs:
        try:
            with Image.open(path) as im:
                im.verify()
        except Exception:
            bad_slides.add(os.path.basename(os.path.dirname(path)))
    for pack in glob.glob(os.path.join(patches_dir, "**", "*.pack"), recursive=True):
        try:
            with open(pack + ".shape") as f:
                shape = tuple(int(v) for v in f.read().split())
            expected = 1
            for s in shape:
                expected *= s
            if os.path.getsize(pack) != expected:
                bad_slides.add(os.path.basename(pack)[: -len(".pack")])
        except Exception:
            bad_slides.add(os.path.basename(pack)[: -len(".pack")])
    bad = sorted(bad_slides)
    if bad:
        with open(manifest_out, "w") as f:
            f.write("\n".join(bad) + "\n")
        log.warning("%d corrupt slides listed in %s", len(bad), manifest_out)
    else:
        log.info("All patch stores verified OK")
    return bad


def check_structure(data) -> dict[str, bool]:
    """Report the expected data-directory layout (the README-documented
    ``--check_structure`` the reference never implemented)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.download import (
        list_slides,
    )

    report = {
        "train/img": os.path.isdir(data.train_img_dir),
        "test/img": os.path.isdir(data.test_img_dir),
        "annotations": os.path.isdir(data.annotations_dir),
        "patches": os.path.isdir(data.patches_dir),
        "features": os.path.isdir(data.features_dir),
    }
    for name, ok in report.items():
        (log.info if ok else log.warning)(
            "%s: %s", name, "present" if ok else "MISSING"
        )
    log.info(
        "train slides: %d, test slides: %d",
        len(list_slides(data.train_img_dir)),
        len(list_slides(data.test_img_dir)),
    )
    return report


def count_tumor_patches(patches_dir: str) -> dict[int, dict[str, int]]:
    """Per-level tumor/normal census, warning when a ``normal_*`` slide
    contains tumor patches (``src/main.py:763-803``)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        load_or_scan_manifest,
    )

    census: dict[int, dict[str, int]] = {}
    for level_dir in sorted(glob.glob(os.path.join(patches_dir, "level_*"))):
        try:
            level = int(os.path.basename(level_dir).split("_")[1])
        except (IndexError, ValueError):
            continue
        manifest = load_or_scan_manifest(patches_dir, level)
        counts = manifest.class_counts()
        census[level] = {
            "normal": counts.get(0, 0),
            "tumor": counts.get(1, 0),
            "total": len(manifest),
        }
        per_slide = defaultdict(int)
        for rec in manifest:
            if rec.label == 1:
                per_slide[rec.slide] += 1
        for slide, n in sorted(per_slide.items()):
            if slide.startswith("normal_") and n > 0:
                log.warning(
                    "Normal slide %s contains %d tumor-labeled patches "
                    "at level %d", slide, n, level,
                )
        log.info(
            "Level %d: %d patches (%d tumor / %d normal)",
            level, census[level]["total"], census[level]["tumor"],
            census[level]["normal"],
        )
    return census
