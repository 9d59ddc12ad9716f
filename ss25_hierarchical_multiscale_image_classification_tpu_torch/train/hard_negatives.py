"""Hard-negative mining (``--mine_hard_negatives``).

Counterpart of the JAX package's ``train/hard_negatives.py``: run the
trained classifier over the annotation-free training slides with the
sliding-window producer (``infer/sliding_window.py::predict_slide``), take
the highest-probability cells (every detection on a normal slide is a false
positive), and append them to the level's packed store as normal patches
under the slide name ``{slide}__hardneg``, read white-padded at the edge.
A slide already mined is skipped. The level's manifest is read and saved by
``data/manifest.py``'s rule (parquet where pyarrow imports, else numpy).

The JAX function takes flax variables and a module; this one takes the
classifier as a torch module already on ``device``, as ``predict_slide``
does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    PAD_FILL_VALUE,
    Config,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.extract import (
    annotation_path_for,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
    PatchManifest,
    level_manifest_path,
    load_level_manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.patch_store import (
    PackedPatchWriter,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.grid.labeling import (
    LABEL_NORMAL,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.sliding_window import (
    predict_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.download import (
    list_slides,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io.slide import (
    open_slide,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("train.hard_negatives")


def mine_hard_negatives(
    cfg: Config,
    model: torch.nn.Module,
    level: int = 3,
    prob_threshold: float = 0.5,
    max_per_slide: int = 256,
    batch_size: int = 512,
    input_size: int = 224,
    *,
    device: str | torch.device,
) -> PatchManifest:
    """Harvest false-positive patches from **annotation-free** training
    slides: at most ``max_per_slide`` cells a slide whose probability is at
    least ``prob_threshold``, in descending order. They are appended to
    ``patches/level_{L}`` as the packed store ``{slide}__hardneg`` with
    normal labels, and the level manifest is updated. Returns the manifest
    of the mined records."""
    mpath = level_manifest_path(cfg.data.patches_dir, level)
    manifest = load_level_manifest(cfg.data.patches_dir, level)
    already = {s for s in manifest.slides() if s.endswith("__hardneg")}

    mined = PatchManifest()
    for name, path in list_slides(cfg.data.train_img_dir):
        if os.path.exists(annotation_path_for(cfg.data, name)):
            continue  # only annotation-free (normal) slides yield sure FPs
        store_name = f"{name}__hardneg"
        if store_name in already:
            log.info("hard negatives for %s already mined, skipping", name)
            continue

        slide = open_slide(path)
        try:
            if level >= slide.level_count:
                continue
            prob_grid, grid = predict_slide(
                slide, model, level=level, batch_size=batch_size,
                input_size=input_size, device=device,
            )
            ps = grid.patch_size
            flat = prob_grid.reshape(-1)
            order = np.argsort(flat)[::-1]
            order = order[flat[order] >= prob_threshold][:max_per_slide]
            if len(order) == 0:
                log.info("%s: no false positives above %.2f", name, prob_threshold)
                continue

            writer = PackedPatchWriter(
                cfg.data.patches_dir, level, store_name, ps
            )
            ny, nx = prob_grid.shape
            for idx in order:
                gy, gx = divmod(int(idx), nx)
                x, y = gx * grid.stride, gy * grid.stride
                w, h = grid.valid_patch_extent(x, y)
                region = slide.read_region(
                    grid.level0_origin(x, y), level, (w, h)
                )
                if w < ps or h < ps:
                    full = np.full((ps, ps, 3), PAD_FILL_VALUE, np.uint8)
                    full[:h, :w] = region
                    region = full
                mined.append(writer.write(region, x, y, LABEL_NORMAL))
            writer.close()
            log.info(
                "%s: mined %d hard negatives (max prob %.3f)",
                name, len(order), float(flat[order[0]]),
            )
        finally:
            slide.close()

    if len(mined):
        manifest.extend(mined.records)
        manifest.save(mpath)
        log.info("appended %d hard negatives to %s", len(mined), mpath)
    return mined
